"""The port's Point Transformer backbone (`models/point_transformer.py`)
against the benchmark's plain reference (`posebench/reference/
point_transformer.py`, which imports nothing of the port) on seeded
random weights at tiny widths, on the CPU: each module alone (the
attention layer, the block, both transitions, the head transition),
then the whole ANCSH forward in float32 and in the bf16 trunk's
rounding; the k-NN tie rule; the level-size check; `PosePredictor` on a
Point Transformer config; one train step's gradients; and the attention's
dispatch between the `vector_attention` kernel and the plain layer, with
the counters that say which each layer took.

Tolerances.  In float32 the port and the reference run the same
operations in the same order on the same device, so they agree to the
last bits; rtol 1e-5 / atol 1e-6 leaves room for a product's summation
order and is ~1000x under bf16's rounding (2^-8 relative), and each f32
test also shows the bf16 port outside it.  The bf16 test holds the port
to the reference's bf16 mode, which rounds at the port's points, to the
same tolerance, and shows the f32 port outside it.
"""

import numpy as np
import pytest
import torch

from articulated_pose_tpu_torch.config import NetworkConfig, load_config
from articulated_pose_tpu_torch.models import point_transformer as pt
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import knn as knn_entry
from articulated_pose_tpu_torch.ops.kernels import vector_attention as va
from articulated_pose_tpu_torch.pose.pipeline import PoseDraws
from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    loss_and_grads, to_device)
from posebench import harness
from posebench.reference import point_transformer as ref

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
# three levels, so two transitions up besides the head transition
SPEC = pt.PointTransformerSpec(planes=(16, 16, 32), blocks=(1, 2, 1),
                               nsample=(4, 8, 8))
WIDTHS = {"planes": list(SPEC.planes), "blocks": list(SPEC.blocks),
          "nsample": list(SPEC.nsample), "stride": SPEC.stride,
          "share": SPEC.share}
DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cloud(B, N, seed):
    return torch.rand(B, N, 3, generator=torch.Generator().manual_seed(seed))


def _close(a, b) -> bool:
    return torch.allclose(a.float(), b.float(), **TOL)


def _pair(make_port, make_ref, seed=3):
    """A port module in f32 and in bf16 and the reference's f32 module,
    holding one state dict drawn from the seed; batch norm's running
    statistics drawn too, so that they are no identity."""
    r = make_ref(ref.Rounding("f32"))
    sd = harness.weights_from_seed(r, seed, "he", CPU)
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.randn(sd[k].shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    r.load_state_dict(sd)
    ports = {}
    for name, dt in DT.items():
        ports[name] = make_port(dt).eval()
        ports[name].load_state_dict(sd)
    return ports, r.eval()


def _level(B=2, n=64, k=8, C=16, seed=0):
    p = _cloud(B, n, seed)
    x = torch.randn(B, n, C, generator=torch.Generator().manual_seed(seed))
    return p, x, core.knn_point(k, p, p)[1]


@torch.no_grad()
def _held(port_out, ref_out, bf16_out):
    assert _close(port_out, ref_out), (port_out - ref_out).abs().max()
    assert not _close(bf16_out, ref_out)


@torch.no_grad()
def test_attention_layer_matches_reference():
    ports, r = _pair(lambda dt: pt.PointTransformerLayer(16, 8, dt),
                     lambda rnd: ref.Layer(16, 8, rnd))
    p, x, nbr = _level()
    got = {k: m(p, x, nbr, 0.9, pt.Tally()) for k, m in ports.items()}
    _held(got["f32"], r(p, x, nbr, 0.9), got["bf16"])


@torch.no_grad()
def test_block_matches_reference():
    ports, r = _pair(lambda dt: pt.Block(16, 8, dt),
                     lambda rnd: ref.Block(16, 8, rnd))
    p, x, nbr = _level()
    got = {k: m(p, x, nbr, 0.9, pt.Tally(), "b") for k, m in ports.items()}
    _held(got["f32"], r(p, x, nbr, 0.9), got["bf16"])


@pytest.mark.parametrize("first", [True, False])
@torch.no_grad()
def test_transition_down_matches_reference(first):
    ports, r = _pair(lambda dt: pt.TransitionDown(16, 32, dt, first),
                     lambda rnd: ref.TransitionDown(16, 32, rnd, first))
    p, x, _ = _level()
    new_p = core.gather_point(p, core.farthest_point_sample(16, p))
    nbr = core.knn_point(8, p, new_p)[1]
    got = {k: m(p, x, new_p, nbr, 0.9, pt.Tally()) for k, m in ports.items()}
    _held(got["f32"], r(p, x, new_p, nbr, 0.9), got["bf16"])


@pytest.mark.parametrize("head", [True, False])
@torch.no_grad()
def test_transition_up_matches_reference(head):
    ports, r = _pair(lambda dt: pt.TransitionUp(32, 16, dt, head),
                     lambda rnd: ref.TransitionUp(32, 16, rnd, head))
    p, x, _ = _level(C=32 if head else 16)
    pc = core.gather_point(p, core.farthest_point_sample(16, p))
    xc = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(5))
    got = {k: m(p, x, 0.9, pc, xc) for k, m in ports.items()}
    _held(got["f32"], r(p, x, 0.9, pc, xc), got["bf16"])


def _models(matmul: str, seed: int = 3):
    """The port's ANCSH on SPEC in matmul's dtype and the reference in
    matmul's mode, one state dict from the seed."""
    cfg = NetworkConfig(backbone="point_transformer", n_max_parts=3,
                        compute_dtype="float32" if matmul == "f32"
                        else "bfloat16")
    port = build_model(cfg, spec=SPEC)
    r = ref.ANCSHPointTransformer(3, WIDTHS, matmul=matmul)
    sd = harness.weights_from_seed(r, seed, "he", CPU)
    port.load_state_dict(sd)
    r.load_state_dict(sd)
    return port, r.eval()


@torch.no_grad()
@pytest.mark.parametrize("matmul,other", [("f32", "bf16"), ("bf16", "f32")])
def test_ancsh_forward_matches_reference(matmul, other):
    """The whole forward, each head, against the reference in the same
    precision; the port in the other precision falls outside."""
    port, r = _models(matmul)
    wrong, _ = _models(other)
    P = _cloud(2, 256, 1)
    got, want, off = port(P), r(P), wrong(P)
    assert set(want) <= set(got)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], **TOL, msg=k)
    assert not all(_close(off[k], want[k]) for k in want)


def test_counters_count_the_last_forward():
    port, _ = _models("f32")
    with torch.no_grad():
        port(_cloud(2, 256, 1))
    bb = port.backbone
    # searches: 256 self; 64 <- 256 and 64 self; 16 <- 64 and 16 self
    assert bb.knn_pairs == 2 * (256 * 256 + 64 * 256 + 64 * 64 + 16 * 64
                                + 16 * 16)
    first = bb.grouped_bytes
    assert first > 0
    with torch.no_grad():
        port(_cloud(2, 256, 2))
    assert bb.grouped_bytes == first


# the attention layers of SPEC's forward: blocks (1, 2, 1) and one a
# decoder level
SPEC_LAYERS = sum(SPEC.blocks) + len(SPEC.planes)


def _transitions_grouped_bytes(spec, B, N, esize):
    """Bytes of the (n, k, ·) tensors the transitions down materialise in
    one forward: for each level past the first, the grouped xyz and its
    difference (f32), the grouped feature, the concatenation and the
    Linear's, batch norm's and ReLU's outputs (the compute dtype)."""
    sizes = spec.level_points(N)
    total = 0
    for i in range(1, len(spec.planes)):
        cin, cout = spec.planes[i - 1], spec.planes[i]
        total += B * sizes[i] * spec.nsample[i] * (
            2 * 4 * 3 + esize * (cin + 3 + cin + 3 * cout))
    return total


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_attention_path_takes_the_kernel_on_the_card_in_eval_without_grad(
        device, training, grad, dtype):
    """The dispatch rule: the kernel for a CUDA input in eval mode with
    grad off, in bf16 or f32; the plain composition for training mode, a
    call that wants a gradient, a CPU tensor or another dtype."""
    want = ("kernel" if device == "cuda" and not training and not grad
            and dtype != torch.float16 else "plain")
    assert pt.attention_path(torch.device(device), training, grad,
                             dtype) == want


def test_training_grad_and_cpu_calls_take_the_plain_path():
    """On the CPU every call takes the plain composition, and the
    backbone's counters say so for the forward that ran last: in eval
    mode with grad off and on, and in training mode."""
    port, _ = _models("bf16")
    bb = port.backbone
    P = _cloud(2, 256, 1)
    for training, grad in ((False, False), (False, True), (True, False)):
        port.train(training)
        with torch.set_grad_enabled(grad):
            port(P)
        assert (bb.attention_kernel_layers, bb.attention_plain_layers) == \
            (0, SPEC_LAYERS)
        assert bb.grouped_bytes > _transitions_grouped_bytes(SPEC, 2, 256, 2)


@pytest.mark.parametrize("matmul", ["f32", "bf16"])
def test_kernel_dispatch_counts_its_layers_and_no_grouped_bytes(
        monkeypatch, matmul):
    """With the dispatch sending every layer to the `vector_attention`
    entry (whose CPU version is the plain composition), the forward is
    unchanged, the counters read every layer as the kernel's and none as
    plain, and `grouped_bytes` counts the transitions' tensors alone;
    both counters follow the last forward."""
    port, _ = _models(matmul)
    bb = port.backbone
    P = _cloud(2, 256, 1)
    with torch.no_grad():
        want = port(P)
        plain_bytes = bb.grouped_bytes
    calls = []
    kernel_entry = va.vector_attention

    def entry(layer, *args):
        calls.append(layer)
        return kernel_entry(layer, *args)

    monkeypatch.setattr(pt, "attention_path", lambda *a: "kernel")
    monkeypatch.setattr(pt.va, "vector_attention", entry)
    with torch.no_grad():
        got = port(P)
    assert len(calls) == SPEC_LAYERS
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (bb.attention_kernel_layers, bb.attention_plain_layers) == \
        (SPEC_LAYERS, 0)
    esize = 4 if matmul == "f32" else 2
    assert bb.grouped_bytes == _transitions_grouped_bytes(SPEC, 2, 256, esize)
    assert bb.grouped_bytes < plain_bytes
    monkeypatch.undo()
    with torch.no_grad():
        port(P)
    assert (bb.attention_kernel_layers, bb.attention_plain_layers) == \
        (0, SPEC_LAYERS)
    assert bb.grouped_bytes == plain_bytes


def test_vector_attention_entry_is_the_plain_layer_on_the_cpu():
    """The entry's CPU version is the layer's plain composition; under a
    work counter it counts as one `vector_attention` call with the
    kernel's work from the shapes."""
    from articulated_pose_tpu_torch import roofline

    layer = pt.PointTransformerLayer(32, 8, torch.bfloat16).eval()
    p, x, nbr = _level(n=64, k=8, C=32)
    with torch.no_grad():
        q, key, v = (pt._linear(lin, x, torch.bfloat16)
                     for lin in (layer.q, layer.k, layer.v))
        want = layer.plain(p, q, key, v, nbr)
        assert torch.equal(va.vector_attention(layer, p, q, key, v, nbr),
                           want)
        c = roofline.count(lambda: va.vector_attention(layer, p, q, key, v,
                                                       nbr))
    assert c.kernels == {"vector_attention": 1}
    assert c.kernel_flops == roofline.vector_attention_work(
        2, 64, 8, 32, 2).flops == 2 * 2 * 64 * 8 * 4 * 32


def test_vector_attention_refuses_what_the_kernel_does_not_take():
    def inputs(C, share=8, k=8, n=32, dt=torch.bfloat16):
        layer = pt.PointTransformerLayer(C, share, dt).eval()
        p, x, nbr = _level(n=n, k=k, C=C)
        q, key, v = (pt._linear(lin, x, dt)
                     for lin in (layer.q, layer.k, layer.v))
        return layer, p, q, key, v, nbr

    with torch.no_grad():
        with pytest.raises(ValueError, match="outside"):
            va.vector_attention(*inputs(64, k=17))
        with pytest.raises(ValueError, match="not divisible"):
            va.vector_attention(*inputs(20))
        with pytest.raises(ValueError, match="above 512"):
            va.vector_attention(*inputs(1024))
        with pytest.raises(ValueError, match="takes C in"):
            va.vector_attention(*inputs(48))
        with pytest.raises(ValueError, match="takes C in"):
            va.vector_attention(*inputs(64, share=4))
        layer, p, q, key, v, nbr = inputs(64)
        with pytest.raises(ValueError, match="int32"):
            va.vector_attention(layer, p, q, key, v, nbr.long())
        with pytest.raises(ValueError, match="layer's dtype"):
            va.vector_attention(layer, p, q.float(), key, v, nbr)
        layer, p, q, key, v, nbr = inputs(64, n=8)
        with pytest.raises(ValueError, match="exceeds"):
            va.vector_attention(layer, p, q, key, v,
                                torch.cat([nbr, nbr[..., :4]], -1))


def test_knn_ties_go_to_the_lower_index():
    """A grid with every point twice: each query's distances tie in
    pairs.  The plain version, the CPU dispatch of the `knn` entry and
    the reference's sort give the lowest-index order of a lexsort."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
    xyz = torch.from_numpy(np.concatenate([g, g])[None].astype(np.float32))
    q = xyz[:, ::5]
    for k in (1, 3, 8, 16):
        d, i = core.knn_point(k, xyz, q)
        d2 = core.pairwise_sqdist(q, xyz)[0].numpy()
        want = np.stack([np.lexsort((np.arange(d2.shape[1]), row))[:k]
                         for row in d2])
        np.testing.assert_array_equal(i[0].numpy(), want)
        np.testing.assert_array_equal(d[0].numpy(),
                                      np.take_along_axis(d2, want, 1))
        assert torch.equal(knn_entry.knn(k, xyz, q)[1], i)
        assert torch.equal(ref.knn(k, xyz, q).to(torch.int32), i)


@pytest.mark.parametrize("nsample,entry", [(8, True), (16, True),
                                           (17, False)])
def test_pointnet_knn_grouping_takes_the_kernel_entry_up_to_16(
        monkeypatch, nsample, entry):
    """sample_and_group(knn=True) searches through the `knn` entry (the
    kernel on the card) where it can answer, else the plain version."""
    from articulated_pose_tpu_torch.models import pointnet2

    calls = []

    def spy(k, xyz, q):
        calls.append(k)
        return knn_entry.knn(k, xyz, q)

    monkeypatch.setattr(pointnet2, "knn_kernel", spy)
    xyz = _cloud(2, 64, 1)
    new_xyz, grouped = pointnet2.sample_and_group(
        16, 0.3, nsample, xyz, None, torch.float32, knn=True)
    assert calls == ([nsample] if entry else [])
    _, idx = core.knn_point(nsample, xyz, new_xyz)
    assert torch.equal(grouped,
                       core.group_point(xyz, idx) - new_xyz[:, :, None])


def test_knn_refuses_what_it_cannot_answer():
    xyz = _cloud(1, 8, 0)
    with pytest.raises(ValueError, match="outside"):
        knn_entry.knn(17, _cloud(1, 64, 0), xyz)
    with pytest.raises(ValueError, match="exceeds"):
        knn_entry.knn(9, xyz, xyz)
    # the cell's nine searches: lanes until 2^17 threads, >= 32
    # candidates a lane
    plans = [knn_entry.knn_plan(16, m, n) for m, n in (
        (8192, 8192), (2048, 8192), (2048, 2048), (512, 2048), (512, 512),
        (128, 512), (128, 128), (32, 128), (32, 32))]
    assert plans == [1, 4, 4, 16, 16, 16, 4, 4, 1]


@pytest.mark.parametrize("N", [28, 6])
def test_a_level_with_fewer_points_than_k_raises(N):
    """Tiny widths: k = 8 on two levels of N and N // 4 points."""
    model = build_model(NetworkConfig(backbone="point_transformer",
                                      backbone_preset="tiny"))
    with pytest.raises(ValueError, match="fewer points than their k"):
        model(_cloud(1, N, 0))


def test_point_transformer_takes_no_pointnet_knobs():
    with pytest.raises(ValueError, match="takes none of"):
        build_model(NetworkConfig(backbone="point_transformer",
                                  f32_stages=("sa1",)))
    with pytest.raises(ValueError, match="backbone must be"):
        NetworkConfig(backbone="pointnet3")


def test_load_config_reads_the_backbone_key(tmp_path):
    path = tmp_path / "ptv1.yml"
    path.write_text("backbone: point_transformer\nbackbone_preset: tiny\n"
                    "compute_dtype: bfloat16\n")
    cfg = load_config(str(path))
    assert cfg.backbone == "point_transformer"
    model = build_model(cfg)
    assert model.backbone.out_features == pt.PT_TINY_WIDTHS["planes"][0]
    assert model.fc2_0.dense.in_features == model.backbone.out_features


def test_predictor_equals_the_eager_forward_and_fit():
    cfg = NetworkConfig(backbone="point_transformer", backbone_preset="tiny",
                        compute_dtype="bfloat16")
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    pred = PosePredictor(cfg, state_dict=sd, device="cpu")
    clouds = _cloud(2, 128, 4).numpy()
    res = pred(clouds)
    d = pred.draws(2)
    with torch.no_grad():
        want = forward_fit(pred.model, torch.from_numpy(clouds), d.part,
                           d.joint, pred.pose_cfg)
    np.testing.assert_array_equal(res.R, want["fits"]["nonlinear_R"].numpy())
    np.testing.assert_array_equal(res.part_counts,
                                  want["fits"]["part_counts"].numpy())
    for k, v in want["pred"].items():
        np.testing.assert_array_equal(res.raw[k], v.numpy())
    assert isinstance(d, PoseDraws)


def test_one_train_step_reaches_every_parameter():
    """Finite loss, a finite gradient for every parameter, and a nonzero
    one for every weight and batch-norm scale of the backbone (biases
    are left out: one just before a training-mode batch norm has
    gradient 0 in exact arithmetic)."""
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

    cfg = NetworkConfig(backbone="point_transformer", backbone_preset="tiny",
                        num_points=128, batch_size=2)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    gen = SyntheticArticulated(n_parts=3, points_per_part=60, seed=0)
    data, _ = gen.batch(np.random.RandomState(0), 2, num_points=128,
                        nocs_type="AC")
    st = TrainState(model, cfg)
    total, _, grads = loss_and_grads(st, to_device(data, CPU),
                                     torch.Generator().manual_seed(0))
    assert torch.isfinite(total)
    named = dict(zip(st.names, grads))
    backbone = [n for n in named if n.startswith("backbone.")]
    assert backbone and all(torch.isfinite(named[n]).all() for n in named)
    dead = [n for n in backbone if not n.endswith(".bias")
            and named[n].abs().max() == 0]
    assert dead == []
