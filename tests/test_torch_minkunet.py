"""The port's MinkUNet34C backbone (`models/minkunet.py`) on the CPU at tiny
widths (strides of a few hundred voxels, B = 2-3): the maps against a
brute-force dictionary (the 3³ maps, the stem's 5³ map, the stride-2
child slots), the strided and transposed convolutions against a dense
`conv3d` / `conv_transpose3d`, the per-stride counts against Point
Transformer V3's levels, then the whole backbone and the ANCSH model
against the benchmark's plain reference (`posebench/reference/
minkunet.py`, which imports nothing of the port) on seeded weights, a
cloud served alone against the same cloud in a batch, and the serving
path: `PosePredictor` running the forward eagerly and capturing the
fit.

Tolerances.  The structure (counts, maps, slots) is integer work on the
same float32 xyz and is held exactly.  In float32 the port sums a
convolution as one GEMM over the gathered (n, taps·C) rows, where the
reference sums offset by offset (and a strided one slot by slot): the
same products summed in other orders, ~1e-7 relative each, grown
through the 23 blocks to at most a few 1e-6 of the heads' scale
(measured 1.5e-6 at most); rtol 1e-4 / atol 5e-5 leaves room and is
still ~40× under bf16's rounding (2^-8), and the bf16 port fails it.
In bf16 the port and the reference's bf16 mode round at the same
points, but a sum in another order can land a bf16 value one unit the
other side of a rounding boundary, and that moves what follows; so the
bf16 port is held by the benchmark's own reading (`compare.heads_ratio`)
to the cell's limit.  A cloud alone and in a batch runs the same
products at other row counts, which a GEMM may block differently
(measured 1.5e-6 at most in float32); a voxel read across clouds would
move the heads by ~1e-1, so rtol 1e-4 / atol 1e-5 tells them apart.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from articulated_pose_tpu_torch.config import NetworkConfig, load_config
from articulated_pose_tpu_torch.models import minkunet as mk
from articulated_pose_tpu_torch.models import point_transformer_v3 as v3
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.sparse import SubMConv3d
from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch
from articulated_pose_tpu_torch.serving import (POSE_KEYS, PosePredictor,
                                                fit_heads)
from posebench import compare, harness
from posebench.drivers.serve_minkunet_offline import structure_gap
from posebench.reference import minkunet as ref
from test_torch_compiled import HostReadGuard, stand_in  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=5e-5)
SPEC = mk.MinkUNetSpec(**mk.MINK_TINY_WIDTHS)
WIDTHS = {f.name: (list(v) if isinstance(v := getattr(SPEC, f.name), tuple)
                   else v)
          for f in dataclasses.fields(SPEC) if f.name != "dropout_rate"}
HEADS_LIMIT = 3.0  # the cell's heads_ratio limit (workloads/serve_minkunet_*)
CONFIG = (pathlib.Path(__file__).resolve().parents[1] / "posebench"
          / "configs" / "ancsh_minkunet34c_bf16_serve.json")


def _clouds(B, N, seed, scale=None):
    """B clouds of N points in [-0.5, 0.5]³, each shrunk by `scale[b]`
    (clouds of different voxel counts)."""
    X = torch.rand(B, N, 3, generator=torch.Generator().manual_seed(seed))
    X = X - 0.5
    if scale is not None:
        X = X * torch.tensor(scale)[:, None, None]
    return X


def _voxels(st):
    """{(cloud, x, y, z): index} of a stride's voxels."""
    rows = torch.cat([st.batch[:, None], st.grid], dim=1).tolist()
    return {tuple(r): i for i, r in enumerate(rows)}


def _offsets(k):
    r = k // 2
    return [(dx, dy, dz) for dx in range(-r, r + 1) for dy in range(-r, r + 1)
            for dz in range(-r, r + 1)]


# ------------------------------------------------------------- the plan
def test_maps_against_a_brute_force_dictionary():
    X = _clouds(3, 300, 1, scale=[1.0, 0.6, 0.3])
    bb = mk.MinkUNetBackbone(SPEC)
    plan = bb.plan(X)
    assert bb.host_syncs == 2
    for l, st in enumerate(plan.strides):
        vox = _voxels(st)
        assert len(vox) == st.n
        maps = [(3, st.nbr)] + ([(5, plan.stem_nbr)] if l == 0 else [])
        for k, nbr in maps:
            want = [[vox.get((b, x + dx, y + dy, z + dz), st.n)
                     for dx, dy, dz in _offsets(k)]
                    for b, x, y, z in vox]
            assert nbr.tolist() == want
        assert int(st.pairs) == int((st.nbr < st.n).sum())
        if l == 0:
            assert int(plan.stem_pairs) == int((plan.stem_nbr < st.n).sum())
            continue
        # each coarse voxel's eight child slots in the finer stride
        fine = _voxels(plan.strides[l - 1])
        want = [[fine.get((b, 2 * x + dx, 2 * y + dy, 2 * z + dz),
                          len(fine))
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
                for b, x, y, z in vox]
        assert st.children.tolist() == want
        flat = st.children.reshape(-1)
        assert torch.equal(flat[st.slot], torch.arange(len(fine)))


def test_grid_sampling_keeps_the_smallest_index_and_maps_every_point():
    X = _clouds(2, 300, 2, scale=[1.0, 0.4])
    plan = mk.MinkUNetBackbone(SPEC).plan(X)
    st = plan.strides[0]
    for b in range(2):
        g = np.floor(X[b].numpy() / SPEC.grid_size).astype(np.int64)
        g -= g.min(axis=0)
        uniq, first, inv = np.unique(g, axis=0, return_index=True,
                                     return_inverse=True)
        assert st.counts[b] == len(uniq)
        got = plan.voxel[b * 300:(b + 1) * 300].numpy()
        np.testing.assert_array_equal(st.grid[got].numpy(), g)
        np.testing.assert_array_equal(plan.xyz[got].numpy(),
                                      X[b].numpy()[first[inv]])
    assert torch.equal(st.batch, torch.repeat_interleave(
        torch.arange(2), torch.tensor(st.counts)))


def test_stride_counts_equal_point_transformer_v3s_levels():
    X = _clouds(3, 400, 3, scale=[1.0, 0.5, 0.2])
    spec = v3.PointTransformerV3Spec(
        enc_channels=(8,) * 5, enc_depths=(1,) * 5, enc_heads=(1,) * 5,
        dec_channels=(8,) * 4, dec_depths=(1,) * 4, dec_heads=(1,) * 4,
        patch_size=16, stride=(2,) * 4, grid_size=SPEC.grid_size)
    levels = v3.PointTransformerV3Backbone(spec).plan(
        X, [(0, 1, 2, 3)] * 5).levels
    strides = mk.MinkUNetBackbone(SPEC).plan(X).strides
    assert [st.counts for st in strides] == [lv.counts for lv in levels]
    for st, lv in zip(strides, levels):
        assert torch.equal(st.grid, lv.grid) and torch.equal(st.batch,
                                                             lv.batch)


def test_a_grid_shallower_than_the_strides_is_one_voxel_a_cloud():
    X = _clouds(2, 50, 4, scale=[0.1, 0.05])      # depth 1 at 1/16
    bb = mk.MinkUNetBackbone(SPEC)
    plan = bb.plan(X)
    assert [st.counts for st in plan.strides[-3:]] == [[1, 1]] * 3
    assert all(int(st.grid.abs().sum()) == 0 for st in plan.strides[-3:])
    with torch.no_grad():
        assert torch.isfinite(bb(X)).all()


# ------------------------------------------------ strided and transposed
def _occupied(D, seed):
    """Voxels of two clouds on a 2^D grid, as clouds of cell centres at
    grid size 1 (each cloud touching 0 on every axis, so its minimum is
    the origin)."""
    g = torch.Generator().manual_seed(seed)
    cells = [torch.unique(torch.randint(0, 1 << D, (n, 3), generator=g),
                          dim=0) for n in (120, 50)]
    for c in cells:
        c[0] = 0
    N = max(len(c) for c in cells)
    X = torch.stack([torch.cat([c, c[:1].expand(N - len(c), 3)]).float()
                     + 0.5 for c in cells])
    spec = dataclasses.replace(SPEC, grid_size=1.0)
    return mk.MinkUNetBackbone(spec).plan(X)


def _dense(st, x, side):
    out = torch.zeros(2, x.shape[1], side, side, side)
    out[st.batch, :, st.grid[:, 0], st.grid[:, 1], st.grid[:, 2]] = x
    return out


def _at(dense, st):
    return dense[st.batch, :, st.grid[:, 0], st.grid[:, 1], st.grid[:, 2]]


def test_strided_conv_against_a_dense_conv3d():
    torch.manual_seed(0)
    D, Cin, Cout = 3, 4, 5
    plan = _occupied(D, 5)
    fine, coarse = plan.strides[0], plan.strides[1]
    conv = SubMConv3d(Cin, Cout, 2, bias=False)
    x = torch.randn(fine.n, Cin)
    got = conv.conv(x, coarse.children, torch.float32)
    w = conv.weight.view(Cout, 8, Cin).permute(0, 2, 1).reshape(
        Cout, Cin, 2, 2, 2)
    want = _at(F.conv3d(_dense(fine, x, 1 << D), w, stride=2), coarse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_transposed_conv_against_a_dense_conv_transpose3d():
    torch.manual_seed(1)
    D, Cin, Cout = 3, 6, 4
    plan = _occupied(D, 6)
    fine, coarse = plan.strides[0], plan.strides[1]
    conv = mk.TransposedConv3d(Cin, Cout)
    assert conv.weight.shape == (8 * Cout, Cin)
    x = torch.randn(coarse.n, Cin)
    got = conv.conv(x, coarse.slot, torch.float32)
    w = conv.weight.view(8, Cout, Cin).permute(2, 1, 0).reshape(
        Cin, Cout, 2, 2, 2)
    dense = F.conv_transpose3d(_dense(coarse, x, 1 << (D - 1)), w, stride=2)
    torch.testing.assert_close(got, _at(dense, fine), rtol=1e-5, atol=1e-5)


# --------------------------------------------------- against the reference
def _models(dtype, matmul, seed=3):
    """The port's ANCSH on SPEC in `dtype` and the reference in `matmul`,
    one state dict drawn from the seed with every batch norm's running
    statistics drawn too, so none is an identity."""
    cfg = NetworkConfig(backbone="minkunet",
                        compute_dtype={torch.float32: "float32",
                                       torch.bfloat16: "bfloat16"}[dtype])
    port = build_model(cfg, spec=SPEC)
    r = ref.ANCSHMinkUNet(3, WIDTHS, matmul=matmul)
    sd = harness.weights_from_seed(r, seed, "he", CPU)
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.randn(sd[k].shape, generator=g) * 0.3
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    port.load_state_dict(sd)
    r.load_state_dict(sd)
    return port.eval(), r.eval()


def test_backbone_and_model_equal_the_reference_in_f32():
    X = _clouds(3, 512, 11, scale=[1.0, 0.7, 0.35])
    port, r = _models(torch.float32, "f32")
    with torch.no_grad():
        got = port(X)
        want = r(X)
        feat = port.backbone(X)
        want_feat = r.backbone(X)
    assert structure_gap(port.backbone.structure, r.backbone.strides) == 0
    assert feat.shape == (3, 512, 8)
    torch.testing.assert_close(feat, want_feat, **TOL)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **TOL)
    bf16, _ = _models(torch.bfloat16, "f32")
    with torch.no_grad():
        low = bf16(X)
    assert not all(torch.allclose(low[k].float(), want[k], **TOL)
                   for k in want)


def test_bf16_port_within_the_cells_heads_limit():
    X = _clouds(3, 512, 13, scale=[1.0, 0.8, 0.5])
    port, f32 = _models(torch.bfloat16, "f32")
    _, bf16 = _models(torch.bfloat16, "bf16")
    with torch.no_grad():
        got = {k: v.float().numpy() for k, v in port(X).items()}
        want = {k: v.numpy() for k, v in f32(X).items()}
        lower = {k: v.numpy() for k, v in bf16(X).items()}
        ctl = {k: v.numpy()
               for k, v in _models(torch.bfloat16, "fp8")[1](X).items()}
    assert compare.heads_ratio(got, want, lower) <= HEADS_LIMIT
    assert compare.heads_ratio(ctl, want, lower) > HEADS_LIMIT
    assert structure_gap(port.backbone.structure, bf16.backbone.strides) == 0


def test_a_cloud_alone_equals_the_cloud_in_a_batch():
    """No stride, map or norm mixes the clouds of a batch."""
    X = _clouds(3, 400, 14, scale=[0.3, 1.0, 0.6])
    port, _ = _models(torch.float32, "f32")
    with torch.no_grad():
        batch = port(X)
        for b in range(3):
            alone = port(X[b:b + 1])
            for k, v in alone.items():
                torch.testing.assert_close(v[0], batch[k][b], rtol=1e-4,
                                           atol=1e-5)


def test_structure_gap_counts_what_differs():
    X = _clouds(2, 256, 15)
    port, r = _models(torch.float32, "f32")
    with torch.no_grad():
        port(X)
    strides, _, _ = ref.structure(X, WIDTHS)
    assert structure_gap(port.backbone.structure, strides) == 0
    wrong = X.clone()
    wrong[0] = X[1]
    assert structure_gap(port.backbone.structure,
                         ref.structure(wrong, WIDTHS)[0]) > 0
    assert structure_gap(port.backbone.structure, strides[:3]) > 0


def test_counters_of_the_last_forward():
    X = _clouds(2, 400, 16, scale=[1.0, 0.5])
    port, r = _models(torch.float32, "f32")
    with torch.no_grad():
        port(X)
        r(X)
    bb = port.backbone
    assert bb.host_syncs == 2
    assert bb.level_points == [len(st.rows) for st in r.backbone.strides]
    assert bb.conv_pairs == [st.pairs(3) for st in r.backbone.strides]
    assert bb.stem_pairs == r.backbone.strides[0].pairs(5)


def test_the_feature_pass_makes_no_host_read():
    X = _clouds(2, 300, 17)
    port, _ = _models(torch.float32, "f32")
    bb = port.backbone
    plan = bb.plan(X)
    bb.plan = lambda X: plan
    with torch.no_grad(), HostReadGuard():
        bb(X)


def test_train_mode_reaches_every_weight():
    X = _clouds(2, 256, 18)
    port, _ = _models(torch.float32, "f32")
    port.train()
    out = port(X, generator=torch.Generator().manual_seed(0))
    sum(v.float().square().mean() for v in out.values()).backward()
    dead = [n for n, p in port.backbone.named_parameters()
            if p.grad is None or p.grad.abs().max() == 0]
    assert dead == []


# ------------------------------------------------------------- the model
def test_published_widths_and_the_config_key(tmp_path):
    bb = mk.MinkUNetBackbone()
    params = dict(bb.named_parameters())
    assert sum(p.numel() for p in params.values()) == 37_854_112
    convs = {n: p for n, p in params.items() if p.dim() == 2}
    assert len(convs) == 62
    assert sum(p.numel() for p in convs.values()) == 37_836_512
    assert sum(1 for m in bb.modules()
               if isinstance(m, SubMConv3d) and m.k == 3) == 46
    assert bb.stem.weight.shape == (32, 125 * 3)
    assert bb.e1.conv.weight.shape == (32, 8 * 32)
    assert bb.d1.conv.weight.shape == (8 * 256, 256)
    assert bb.d1.blocks[0].c1.weight.shape == (256, 27 * 384)
    assert bb.d4.blocks[0].proj.weight.shape == (96, 128)
    assert bb.e1.blocks[0].proj is None
    assert {m.eps for m in bb.modules() if hasattr(m, "running_var")} == {
        1e-5}
    # the benchmark's configuration holds these widths, nothing cut
    config = json.loads(CONFIG.read_text())
    assert config["reduced"] == []
    widths = config["minkunet"]
    assert mk.MinkUNetSpec(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in widths.items()}) == mk.MinkUNetSpec()
    path = tmp_path / "mink.yml"
    path.write_text("backbone: minkunet\nbackbone_preset: tiny\n"
                    "compute_dtype: bfloat16\n")
    cfg = load_config(str(path))
    model = build_model(cfg)
    assert isinstance(model.backbone, mk.MinkUNetBackbone)
    assert model.fc2_0.dense.in_features == model.backbone.out_features
    assert build_model(cfg.replace(backbone_preset="reference"),
                       ).backbone.out_features == 96
    with pytest.raises(ValueError, match="MinkUNetBackbone takes none of"):
        build_model(cfg.replace(f32_stages=("sa1",)))


@pytest.mark.parametrize("bad", [
    dict(planes=(8, 16, 16)), dict(layers=(1, 2, 1, 1, 1, 1, 1)),
    dict(layers=(1, 0, 1, 1, 1, 1, 1, 1)), dict(planes=())])
def test_the_spec_refuses_inconsistent_widths(bad):
    with pytest.raises(ValueError):
        mk.MinkUNetSpec(**dict(mk.MINK_TINY_WIDTHS, **bad))


def test_the_reference_imports_nothing_of_the_port_nor_jax():
    import ast

    tree = ast.parse(pathlib.Path(ref.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "flax")
                          or m.startswith("articulated_pose_tpu")]


# ------------------------------------------------------------- serving
def _predictor(dtype="bfloat16"):
    cfg = NetworkConfig(backbone="minkunet", backbone_preset="tiny",
                        compute_dtype=dtype)
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    return PosePredictor(cfg, state_dict=sd, device="cpu")


def test_predictor_equals_the_eager_model_and_fit():
    pred = _predictor()
    assert not pred.captures_forward and pred.shuffles == [None]
    clouds = _clouds(2, 256, 19, scale=[1.0, 0.4]).numpy()
    res = pred(clouds)
    d = pred.draws(2)
    P = torch.from_numpy(clouds)
    with torch.no_grad():
        heads = pred.model(P)
        fits = fit_frame_batch({k: heads[k] for k in POSE_KEYS}, P, d,
                               pred.pose_cfg)
    np.testing.assert_array_equal(res.R, fits["nonlinear_R"].numpy())
    np.testing.assert_array_equal(res.t, fits["nonlinear_t"].numpy())
    np.testing.assert_array_equal(res.part_counts,
                                  fits["part_counts"].numpy())
    np.testing.assert_array_equal(res.segmentation,
                                  heads["W"].argmax(-1).numpy())
    for k, v in heads.items():
        np.testing.assert_array_equal(res.raw[k], v.float().numpy())


def test_predictor_captures_the_fit_and_runs_the_forward_each_call(
        stand_in):  # noqa: F811
    pred = _predictor()
    forwards = []
    pred.model.backbone.register_forward_hook(
        lambda *a: forwards.append(1))
    clouds = [_clouds(2, 256, s).numpy() for s in (20, 21, 22)]
    got = [pred(c) for c in clouds]
    program = pred._programs[0]
    assert program.captures == 1 and len(forwards) == 3
    assert [e.replays for e in program.captured.values()] == [2]
    assert program.fn.func is fit_heads
    want = _predictor()(clouds[2])
    np.testing.assert_array_equal(got[2].R, want.R)


def test_fit_heads_captures_and_the_forward_reads_the_host_twice():
    pred = _predictor()
    P = _clouds(2, 256, 23)
    d = pred.draws(2)
    with torch.no_grad():
        heads = pred.model(P)
        with HostReadGuard():
            fit_heads({k: heads[k] for k in POSE_KEYS}, P, d.part, d.joint,
                      pred.pose_cfg)
    assert pred.model.backbone.host_syncs == 2
    assert pred.model.backbone.capturable is False
