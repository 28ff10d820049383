"""The port's Point Transformer V3 backbone (`models/point_transformer_v3.py`)
on the CPU at tiny widths (patches of 16, N = 256-512, B = 2-3): the
serialization codes (the parent property, the Hilbert curve's
adjacency, the bit orders), grid sampling against NumPy's `unique`,
PTv3's padding on hand-built counts, the xCPE against a dense
`conv3d`, pooling and unpooling against a NumPy cluster max, then the
whole backbone and the ANCSH model against the benchmark's plain
reference (`posebench/reference/point_transformer_v3.py`, which imports
nothing of the port) on seeded weights, and the serving path:
`PosePredictor` running the forward eagerly and capturing the fit,
while a PointNet++ predictor still captures forward and fit as one.

Tolerances.  The structure (counts, orders, padding) is integer work on
the same float32 xyz and is held bit for bit.  In float32 the port sums
a convolution as one GEMM over the gathered (n, k³·C) rows and the
attention in torch's fused kernel, where the reference sums offset by
offset and writes the softmax out: the same products summed in other
orders, ~1e-7 relative each, grown through a few blocks to at most a
few 1e-6 of the heads' scale (measured 8e-6 at most); rtol 1e-4 /
atol 5e-5 leaves room and is still ~40× under bf16's rounding (2^-8),
and the bf16 port fails it.  In bf16 the port and the reference's bf16
mode round at the same points, but a sum in another order can land a
bf16 value one unit the other side of a rounding boundary, and that
moves what follows; so the bf16 port is held by the benchmark's own
reading (`compare.heads_ratio`, its gap from float32 over the bf16
reference's, per head and cloud) to the cell's limit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from articulated_pose_tpu_torch.config import NetworkConfig, load_config
from articulated_pose_tpu_torch.models import point_transformer_v3 as v3
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch
from articulated_pose_tpu_torch.serving import (POSE_KEYS, PosePredictor,
                                                fit_heads, forward_fit)
from posebench import compare, harness
from posebench.drivers.serve_ptv3_offline import structure_gap
from posebench.reference import point_transformer_v3 as ref
from test_torch_compiled import HostReadGuard, stand_in  # noqa: F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=5e-5)
# four levels, one of five blocks (every order of its list and one
# again), patches of 16
SPEC = v3.PointTransformerV3Spec(
    enc_channels=(16, 16, 32, 32), enc_depths=(1, 5, 1, 1),
    enc_heads=(2, 2, 4, 4), dec_channels=(16, 16, 32), dec_depths=(1, 2, 1),
    dec_heads=(2, 2, 4), patch_size=16, stride=(2, 2, 2),
    grid_size=1.0 / 32.0)
WIDTHS = {f.name: (list(v) if isinstance(v := getattr(SPEC, f.name), tuple)
                   else v)
          for f in dataclasses.fields(SPEC) if f.name != "dropout_rate"}
TABLES = v3.hilbert_tables()
HEADS_LIMIT = 6.0    # the cell's heads_ratio limit (workloads/serve_ptv3_*)


def _clouds(B, N, seed, scale=None):
    """B clouds of N points in [-0.5, 0.5]³, each shrunk by `scale[b]`
    (clouds of different voxel counts)."""
    X = torch.rand(B, N, 3, generator=torch.Generator().manual_seed(seed))
    X = X - 0.5
    if scale is not None:
        X = X * torch.tensor(scale)[:, None, None]
    return X


def _grid(n, depth, seed):
    return torch.randint(0, 1 << depth, (n, 3),
                         generator=torch.Generator().manual_seed(seed))


def _full_cube(depth):
    r = torch.arange(1 << depth)
    return torch.cartesian_prod(r, r, r)


# ------------------------------------------------------------ the codes
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_a_code_shifted_by_three_is_its_parents(depth):
    g = _grid(500, depth, depth)
    b = torch.randint(0, 3, (500,), generator=torch.Generator().manual_seed(1))
    codes = v3.serial_codes(g, b, depth, TABLES)
    parents = v3.serial_codes(g >> 1, b, depth - 1, TABLES)
    assert torch.equal(codes >> 3, parents)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("row", [2, 3])
def test_consecutive_hilbert_codes_are_face_adjacent(depth, row):
    g = _full_cube(depth)
    codes = v3.serial_codes(g, torch.zeros(len(g), dtype=torch.long),
                            depth, TABLES)[row]
    assert torch.equal(torch.sort(codes).values, torch.arange(len(g)))
    steps = (g[torch.argsort(codes)].diff(dim=0)).abs()
    assert (steps.sum(dim=1) == 1).all()


@pytest.mark.parametrize("depth", [1, 4, 9])
def test_codes_equal_the_references_bit_by_bit_versions(depth):
    """Morton bit by bit, Hilbert as Pointcept's bit tensor: the port's
    magic-number spread and Skilling's integer transform agree."""
    g = _grid(800, depth, 7)
    b = torch.randint(0, 4, (800,), generator=torch.Generator().manual_seed(2))
    want = torch.stack([ref.encode(g, b, depth, o) for o in ref.ORDERS])
    assert torch.equal(v3.serial_codes(g, b, depth, TABLES), want)


def test_morton_puts_x_most_significant():
    g = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [2, 0, 0]])
    codes = v3.serial_codes(g, torch.zeros(4, dtype=torch.long), 2, TABLES)
    assert codes[0].tolist() == [4, 2, 1, 32]
    assert codes[1].tolist() == [2, 4, 1, 16]      # z-trans: (y, x, z)


# ------------------------------------------------------- grid sampling
def test_grid_sampling_and_its_inverse_against_numpy_unique():
    X = _clouds(3, 300, 5, scale=[1.0, 0.5, 0.2])
    bb = v3.PointTransformerV3Backbone(SPEC)
    plan = bb.plan(X, [(0, 1, 2, 3)] * SPEC.levels)
    lv = plan.levels[0]
    grid_np, counts = [], []
    for b in range(3):
        g = np.floor(X[b].numpy() / SPEC.grid_size).astype(np.int64)
        g -= g.min(axis=0)
        uniq, first, inv = np.unique(g, axis=0, return_index=True,
                                     return_inverse=True)
        counts.append(len(uniq))
        # the voxel of each point holds the point's grid cell and the
        # smallest index of its cell
        got = plan.voxel[b * 300:(b + 1) * 300].numpy()
        np.testing.assert_array_equal(lv.grid[got].numpy(), g)
        kept = plan.xyz[got].numpy()
        np.testing.assert_array_equal(kept, X[b].numpy()[first[inv]])
        grid_np.append(uniq)
    assert lv.counts == counts
    # stored cloud after cloud in ascending Morton code
    assert torch.equal(lv.order[0], torch.arange(lv.n))
    assert torch.equal(lv.batch, torch.repeat_interleave(
        torch.arange(3), torch.tensor(counts)))


# ------------------------------------------------------------- padding
def test_padding_on_hand_built_counts():
    counts, K = [1024, 1500, 700, 2049], 1024
    p = v3.patch_layout(counts, K, CPU)
    want_pad, unpad, cu = ref.padding(counts, K, CPU)
    pad = p.pad.numpy()
    np.testing.assert_array_equal(pad, want_pad.numpy())
    assert p.seqlens == [1024, 1024, 1024, 700, 1024, 1024, 1024]
    assert np.diff(cu).tolist() == p.seqlens and p.slots.shape[1] == K
    # 1500: the last patch's 548 slots past the cloud repeat its points
    # 476..1023, the tail of the patch before; 2049: copies of 1025..2047
    off = 1024
    np.testing.assert_array_equal(pad[off + 1500:off + 2048] - off,
                                  np.arange(476, 1024))
    np.testing.assert_array_equal(pad[-1023:] - (1024 + 1500 + 700),
                                  np.arange(1025, 2048))
    assert p.copies == 548 + 1023
    # the (S, L) layout holds the same slots; the 700-point cloud's row
    # is masked past its end; each point reads its first occurrence
    mask = p.mask.view(len(p.seqlens), K).numpy()
    slots = p.slots.numpy()
    assert mask.sum(1).tolist() == p.seqlens
    np.testing.assert_array_equal(slots[mask], pad)
    first = p.first.numpy()
    np.testing.assert_array_equal(slots.reshape(-1)[first],
                                  np.arange(sum(counts)))
    np.testing.assert_array_equal(first, np.flatnonzero(mask.reshape(-1))[
        unpad.numpy()])


def test_padding_without_a_short_sequence_needs_no_mask():
    p = v3.patch_layout([32, 20, 48], 16, CPU)
    assert p.mask is None and p.seqlens == [16] * 7
    np.testing.assert_array_equal(p.slots.reshape(-1), p.pad)
    np.testing.assert_array_equal(p.pad.numpy(), ref.padding(
        [32, 20, 48], 16, CPU)[0].numpy())


# ------------------------------------------------------------- the xCPE
@pytest.mark.parametrize("k", [3, 5])
def test_submanifold_conv_against_a_dense_conv3d(k):
    torch.manual_seed(0)
    B, C, D = 2, 4, 3
    grid = torch.unique(_grid(150, D, 1), dim=0)
    grid = torch.cat([grid, grid[:60]])
    batch = torch.cat([torch.zeros(len(grid) - 60, dtype=torch.long),
                       torch.ones(60, dtype=torch.long)])
    x = torch.randn(len(grid), C)
    conv = v3.SubMConv3d(C, 5, k, bias=True)
    nbr, pairs = v3.neighbour_map(grid, batch, D, k)
    got = conv.conv(x, nbr, torch.float32)
    dense = torch.zeros(B, C, *(1 << D,) * 3)
    dense[batch, :, grid[:, 0], grid[:, 1], grid[:, 2]] = x
    w = conv.weight.view(5, k, k, k, C).permute(0, 4, 1, 2, 3)
    out = F.conv3d(dense, w, conv.bias, padding=k // 2)
    want = out[batch, :, grid[:, 0], grid[:, 1], grid[:, 2]]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    occupied = torch.zeros(B, 1, *(1 << D,) * 3)
    occupied[batch, 0, grid[:, 0], grid[:, 1], grid[:, 2]] = 1
    found = F.conv3d(occupied, torch.ones(1, 1, k, k, k), padding=k // 2)
    assert int(pairs) == int(found[batch, 0, grid[:, 0], grid[:, 1],
                                   grid[:, 2]].sum())


# --------------------------------------------------- pooling, unpooling
def test_pooling_and_unpooling_against_a_numpy_cluster_max():
    X = _clouds(2, 400, 8, scale=[1.0, 0.6])
    bb = v3.PointTransformerV3Backbone(SPEC).eval()
    plan = bb.plan(X, [(2, 0, 3, 1), (1, 3, 0, 2), (0, 1, 2, 3),
                       (3, 2, 1, 0)])
    fine, coarse = plan.levels[0], plan.levels[1]
    key = (fine.batch.numpy() << 40) | (
        (fine.grid.numpy() >> 1) @ np.array([1 << 20, 1 << 10, 1]))
    uniq, inv = np.unique(key, return_inverse=True)
    # the same partition of the finer voxels
    assert coarse.n == len(uniq)
    cl = coarse.cluster.numpy()
    assert len(set(zip(cl.tolist(), inv.tolist()))) == len(uniq)
    np.testing.assert_array_equal(coarse.grid.numpy()[cl],
                                  fine.grid.numpy() >> 1)
    pool = bb.enc1.pool
    torch.nn.init.ones_(pool.bn.weight)
    x = torch.randn(fine.n, 16)
    with torch.no_grad():
        got = pool(x, 0.9, coarse.cluster, coarse.n)
        y = F.linear(x, pool.linear.weight, pool.linear.bias).numpy()
    want = np.full((coarse.n, y.shape[1]), -np.inf, np.float32)
    np.maximum.at(want, cl, y)
    bn = pool.bn
    want = (want - bn.running_mean.numpy()) / np.sqrt(
        bn.running_var.numpy() + bn.eps) + bn.bias.detach().numpy()
    torch.testing.assert_close(got, F.gelu(torch.from_numpy(want)),
                               rtol=1e-5, atol=1e-6)
    # unpooling: each finer voxel adds its cluster's projected feature
    dec = bb.dec0
    skip = torch.randn(fine.n, 16)
    h = torch.randn(coarse.n, dec.proj.linear.in_features)
    with torch.no_grad():
        got = dec.unpool(skip, h, coarse.cluster, 0.9)
        want = (dec.skip(skip, 0.9).numpy()
                + dec.proj(h, 0.9).numpy()[cl])
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------- against the reference
def _models(dtype, matmul, seed=3, shuffle=None):
    """The port's ANCSH on SPEC in `dtype` and the reference in `matmul`,
    one state dict drawn from the seed with every batch norm's running
    statistics drawn too, so none is an identity."""
    cfg = NetworkConfig(backbone="point_transformer_v3",
                        compute_dtype={torch.float32: "float32",
                                       torch.bfloat16: "bfloat16"}[dtype])
    port = build_model(cfg, spec=SPEC)
    r = ref.ANCSHPointTransformerV3(3, WIDTHS, matmul=matmul,
                                    shuffle=shuffle)
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


SHUFFLE = ((3, 1, 0, 2), (1, 0, 3, 2), (2, 3, 1, 0), (0, 2, 1, 3))


def test_backbone_and_model_equal_the_reference_in_f32():
    X = _clouds(3, 512, 11, scale=[1.0, 0.7, 0.35])
    port, r = _models(torch.float32, "f32", shuffle=SHUFFLE)
    with torch.no_grad():
        got = port(X, shuffle=SHUFFLE)
        want = r(X)
        feat = port.backbone(X, shuffle=SHUFFLE)
        want_feat = r.backbone(X)
    assert structure_gap(port.backbone.structure, r.backbone.levels) == 0
    assert feat.shape == (3, 512, 16)
    torch.testing.assert_close(feat, want_feat, **TOL)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **TOL)
    # every level of SPEC is attended in patches, and a level's five
    # blocks read all four orders of its list
    assert all(len(s) > 1 for s in port.backbone.sequences)
    bf16, _ = _models(torch.bfloat16, "f32", shuffle=SHUFFLE)
    with torch.no_grad():
        low = bf16(X, shuffle=SHUFFLE)
    assert not all(torch.allclose(low[k].float(), want[k], **TOL)
                   for k in want)


def test_the_shuffle_changes_the_orders_the_blocks_read():
    X = _clouds(2, 300, 12)
    port, r = _models(torch.float32, "f32")
    with torch.no_grad():
        plain = port(X)
        shuffled = port(X, shuffle=SHUFFLE)
    assert not torch.allclose(plain["W"], shuffled["W"], **TOL)
    r.backbone.shuffle = SHUFFLE
    with torch.no_grad():
        torch.testing.assert_close(shuffled["W"], r(X)["W"], **TOL)
    assert structure_gap(port.backbone.structure, r.backbone.levels) == 0


def test_bf16_port_within_the_cells_heads_limit():
    X = _clouds(3, 512, 13, scale=[1.0, 0.8, 0.5])
    port, f32 = _models(torch.bfloat16, "f32", shuffle=SHUFFLE)
    _, bf16 = _models(torch.bfloat16, "bf16", shuffle=SHUFFLE)
    with torch.no_grad():
        got = {k: v.float().numpy()
               for k, v in port(X, shuffle=SHUFFLE).items()}
        want = {k: v.numpy() for k, v in f32(X).items()}
        lower = {k: v.numpy() for k, v in bf16(X).items()}
        f8 = _models(torch.bfloat16, "fp8", shuffle=SHUFFLE)[1]
        ctl = {k: v.numpy() for k, v in f8(X).items()}
    ratio = compare.heads_ratio(got, want, lower)
    assert ratio <= HEADS_LIMIT
    assert compare.heads_ratio(ctl, want, lower) > HEADS_LIMIT
    assert structure_gap(port.backbone.structure, bf16.backbone.levels) == 0


def test_structure_gap_counts_what_differs():
    X = _clouds(2, 256, 14)
    port, r = _models(torch.float32, "f32", shuffle=SHUFFLE)
    with torch.no_grad():
        port(X, shuffle=SHUFFLE)
    levels, _, _ = ref.structure(X, WIDTHS, SHUFFLE)
    assert structure_gap(port.backbone.structure, levels) == 0
    wrong = X.clone()
    wrong[0] = X[1]
    assert structure_gap(port.backbone.structure,
                         ref.structure(wrong, WIDTHS, SHUFFLE)[0]) > 0
    other = ((0, 1, 2, 3),) * 4
    assert structure_gap(port.backbone.structure,
                         ref.structure(X, WIDTHS, other)[0]) > 0
    assert structure_gap(port.backbone.structure, levels[:2]) > 0


def test_counters_of_the_last_forward():
    X = _clouds(2, 400, 15, scale=[1.0, 0.5])
    port, r = _models(torch.float32, "f32")
    with torch.no_grad():
        port(X)
        r(X)
    bb = port.backbone
    L = SPEC.levels
    assert bb.host_syncs == 1 + L
    assert bb.level_points == [sum(lv.counts) for lv in r.backbone.levels]
    assert bb.sequences == [np.diff(lv.cu_seqlens).tolist()
                            for lv in r.backbone.levels]
    assert bb.pad_points == [len(lv.pad) - len(lv.unpad)
                             for lv in r.backbone.levels]
    assert bb.cpe_pairs == [int(sum(hit.sum() for _, hit in
                                    lv.neighbours(3)))
                            for lv in r.backbone.levels]
    assert bb.stem_pairs == int(sum(hit.sum() for _, hit in
                                    r.backbone.levels[0].neighbours(5)))


def test_train_mode_reaches_every_weight():
    X = _clouds(2, 256, 16)
    port, _ = _models(torch.float32, "f32")
    port.train()
    out = port(X, generator=torch.Generator().manual_seed(0))
    sum(v.float().square().mean() for v in out.values()).backward()
    dead = [n for n, p in port.backbone.named_parameters()
            if p.grad is None or (not n.endswith("bias")
                                  and p.grad.abs().max() == 0)]
    assert dead == []


# ------------------------------------------------------------- the model
def test_published_widths_and_the_config_key(tmp_path):
    bb = v3.PointTransformerV3Backbone()
    assert sum(p.numel() for p in bb.parameters()) == 46_154_272
    assert bb.stem.weight.shape == (32, 125 * 3)
    assert bb.enc0.blocks[0].cpe.weight.shape == (32, 27 * 32)
    path = tmp_path / "ptv3.yml"
    path.write_text("backbone: point_transformer_v3\nbackbone_preset: tiny\n"
                    "compute_dtype: bfloat16\n")
    cfg = load_config(str(path))
    model = build_model(cfg)
    assert isinstance(model.backbone, v3.PointTransformerV3Backbone)
    assert model.fc2_0.dense.in_features == model.backbone.out_features
    assert build_model(cfg.replace(backbone_preset="reference"),
                       ).backbone.out_features == 64
    with pytest.raises(ValueError, match="V3Backbone takes none of"):
        build_model(cfg.replace(f32_stages=("sa1",)))


@pytest.mark.parametrize("bad", [
    dict(enc_heads=(2, 3, 4)), dict(stride=(3, 2)),
    dict(dec_depths=(1,)), dict(stride=(1, 2))])
def test_the_spec_refuses_inconsistent_widths(bad):
    with pytest.raises(ValueError):
        v3.PointTransformerV3Spec(**dict(v3.PTV3_TINY_WIDTHS, **bad))


# ------------------------------------------------------------- serving
def _predictor(backbone="point_transformer_v3", dtype="bfloat16"):
    cfg = NetworkConfig(backbone=backbone, backbone_preset="tiny",
                        compute_dtype=dtype)
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    return PosePredictor(cfg, state_dict=sd, device="cpu")


def test_predictor_equals_the_eager_model_and_fit():
    pred = _predictor()
    assert not pred.captures_forward
    shuffle = pred.shuffles[0]
    g = torch.Generator().manual_seed(0)
    assert shuffle == pred.model.backbone.draw_shuffle(g)
    clouds = _clouds(2, 256, 17, scale=[1.0, 0.4]).numpy()
    res = pred(clouds)
    d = pred.draws(2)
    P = torch.from_numpy(clouds)
    with torch.no_grad():
        heads = pred.model(P, shuffle=shuffle)
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
    clouds = [_clouds(2, 256, s).numpy() for s in (18, 19, 20)]
    got = [pred(c) for c in clouds]
    program = pred._programs[0]
    # one forward a call, outside the program (its replays rerun the
    # captured body, which holds no forward)
    assert program.captures == 1 and len(forwards) == 3
    assert [e.replays for e in program.captured.values()] == [2]
    assert program.fn.func is fit_heads
    want = _predictor()(clouds[2])
    np.testing.assert_array_equal(got[2].R, want.R)


def test_a_pointnet_predictor_still_captures_forward_and_fit(
        stand_in):  # noqa: F811
    pred = _predictor("pointnet2", "float32")
    assert pred.captures_forward and pred.shuffles == [None]
    forwards = []
    pred.model.backbone.register_forward_hook(
        lambda *a: forwards.append(1))
    for s in (21, 22, 23):
        pred(_clouds(2, 128, s).numpy())
    program = pred._programs[0]
    assert program.fn.func is forward_fit
    # the eager first run, the capture and each replay (the stand-in's
    # replay runs the captured body again): the forward is in the graph
    assert program.captures == 1 and len(forwards) == 4
    assert [e.replays for e in program.captured.values()] == [2]


def test_fit_heads_captures_and_the_forward_reads_the_host():
    """The program's body makes no host read, where the forward must."""
    pred = _predictor()
    P = _clouds(2, 256, 24)
    d = pred.draws(2)
    with torch.no_grad():
        heads = pred.model(P, shuffle=pred.shuffles[0])
        with HostReadGuard():
            fit_heads({k: heads[k] for k in POSE_KEYS}, P, d.part, d.joint,
                      pred.pose_cfg)
    # the forward's plan reads the depth and each level's counts
    assert pred.model.backbone.host_syncs == 1 + len(
        pred.model.backbone.spec.enc_channels)
    assert pred.model.backbone.capturable is False
