#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the exit code
is non-zero):

0. Require a CUDA device; print the card (nvidia-smi name and power
   limit) and the torch / CUDA / nvcc versions.
1. Build the CUDA sources from csrc/, one nvcc each, all at once.
2. Hold each of the seven kernels against its plain PyTorch version at
   the shapes its paths give it: the serving path's (B=16, N=2048), the
   large-cloud path's (B=4, N=32768) and the N-level path's (B=8,
   N=8192 -> 1024 -> 256 -> 64 -> 16): exact indices and counts;
   coordinates within 1e-6 absolute (equal for the packed and bucket
   tiers, whose queries include some moved out of the cloud); 3-NN
   distances within 1e-6 relative.  Device time of each, median of 20
   CUDA-event-timed calls (`cuda_time_ms`).
3. Pose oracle: 8 frames of a 3-part object with two revolute joints and
   perfect predictions; the pose fit on the card must recover every
   part's similarity (rotation < 3 deg, scale within 5 %, translation
   within 0.05).
4. Serve: PosePredictor at the reference width for eyeglasses (K=3),
   N=2048, seeded random weights, niter 128/64, through serve_clouds:
   (a) f32, three requests of 16 clouds (1 FPS, 2 exact ball query,
   2 3-NN launches per batch), the forward on the card against the same
   model on the CPU, and one forward with the bf16 trunk; (b) the
   packed bf16 configuration that bench.py times (ball_query_packed),
   three requests of 64 clouds (1 FPS, 2 packed ball query, 2 3-NN).
5. Large-cloud forward (scripts/run_large_cloud.py's tier): ANCSHModel
   with the bf16 trunk and ball_query_impl="stream", B=4, N=32768
   (1 FPS in its large-cloud variant, 2 index-only ball query, 2 3-NN
   per forward); the f32 forward on the card against the CPU at B=1.
6. Bucket path: bench.py's composition (forward + fit_frame_batch, niter
   128/64) at the reference widths with ball_query_impl="bucket", bf16
   trunk, three batches of 64 clouds (1 two-level FPS, 2 bucket ball
   query, 2 3-NN per batch); the f32 forward on the card against the CPU
   at B=2; the distance to the exact bf16 forward (printed, no bound:
   another neighbour subset); one "bucket_xla" forward.
7. N-level path: the four-level pyramid of PointNet++'s semantic
   segmentation network under the ANCSH heads, B=8, N=8192, bf16 and
   f32 (4 single-level FPS, 4 exact ball query, 4 3-NN per forward);
   the f32 forward on the card against the CPU at B=1.

Each path of phases 4-7 runs with the launch counts set to 0 just
before it and read just after, and fails unless each of its kernels
launched.  The last lines are the card's name and power limit as
nvidia-smi prints them, a JSON object describing each kernel, then
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
B_KERNEL = 16
MAX_SPIN_CYCLES = 1 << 28           # ~0.15-0.25 s of spin at H100 clocks
N_POINTS = 2048
SERVE_BATCH = 16
SERVE_REQUESTS = 3
PACKED_BATCH = 64                   # bench.py's serving batch
ORACLE_FRAMES = 8
LARGE_B = 4                         # scripts/run_large_cloud.py's shape
LARGE_N = 32768
LARGE_FORWARDS = 3
BUCKET_BATCH = 64                   # bench.py's batch
BUCKET_BATCHES = 3
# charlesq34/pointnet2 models/pointnet2_sem_seg.py: four SA levels on
# ScanNet clouds of 8192 points, its four FP stages, and the global SA
# stage the backbone always adds (with its FP stage first)
NLEVEL_SPEC = dict(
    sa_npoints=(1024, 256, 64, 16), sa_radii=(0.1, 0.2, 0.4, 0.8),
    sa_nsamples=(32, 32, 32, 32),
    sa_mlps=((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512)),
    global_mlp=(256, 512, 1024),
    fp_mlps=((256, 256), (256, 256), (256, 256), (256, 128), (128, 128, 128)))
NLEVEL_B = 8
NLEVEL_N = 8192
NLEVEL_FORWARDS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20):
    """Time of one call of fn: (median ms over `reps` calls, each timed
    with CUDA events; True when that is device time only).

    Each call is queued behind a spin kernel, so the card opens the
    interval only after the host has enqueued all of fn: the host's
    launch cost (ctypes, allocation, Python) stays out of the reading.
    The spin doubles until the start event is still pending once fn is
    enqueued, i.e. until the host really stayed ahead.  A function of
    thousands of launches fills the card's launch queue, so the host
    waits on the card and cannot stay ahead whatever the spin: its
    calls are then timed without the spin, and the reading includes
    the host's launch time (second value False).
    """
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    cycles = 1 << 20
    device_only = True
    for _ in range(reps):
        while True:
            if device_only:
                torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            host_ahead = not start.query()
            end.synchronize()
            if host_ahead or not device_only:
                break
            if cycles < MAX_SPIN_CYCLES:
                cycles *= 2
            else:
                device_only = False
                times.clear()       # one kind of reading in the median
        times.append(start.elapsed_time(end))
    return statistics.median(times), device_only


def timing_note(device_only: bool) -> str:
    return "" if device_only else " (host-bound: includes launch time)"


# ---------------------------------------------------------------- phase 2
def time_both(kernel_fn, plain_fn):
    """Times of a kernel and of its plain version on the same inputs:
    (ms, plain_ms, ms device only?, plain_ms device only?, note)."""
    ms, k_dev = cuda_time_ms(kernel_fn)
    plain_ms, p_dev = cuda_time_ms(plain_fn)
    note = (f"kernel {ms:.4f} ms{timing_note(k_dev)}, plain {plain_ms:.4f} "
            f"ms{timing_note(p_dev)}")
    return ms, plain_ms, k_dev, p_dev, note


def kernel_result(err, times, shapes):
    """The JSON entry of one kernel; times summed over its shapes."""
    return dict(max_abs_err=err, ms=sum(t[0] for t in times),
                plain_ms=sum(t[1] for t in times),
                ms_device_only=all(t[2] for t in times),
                plain_ms_device_only=all(t[3] for t in times), shapes=shapes)


def check_equal(name: str, got, want) -> float:
    """Raise unless every tensor of got equals want's; max abs error."""
    import torch

    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 "version")
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def compare_fps(clouds):
    """K1 at each (label, cloud): N -> 512 -> 128, as PointNet2Backbone
    calls it.  Returns the JSON entry and each cloud's (xyz1, xyz2)."""
    from articulated_pose_tpu_torch.ops.kernels import fps

    err, times, shapes, picks = 0.0, [], [], {}
    for label, cloud in clouds:
        B, N, _ = cloud.shape
        got = fps.fps2(cloud, 512, 128)
        err = max(err, check_equal("fps2", got,
                                   fps.fps2_plain(cloud, 512, 128)))
        t = time_both(lambda: fps.fps2(cloud, 512, 128),
                      lambda: fps.fps2_plain(cloud, 512, 128))
        shape = f"B{B} N{N}->512->128 ({fps.fps2_variant(N, 512)})"
        log(f"[kernels] fps2 {shape}: indices and coordinates equal; {t[4]}")
        times.append(t)
        shapes.append(shape)
        picks[label] = (got[1], got[3])
    return kernel_result(err, times, shapes), picks


def compare_fps_single(cases):
    """B2 at each (cloud, npoint) of its paths.  Returns the JSON entry."""
    from articulated_pose_tpu_torch.ops.kernels import fps

    err, times, shapes = 0.0, [], []
    for cloud, npoint in cases:
        B, N, _ = cloud.shape
        err = max(err, check_equal("fps", fps.fps(cloud, npoint),
                                   fps.fps_plain(cloud, npoint)))
        t = time_both(lambda: fps.fps(cloud, npoint),
                      lambda: fps.fps_plain(cloud, npoint))
        shape = f"B{B} N{N}->{npoint} ({fps.fps_variant(N)})"
        log(f"[kernels] fps {shape}: indices and coordinates equal; {t[4]}")
        times.append(t)
        shapes.append(shape)
    return kernel_result(err, times, shapes)


def compare_grouping(name, kernel_fn, plain_fn, cases, coord_bound):
    """A grouped ball query (exact or packed) at each (points, queries,
    radius, emit_idx) of its path, S=64: cnt and idx equal, coordinates
    within coord_bound.  The emit_idx=False launch must give the same
    coordinates and counts."""
    import torch

    err, times, shapes = 0.0, [], []
    for pts, q, r, emit in cases:
        g, cnt, idx = kernel_fn(r, 64, pts, q, emit_idx=True)
        gp, cntp, idxp = plain_fn(r, 64, pts, q)
        g2, cnt2, _ = kernel_fn(r, 64, pts, q, emit_idx=False)
        check_equal(f"{name} r={r} cnt/idx", (cnt, idx, cnt2),
                    (cntp, idxp, cntp))
        e = max((g - gp).abs().max().item(), (g2 - gp).abs().max().item())
        if e > coord_bound:
            raise AssertionError(f"{name} r={r}: grouped xyz off by {e}")
        err = max(err, e)
        t = time_both(lambda: kernel_fn(r, 64, pts, q, emit_idx=emit),
                      lambda: plain_fn(r, 64, pts, q, emit_idx=emit))
        shape = (f"B{pts.shape[0]} N{pts.shape[1]} M{q.shape[1]} S64 r{r} "
                 f"emit_idx={emit}")
        log(f"[kernels] {name} {shape}: cnt, idx equal, grouped max abs "
            f"err {e:.3g}; {t[4]} (mean cnt {cnt.float().mean().item():.2f})")
        times.append(t)
        shapes.append(shape)
    return kernel_result(err, times, shapes)


def compare_kernels(dev):
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                        three_nn)

    rng = np.random.RandomState(0)
    cloud = torch.from_numpy(
        rng.rand(B_KERNEL, N_POINTS, 3).astype(np.float32)).to(dev)
    large = torch.from_numpy(
        rng.rand(LARGE_B, LARGE_N, 3).astype(np.float32)).to(dev)
    results = {}

    # K1: the serving cloud and the large cloud (its large-N variant)
    results["fps2"], picks = compare_fps((("serve", cloud),
                                          ("large", large)))
    xyz1, xyz2 = picks["serve"]
    lxyz1, lxyz2 = picks["large"]

    # K2 and B3p: SA1 (idx not emitted on the path) and SA2
    serve_cases = ((cloud, xyz1, 0.2, False), (xyz1, xyz2, 0.4, True))
    # (the exact tier keeps the first slice's 1e-6; the packed tier's
    # quantiser is written to round as its plain version does: equal)
    results["ball_query_group"] = compare_grouping(
        "ball_query_group", ball_query.ball_query_group,
        ball_query.ball_query_group_plain, serve_cases, 1e-6)
    results["ball_query_group_packed"] = compare_grouping(
        "ball_query_group_packed", ball_query.ball_query_group_packed,
        ball_query.ball_query_group_packed_plain, serve_cases, 0.0)

    # B2: the serving cloud's first level, and the N-level path's chain
    # 8192 -> 1024 -> 256 -> 64 -> 16, each level on the last one's picks
    nlevel = torch.from_numpy(
        rng.rand(NLEVEL_B, NLEVEL_N, 3).astype(np.float32)).to(dev)
    chain, level = [], nlevel
    for npoint in NLEVEL_SPEC["sa_npoints"]:
        chain.append((level, npoint))
        level = fps.fps(level, npoint)[1]
    results["fps"] = compare_fps_single([(cloud, 512)] + chain)

    # B8 at SA1 and SA2, a few queries moved out of the cloud so that
    # the zero-hit fallback runs; every output equal
    far1, far2 = xyz1.clone(), xyz2.clone()
    far1[:, :4] += 10.0
    far2[:, :4] += 10.0
    results["ball_query_group_bucket"] = compare_grouping(
        "ball_query_group_bucket", ball_query.ball_query_group_bucket,
        ball_query.ball_query_group_bucket_plain,
        ((cloud, far1, 0.2, False), (xyz1, far2, 0.4, True)), 0.0)
    for pts, q, r in ((cloud, far1, 0.2), (xyz1, far2, 0.4)):
        _, cnt, _ = ball_query.ball_query_group_bucket(r, 64, pts, q, False)
        if not ((cnt[:, :4] == 0).all() and (cnt[:, 4:] > 0).all()):
            raise AssertionError("ball_query_group_bucket: the moved "
                                 "queries must be the only ones with no hit")

    # B6: the large-cloud path's SA1 (32768 -> 512) and SA2 (512 -> 128)
    times, shapes = [], []
    for pts, q, r in ((large, lxyz1, 0.2), (lxyz1, lxyz2, 0.4)):
        idx, cnt = ball_query.ball_query_idx(r, 64, pts, q)
        check_equal(f"ball_query_idx r={r}", (idx, cnt),
                    ball_query.ball_query_idx_plain(r, 64, pts, q))
        t = time_both(lambda: ball_query.ball_query_idx(r, 64, pts, q),
                      lambda: ball_query.ball_query_idx_plain(r, 64, pts, q))
        shape = f"B{LARGE_B} N{pts.shape[1]} M{q.shape[1]} S64 r{r}"
        log(f"[kernels] ball_query_idx {shape}: idx, cnt equal; {t[4]} "
            f"(mean cnt {cnt.float().mean().item():.2f})")
        times.append(t)
        shapes.append(shape)
    results["ball_query_idx"] = kernel_result(0.0, times, shapes)

    # K3: FP2 and FP3 of both paths
    err, times, shapes = 0.0, [], []
    for a, b in ((xyz1, xyz2), (cloud, xyz1), (lxyz1, lxyz2),
                 (large, lxyz1)):
        d, i = three_nn.three_nn(a, b)
        dp, ip = three_nn.three_nn_plain(a, b)
        check_equal("three_nn indices", (i,), (ip,))
        rel = ((d - dp).abs() / dp.abs().clamp_min(1e-30)).max().item()
        if rel > 1e-6:
            raise AssertionError(f"three_nn distances off by {rel} relative")
        err = max(err, (d - dp).abs().max().item())
        t = time_both(lambda: three_nn.three_nn(a, b),
                      lambda: three_nn.three_nn_plain(a, b))
        shape = f"B{a.shape[0]} N{a.shape[1]} M{b.shape[1]}"
        log(f"[kernels] three_nn {shape}: idx equal, dist max rel err "
            f"{rel:.3g}; {t[4]}")
        times.append(t)
        shapes.append(shape)
    results["three_nn"] = kernel_result(err, times, shapes)
    return results


# ---------------------------------------------------------------- phase 3
def random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def articulated_frames(rng, B: int, N: int, K: int):
    """B frames of a K-part object whose parts 1..K-1 turn about the
    canonical z axis (revolute joints to part 0).  Each part is random
    NOCS points under a known similarity; the predictions are perfect:
    one-hot segmentation, exact NOCS, the true axis, the true joint
    association.  Returns (clouds, predictions, (R, s, t) ground truth)."""
    P = np.zeros((B, N, 3), np.float32)
    W = np.zeros((B, N, K), np.float32)
    nocs = np.zeros((B, N, 3 * K), np.float32)
    index = np.zeros((B, N, K), np.float32)
    axis = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (B, N, 1))
    gR = np.zeros((B, K, 3, 3))
    gs = np.zeros((B, K))
    gt = np.zeros((B, K, 3))
    for b in range(B):
        Rc = random_rotation(rng)
        s = rng.uniform(0.8, 1.2)
        t = rng.uniform(-0.5, 0.5, 3)
        labels = rng.randint(0, K, N)
        for j in range(K):
            Rj = Rc if j == 0 else Rc @ rot_z(rng.uniform(-1.2, 1.2))
            sj = s * rng.uniform(0.5, 1.0)
            tj = t + Rc @ rng.uniform(-0.3, 0.3, 3)
            sel = labels == j
            n = rng.rand(int(sel.sum()), 3)
            P[b, sel] = sj * n @ Rj.T + tj
            nocs[b, sel, 3 * j:3 * j + 3] = n
            W[b, sel, j] = 1.0
            index[b, sel, j] = 1.0
            gR[b, j], gs[b, j], gt[b, j] = Rj, sj, tj
    pred = {"W": W, "nocs_per_point": nocs, "joint_axis_per_point": axis,
            "index_per_point": index}
    return P, pred, (gR, gs, gt)


def rot_err_deg(R: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    tr = np.einsum("...ij,...ij->...", R, R_gt)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def pose_oracle(dev):
    import torch

    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)

    K = 3
    P, pred, (gR, gs, gt) = articulated_frames(np.random.RandomState(1),
                                               ORACLE_FRAMES, N_POINTS, K)
    cfg = PoseFitConfig(n_parts=K, joint_types=("revolute", "revolute"))
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = PoseDraws.sample(ORACLE_FRAMES, cfg, gen, dev)
    t0 = time.perf_counter()
    out = fit_frame_batch({k: torch.from_numpy(v).to(dev)
                           for k, v in pred.items()},
                          torch.from_numpy(P).to(dev), draws, cfg)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    for prefix in ("baseline", "nonlinear"):
        rot = rot_err_deg(out[f"{prefix}_R"], gR)
        s_rel = np.abs(out[f"{prefix}_s"] - gs) / gs
        t_err = np.abs(out[f"{prefix}_t"] - gt).max(-1)
        log(f"[pose] {prefix}: max rot err {rot.max():.4f} deg, max scale "
            f"rel err {s_rel.max():.2e}, max trans err {t_err.max():.2e} "
            f"over {ORACLE_FRAMES} frames x {K} parts")
        if not (rot.max() < 3.0 and s_rel.max() < 0.05 and t_err.max() < 0.05):
            raise AssertionError(f"pose oracle failed for {prefix}")
    log(f"[pose] fit_frame_batch B={ORACLE_FRAMES} N={N_POINTS} K={K} "
        f"niter 128/64 on the card: {seconds:.3f} s (first call)")


# ---------------------------------------------------------------- phase 4
def expected_launches(**per_call) -> dict:
    """Every kernel's launches in one call of a path: the named ones,
    zero for the rest."""
    from articulated_pose_tpu_torch.ops.kernels import KERNELS

    return {name: per_call.get(name, 0) for name in KERNELS}


def serve_requests(label, predictor, clouds, batch, per_batch):
    """Serve len(clouds) // batch requests through serve_clouds with the
    launch counts set to 0 first; check each request's launches, shapes
    and finiteness.  Returns the path's launch counts."""
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import serve_clouds

    K = predictor.config.n_max_parts
    N = clouds.shape[1]
    requests = len(clouds) // batch
    reset_launch_counts()
    latencies = []
    for r in range(requests):
        before = launch_counts()
        t0 = time.perf_counter()
        out = serve_clouds(predictor, clouds[r * batch:(r + 1) * batch],
                           batch)
        latencies.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_batch:
            raise AssertionError(f"[{label}] request {r}: kernel launches "
                                 f"{rise}, expected {per_batch}")
        shapes = {"R": (batch, K, 3, 3), "s": (batch, K), "t": (batch, K, 3),
                  "seg": (batch, N), "part_counts": (batch, K)}
        for k, shape in shapes.items():
            if out[k].shape != shape:
                raise AssertionError(f"{k} has shape {out[k].shape}, "
                                     f"expected {shape}")
        for k in ("R", "s", "t"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"[{label}] request {r}: non-finite {k}")
        if (out["part_counts"].sum(-1) != N).any():
            raise AssertionError("part counts do not add up to N")
    counts = launch_counts()
    for r, lat in enumerate(latencies):
        log(f"[{label}] request {r}: {batch} clouds in {lat * 1e3:.1f} ms")
    steady = latencies[1:]
    log(f"[{label}] steady {batch * len(steady) / sum(steady):.1f} clouds/s "
        f"(requests 1..{requests - 1}, N={N}, K={K}, niter "
        f"{predictor.pose_cfg.niter_part}/{predictor.pose_cfg.niter_joint});"
        f" launches {counts}")
    return counts


def serve(dev):
    """Phase 4: the f32 serve, its forward against the CPU and the bf16
    trunk; then the packed bf16 serve.  Returns each path's counts."""
    import torch

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor

    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3,
                        num_points=N_POINTS, batch_size=SERVE_BATCH)
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    predictor = PosePredictor(cfg, state_dict=state, device=dev)
    clouds, _, _ = articulated_frames(np.random.RandomState(2),
                                      SERVE_REQUESTS * PACKED_BATCH, N_POINTS,
                                      3)
    paths = {"serve f32": serve_requests(
        "serve f32", predictor, clouds[:SERVE_REQUESTS * SERVE_BATCH],
        SERVE_BATCH, expected_launches(fps2=1, ball_query_group=2,
                                       three_nn=2))}

    # forward on the card against the same weights on the CPU, B=2
    x = torch.from_numpy(clouds[:2])
    with torch.no_grad():
        gpu = predictor.model(x.to(dev))
        cpu = build_model(cfg).eval()
        cpu.load_state_dict(state)
        ref = cpu(x)
    worst = max((gpu[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"[serve f32] forward card vs CPU (plain ops), B=2: max abs diff "
        f"{worst:.3g} over {len(ref)} outputs")
    if not worst < 1e-3:
        raise AssertionError("forward on the card disagrees with the CPU")

    # bf16 trunk (the bench's inference setting)
    bf16 = build_model(cfg.replace(compute_dtype="bfloat16"), device=dev)
    bf16.load_state_dict(state)
    with torch.no_grad():
        out = bf16(torch.from_numpy(clouds[:SERVE_BATCH]).to(dev))
        f32 = predictor.model(torch.from_numpy(clouds[:SERVE_BATCH]).to(dev))
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"bf16 forward: non-finite {k}")
    diff = max((out[k] - f32[k]).abs().max().item() for k in out)
    log(f"[serve f32] bf16 trunk forward B={SERVE_BATCH}: finite, max abs "
        f"diff to f32 {diff:.3g}")

    # the configuration bench.py times: bf16 trunk, packed ball query
    packed_cfg = cfg.replace(compute_dtype="bfloat16", ball_query_packed=True,
                             batch_size=PACKED_BATCH)
    packed = PosePredictor(packed_cfg, state_dict=state, device=dev)
    paths["serve packed bf16"] = serve_requests(
        "serve packed bf16", packed, clouds, PACKED_BATCH,
        expected_launches(fps2=1, ball_query_group_packed=2, three_nn=2))
    with torch.no_grad():
        x = torch.from_numpy(clouds[:SERVE_BATCH]).to(dev)
        q = packed.model(x)
        exact = bf16(x)
    diff = max((q[k] - exact[k]).abs().max().item() for k in q)
    log(f"[serve packed bf16] forward B={SERVE_BATCH}: max abs diff to the "
        f"exact bf16 forward {diff:.3g}")
    return paths


# ------------------------------------------------------------ phases 5-7
def forward_launches(label, model, P, per_forward, forwards=1):
    """Run `forwards` forwards of P with the launch counts set to 0
    first; check each forward's launches, shapes and finiteness.
    Returns (last output, host-clock seconds per forward, counts)."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)

    reset_launch_counts()
    seconds = []
    for f in range(forwards):
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(P)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_forward:
            raise AssertionError(f"[{label}] forward {f}: kernel launches "
                                 f"{rise}, expected {per_forward}")
        for k, v in out.items():
            if v.shape[:2] != P.shape[:2] or not torch.isfinite(v).all():
                raise AssertionError(f"[{label}] forward {f}: {k} has shape "
                                     f"{tuple(v.shape)} or is not finite")
    return out, seconds, launch_counts()


def card_vs_cpu(label, make_model, state, P):
    """The f32 forward on the card against the same weights on the CPU:
    the kernels equal their plain versions, so the neighbourhoods are
    the same and only matmul summation order differs; 1e-3, the serve
    phase's bound."""
    import torch

    gpu_model = make_model(torch.float32).to(P.device)
    gpu_model.load_state_dict(state)
    cpu_model = make_model(torch.float32)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        gpu = gpu_model(P)
        ref = cpu_model(P.cpu())
    worst = max((gpu[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"[{label}] f32 forward card vs CPU (plain ops), B={P.shape[0]} "
        f"N={P.shape[1]}: max abs diff {worst:.3g} over {len(ref)} outputs")
    if not worst < 1e-3:
        raise AssertionError(f"[{label}] forward on the card disagrees with "
                             "the CPU")


def large_cloud(dev):
    """Phase 5: the large-cloud forward; returns the path's counts."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    spec = BackboneSpec(ball_query_impl="stream")

    def model(dtype):
        m = ANCSHModel(n_max_parts=3, dtype=dtype, backbone_spec=spec)
        return m.eval()

    state = init_weights(model(torch.float32),
                         torch.Generator().manual_seed(3)).state_dict()
    bf16 = model(torch.bfloat16).to(dev)
    bf16.load_state_dict(state)
    P = torch.from_numpy(np.random.RandomState(4).rand(
        LARGE_B, LARGE_N, 3).astype(np.float32)).to(dev)
    _, seconds, counts = forward_launches(
        "large", bf16, P, expected_launches(fps2=1, ball_query_idx=2,
                                            three_nn=2), LARGE_FORWARDS)
    log(f"[large] bf16 forward B={LARGE_B} N={LARGE_N}: "
        + ", ".join(f"{t * 1e3:.1f}" for t in seconds)
        + f" ms (host clock, synchronised); launches {counts}")
    card_vs_cpu("large", model, state, P[:1])
    return counts


# ---------------------------------------------------------------- phase 6
def bucket_path(dev):
    """Phase 6: bench.py's forward + pose fit with the bucket ball query;
    returns the counts of the "bucket" and "bucket_xla" paths."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          PoseFitConfig,
                                                          fit_frame_batch)
    from articulated_pose_tpu_torch.serving import POSE_KEYS

    K, B = 3, BUCKET_BATCH

    def make(impl):
        def model(dtype):
            return ANCSHModel(n_max_parts=K, dtype=dtype,
                              backbone_spec=BackboneSpec(
                                  ball_query_impl=impl)).eval()
        return model

    bucket = make("bucket")
    state = init_weights(bucket(torch.float32),
                         torch.Generator().manual_seed(5)).state_dict()
    model = bucket(torch.bfloat16).to(dev)
    model.load_state_dict(state)
    clouds, _, _ = articulated_frames(np.random.RandomState(6),
                                      BUCKET_BATCHES * B, N_POINTS, K)
    clouds = torch.from_numpy(clouds).to(dev)
    cfg = PoseFitConfig(n_parts=K, niter_part=128, niter_joint=64,
                        joint_types=("revolute", "revolute"))
    draws = PoseDraws.sample(B, cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    per_batch = expected_launches(fps2=1, ball_query_group_bucket=2,
                                  three_nn=2)

    reset_launch_counts()
    latencies = []
    for b in range(BUCKET_BATCHES):
        P = clouds[b * B:(b + 1) * B]
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            pred = model(P)
            fits = fit_frame_batch({k: pred[k] for k in POSE_KEYS}, P, draws,
                                   cfg)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_batch:
            raise AssertionError(f"[bucket] batch {b}: kernel launches {rise}"
                                 f", expected {per_batch}")
        for k, shape in (("baseline_R", (B, K, 3, 3)), ("nonlinear_R",
                                                         (B, K, 3, 3)),
                         ("baseline_s", (B, K)), ("baseline_t", (B, K, 3))):
            v = fits[k]
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                raise AssertionError(f"[bucket] batch {b}: {k} has shape "
                                     f"{tuple(v.shape)} or is not finite")
    counts = {"bucket bf16": launch_counts()}
    for b, lat in enumerate(latencies):
        log(f"[bucket] batch {b}: {B} clouds, forward + pose fit in "
            f"{lat * 1e3:.1f} ms (host clock, synchronised)")
    steady = latencies[1:]
    log(f"[bucket] steady {B * len(steady) / sum(steady):.1f} clouds/s "
        f"(batches 1..{BUCKET_BATCHES - 1}, bf16, N={N_POINTS}, K={K}, niter "
        f"128/64); launches {counts['bucket bf16']}")

    card_vs_cpu("bucket", bucket, state, clouds[:2])

    # the exact tier on the same weights: another neighbour subset
    exact = make("xla")(torch.bfloat16).to(dev)
    exact.load_state_dict(state)
    with torch.no_grad():
        a, e = model(clouds[:B]), exact(clouds[:B])
    diff = max((a[k] - e[k]).abs().max().item() for k in a)
    log(f"[bucket] bf16 forward B={B}: max abs diff to the exact bf16 "
        f"forward {diff:.3g} (another neighbour subset; no bound)")

    # "bucket_xla": B8's indices, f32 offsets gathered after
    xla = make("bucket_xla")(torch.bfloat16).to(dev)
    xla.load_state_dict(state)
    out, seconds, counts["bucket_xla bf16"] = forward_launches(
        "bucket_xla", xla, clouds[:B], per_batch)
    diff = max((out[k] - a[k]).abs().max().item() for k in out)
    log(f"[bucket_xla] bf16 forward B={B}: {seconds[0] * 1e3:.1f} ms, max "
        f"abs diff to the bucket forward {diff:.3g} (f32 against bf16 "
        f"offsets); launches {counts['bucket_xla bf16']}")
    return counts


# ---------------------------------------------------------------- phase 7
def nlevel_path(dev):
    """Phase 7: the four-level pyramid at N=8192; returns its counts."""
    import torch

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    spec = BackboneSpec(**NLEVEL_SPEC)

    def make(dtype):
        return ANCSHModel(n_max_parts=3, dtype=dtype,
                          backbone_spec=spec).eval()

    state = init_weights(make(torch.float32),
                         torch.Generator().manual_seed(7)).state_dict()
    P = torch.from_numpy(np.random.RandomState(8).rand(
        NLEVEL_B, NLEVEL_N, 3).astype(np.float32)).to(dev)
    levels = len(spec.sa_npoints)
    per_forward = expected_launches(fps=levels, ball_query_group=levels,
                                    three_nn=levels)
    counts = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = make(dtype).to(dev)
        model.load_state_dict(state)
        _, seconds, counts[f"N-level {name}"] = forward_launches(
            f"N-level {name}", model, P, per_forward, NLEVEL_FORWARDS)
        log(f"[N-level] {name} forward B={NLEVEL_B} N={NLEVEL_N}, "
            f"{levels} SA levels: "
            + ", ".join(f"{t * 1e3:.1f}" for t in seconds)
            + f" ms (host clock, synchronised); launches "
            f"{counts[f'N-level {name}']}")
    card_vs_cpu("N-level", make, state, P[:1])
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "articulated_pose_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no articulated_pose_tpu_torch/csrc beside "
              f"{__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    # the checkout's package, never an installed copy
    sys.path.insert(0, str(ROOT))
    import articulated_pose_tpu_torch  # noqa: F401  (sets TF32 off)
    from articulated_pose_tpu_torch.ops.kernels import KERNELS
    from articulated_pose_tpu_torch.ops.kernels.build import (build_all,
                                                              nvcc_path)

    dev = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvcc: {nvcc}")

    t0 = time.perf_counter()
    seconds = build_all(KERNELS.values())
    logs = {k.source: k.build_log() for k in KERNELS.values()}
    for source, log_text in sorted(logs.items()):
        ptxas = [ln.strip() for ln in log_text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {source}: {seconds[source]:.2f} s; " + " | ".join(ptxas))
    log(f"[build] all sources in parallel: {time.perf_counter() - t0:.2f} s")

    kernels = compare_kernels(dev)
    pose_oracle(dev)
    paths = serve(dev)
    paths["large"] = large_cloud(dev)
    paths.update(bucket_path(dev))
    paths.update(nlevel_path(dev))
    for name, k in kernels.items():
        k["launches"] = sum(c[name] for c in paths.values())
        if k["launches"] == 0:
            raise AssertionError(f"{name} was never launched by a path")
    log(f"[paths] launches per path: {json.dumps(paths)}")

    log(card)                       # as nvidia-smi prints it
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name].source_path,
         "replaces": KERNELS[name].replaces, **kernels[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
