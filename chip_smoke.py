#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the exit code
is non-zero):

0. Require a CUDA device; print the card (nvidia-smi name and power
   limit) and the torch / CUDA / nvcc versions.
1. Build the three CUDA kernels from csrc/ with nvcc.
2. Hold each kernel against its plain PyTorch version at the serving
   path's shapes (B=16): exact indices and counts; coordinates within
   1e-6 absolute; 3-NN distances within 1e-6 relative.  Device time of
   each, median of 20 CUDA-event-timed calls (`cuda_time_ms`).
3. Pose oracle: 8 frames of a 3-part object with two revolute joints and
   perfect predictions; the pose fit on the card must recover every
   part's similarity (rotation < 3 deg, scale within 5 %, translation
   within 0.05).
4. Serve: PosePredictor at the reference width for eyeglasses (K=3),
   N=2048, batch 16, f32, seeded random weights; three requests of 16
   clouds through serve_clouds, with every kernel launched by the path
   (1 FPS, 2 ball query, 2 3-NN per batch); the forward on the card
   against the same model on the CPU; one forward with the bf16 trunk.

The last lines are the card's name and power limit as nvidia-smi prints
them, a JSON object describing each kernel, then
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
ORACLE_FRAMES = 8


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


def compare_kernels(dev):
    import torch

    from articulated_pose_tpu_torch.ops.kernels import ball_query, fps, three_nn

    rng = np.random.RandomState(0)
    cloud = torch.from_numpy(
        rng.rand(B_KERNEL, N_POINTS, 3).astype(np.float32)).to(dev)
    results = {}

    # K1: 2048 -> 512 -> 128, as PointNet2Backbone calls it
    got = fps.fps2(cloud, 512, 128)
    want = fps.fps2_plain(cloud, 512, 128)
    torch.cuda.synchronize()
    for name, g, w in zip(("idx1", "xyz1", "idx2", "xyz2"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"fps2 {name} differs from the plain version")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    t = time_both(lambda: fps.fps2(cloud, 512, 128),
                  lambda: fps.fps2_plain(cloud, 512, 128))
    log(f"[kernels] fps2 B=16 N=2048->512->128: indices and coordinates "
        f"equal (max abs err {err:.3g}); {t[4]}")
    results["fps2"] = kernel_result(err, [t], ["B16 N2048->512->128"])
    xyz1, xyz2 = got[1], got[3]

    # K2: SA1 (idx not emitted on the path) and SA2
    err, times, shapes = 0.0, [], []
    for pts, q, r, emit in ((cloud, xyz1, 0.2, False), (xyz1, xyz2, 0.4, True)):
        g, cnt, idx = ball_query.ball_query_group(r, 64, pts, q, emit_idx=True)
        gp, cntp, idxp = ball_query.ball_query_group_plain(r, 64, pts, q)
        g2, cnt2, _ = ball_query.ball_query_group(r, 64, pts, q, emit_idx=False)
        torch.cuda.synchronize()
        if not (torch.equal(cnt, cntp) and torch.equal(idx, idxp)
                and torch.equal(cnt2, cntp)):
            raise AssertionError(f"ball query r={r}: cnt/idx differ from the "
                                 "plain version")
        e = max((g - gp).abs().max().item(), (g2 - gp).abs().max().item())
        if e > 1e-6:
            raise AssertionError(f"ball query r={r}: grouped xyz off by {e}")
        err = max(err, e)
        t = time_both(
            lambda: ball_query.ball_query_group(r, 64, pts, q, emit_idx=emit),
            lambda: ball_query.ball_query_group_plain(r, 64, pts, q,
                                                      emit_idx=emit))
        shape = (f"B16 N{pts.shape[1]} M{q.shape[1]} S64 r{r} "
                 f"emit_idx={emit}")
        log(f"[kernels] ball_query_group {shape}: cnt, idx equal, grouped "
            f"max abs err {e:.3g}; {t[4]} (mean cnt "
            f"{cnt.float().mean().item():.2f})")
        times.append(t)
        shapes.append(shape)
    results["ball_query_group"] = kernel_result(err, times, shapes)

    # K3: FP2 (512 <- 128) and FP3 (2048 <- 512)
    err, times, shapes = 0.0, [], []
    for a, b in ((xyz1, xyz2), (cloud, xyz1)):
        d, i = three_nn.three_nn(a, b)
        dp, ip = three_nn.three_nn_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(i, ip):
            raise AssertionError("three_nn indices differ from the plain "
                                 "version")
        rel = ((d - dp).abs() / dp.abs().clamp_min(1e-30)).max().item()
        if rel > 1e-6:
            raise AssertionError(f"three_nn distances off by {rel} relative")
        err = max(err, (d - dp).abs().max().item())
        t = time_both(lambda: three_nn.three_nn(a, b),
                      lambda: three_nn.three_nn_plain(a, b))
        shape = f"B16 N{a.shape[1]} M{b.shape[1]}"
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
def serve(dev, kernels):
    import torch

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                        reset_launch_counts)
    from articulated_pose_tpu_torch.serving import PosePredictor, serve_clouds

    cfg = NetworkConfig(category="eyeglasses", n_max_parts=3,
                        num_points=N_POINTS, batch_size=SERVE_BATCH)
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    predictor = PosePredictor(cfg, state_dict=state, device=dev)
    clouds, _, _ = articulated_frames(np.random.RandomState(2),
                                      SERVE_REQUESTS * SERVE_BATCH, N_POINTS,
                                      3)
    K = cfg.n_max_parts

    reset_launch_counts()
    per_batch = {"fps2": 1, "ball_query_group": 2, "three_nn": 2}
    latencies = []
    for r in range(SERVE_REQUESTS):
        before = launch_counts()
        t0 = time.perf_counter()
        out = serve_clouds(predictor,
                           clouds[r * SERVE_BATCH:(r + 1) * SERVE_BATCH],
                           SERVE_BATCH)
        latencies.append(time.perf_counter() - t0)
        after = launch_counts()
        rise = {k: after[k] - before[k] for k in after}
        if rise != per_batch:
            raise AssertionError(f"request {r}: kernel launches {rise}, "
                                 f"expected {per_batch}")
        shapes = {"R": (SERVE_BATCH, K, 3, 3), "s": (SERVE_BATCH, K),
                  "t": (SERVE_BATCH, K, 3), "seg": (SERVE_BATCH, N_POINTS),
                  "part_counts": (SERVE_BATCH, K)}
        for k, shape in shapes.items():
            if out[k].shape != shape:
                raise AssertionError(f"{k} has shape {out[k].shape}, "
                                     f"expected {shape}")
        for k in ("R", "s", "t"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"request {r}: non-finite {k}")
        if (out["part_counts"].sum(-1) != N_POINTS).any():
            raise AssertionError("part counts do not add up to N")
    counts = launch_counts()
    for name, k in kernels.items():
        k["launches"] = counts[name]
    for r, lat in enumerate(latencies):
        log(f"[serve] request {r}: {SERVE_BATCH} clouds in {lat * 1e3:.1f} ms")
    steady = latencies[1:]
    log(f"[serve] steady {SERVE_BATCH * len(steady) / sum(steady):.1f} "
        f"clouds/s (requests 1..{SERVE_REQUESTS - 1}, f32, N={N_POINTS}, K=3, "
        f"niter 128/64); launches {counts}")

    # forward on the card against the same weights on the CPU, B=2
    x = torch.from_numpy(clouds[:2])
    with torch.no_grad():
        gpu = predictor.model(x.to(dev))
        cpu = build_model(cfg).eval()
        cpu.load_state_dict(state)
        ref = cpu(x)
    worst = max((gpu[k].cpu() - ref[k]).abs().max().item() for k in ref)
    log(f"[serve] forward card vs CPU (plain ops), B=2: max abs diff "
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
    log(f"[serve] bf16 trunk forward B={SERVE_BATCH}: finite, max abs diff "
        f"to f32 {diff:.3g}")


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
    from articulated_pose_tpu_torch.ops.kernels.build import nvcc_path

    dev = torch.device("cuda")
    card = card_line()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvcc: {nvcc}")

    t0 = time.perf_counter()
    for k in KERNELS.values():
        k.lib()
        ptxas = [ln.strip() for ln in k.build_log().splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {k.source}: {k.build_seconds:.2f} s; " + " | ".join(ptxas))
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")

    kernels = compare_kernels(dev)
    pose_oracle(dev)
    serve(dev, kernels)

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
