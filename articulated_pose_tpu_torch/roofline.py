"""FLOP and byte accounting of the served and trained programs, and their
time floors on the card.

    python -m articulated_pose_tpu_torch.roofline [--batch 64]
        [--points 2048]

Counterpart of scripts/roofline_accounting.py.  XLA's cost analysis read
the compiled program; here `Counter`, a `TorchDispatchMode`, reads the
aten ops that the program runs, eagerly, and counts for each op:

- its FLOPs: the rules of `torch.utils.flop_counter` for the ops on its
  list (2·M·N·K for `mm`, `addmm`, `bmm`, `baddbmm`), one a output
  element for a pointwise op (`torch.Tag.pointwise`, the `_foreach_`
  ops) and one for each element that a reduction (`torch.Tag.reduction`)
  reads; the other ops (gathers, sorts, copies) count no FLOPs;
- its launched bytes: each input and output tensor it touches, once an
  op; views and bare allocations touch nothing.

Composite ops (`linear`, `matmul`, `to`) are decomposed first, as
autograd would, so the count is the same under `torch.inference_mode`.
The totals of a program (`Count`) are its GEMM FLOPs by dtype, all its
FLOPs, and two byte counts: *compulsory*, its inputs, parameters and
outputs, each read or written once (every storage the program reads that
it did not make, every such storage it writes in place, every tensor it
returns), and *as launched*, the sum above: what eager PyTorch moves
without fusion.

The hand-written kernels are opaque to the mode, as Pallas custom calls
are to XLA's analyser.  Each kernel entry (`ops/kernels/`) goes through
`build.counted`'s hook: under a counter, the entry's work is counted by
its work function below from the call's shapes (for a first-S ball
query also from its hits, since the points it examines depend on the
data) and nothing that ran inside the entry is (the plain version's ops
on the CPU, the wrapper's allocations on the card), so both devices
count the same.  The hook costs one list test when no counter is on.

Floors (`Count.floors`): the operations at the published peaks, 989
TFLOP/s for GEMMs in bf16 (the tensor cores) and 67 TFLOP/s for f32
GEMMs (TF32 is off) and every other FLOP, against the bytes at 3.35
TB/s; the larger binds.  `roofline_session` sets the measured ceilings
of `probe_card` beside them.

The stages are the JAX script's, at bench.py's program (B=64, N=2048,
bf16 trunk, packed ball query): the forward, the pose fit at the
production config (niter 128/64, ransac_chunk=None), FPS 2048->512, the
SA1 ball query (2048 points, 512 queries, r 0.2, S 64) and FP1's 3-NN
(2048 <- 512); and the f32 train step at B=16, N=1024 (eyeglasses,
reference widths).  Counting runs the program once; it times nothing,
so a CPU run (`--device cpu`, for the tests) counts the same and prints
the same floors, which are bounds from published peaks, not readings.
Without a card, and unless `--device cpu` is given, it raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.ops.kernels import build
from articulated_pose_tpu_torch.ops.kernels.joint_fit import launch_config
from articulated_pose_tpu_torch.programs import (bench_model,
                                                 bench_pose_config,
                                                 random_predictions,
                                                 resolve_device, train_setup)

# FLOPs the kernels' work needs: a (query, point) distance is the inner
# product (3 mul, 2 add), |q|^2 + |p|^2, 2 q.p and the difference, plus
# the radius test or the clamp; |p|^2 or |q|^2 is 5 once per point; 3-NN
# adds one compare against its third-best; an FPS step costs 3 sub,
# 3 mul, 2 add, the running min and the argmax compare per point; the
# packed tier's quantiser ~30 per point (box, scale, floor, clamp, fma)
PAIR_FLOPS = 9
NORM_FLOPS = 5
NN_PAIR_FLOPS = 10
FPS_FLOPS = 10
QUANT_FLOPS = 30
# a joint hypothesis's inlier test at a point: 16 fmas of the bilinear
# expansion, the two norms added and the compare
SCORE_FLOPS = 35

THREE_NN = ("three_nn", "three_nn_stream", "three_nn_packed")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclasses.dataclass(frozen=True)
class Work:
    """A kernel call's work: its FLOPs (f32, outside the tensor cores) and
    its compulsory bytes (each input read once, each output written
    once)."""

    flops: float
    bytes: float


def bound(work: Work) -> Tuple[float, float]:
    """(ms for the work's operations, ms for its bytes) at the published
    peaks; the larger is the least time the card could take."""
    return timing.roofline_ms(work.flops, work.bytes)


# ------------------------------------------------- the kernels' work
def fps2_work(B: int, N: int, np1: int, np2: int) -> Work:
    """K1 (`fps2`): N -> np1 -> np2; a pick past a level's point count
    takes no step."""
    steps = (min(np1, N) - 1) * N + (min(np2, np1) - 1) * np1
    return Work(B * steps * FPS_FLOPS,
                4 * 3 * B * N + B * (np1 + np2) * (4 + 12))


def fps_work(B: int, N: int, npoint: int) -> Work:
    """B2 (`fps`): N -> npoint."""
    return Work(B * (min(npoint, N) - 1) * N * FPS_FLOPS,
                4 * 3 * B * N + B * npoint * (4 + 12))


def ball_query_work(name: str, B: int, N: int, M: int, S: int,
                    emit_idx: bool, scanned: int) -> Work:
    """A ball-query entry on B clouds of N points, M queries of S slots
    each, whose queries examine `scanned` (query, point) pairs in all
    (`scanned_points` for a first-S tier; B·M·N for the bucket tier,
    which scans the whole cloud).  The grouped tiers write (B, M, S, 3)
    f32 coordinates and cnt, and idx when `emit_idx`; the idx-only tiers
    (`ball_query_idx`, `ball_query_point`) write idx and cnt."""
    point_flops = NORM_FLOPS + (QUANT_FLOPS if name.endswith("packed")
                                else 0)
    flops = scanned * PAIR_FLOPS + B * N * point_flops + B * M * NORM_FLOPS
    inputs = 4 * 3 * (B * N + B * M)
    if name in ("ball_query_idx", "ball_query_point"):
        return Work(flops, inputs + 4 * B * M * S + 4 * B * M)
    grouped = 4 * 3 * B * M * S + 4 * B * M
    return Work(flops, inputs + grouped + (4 * B * M * S if emit_idx else 0))


def three_nn_work(B: int, N: int, M: int) -> Work:
    """A 3-NN entry: N queries against M candidates a cloud, each pair
    one distance and one compare; writes (B, N, 3) distances and
    indices."""
    return Work(B * N * M * NN_PAIR_FLOPS + B * (N + M) * NORM_FLOPS,
                4 * 3 * (B * N + B * M) + 2 * 4 * 3 * B * N)


def knn_work(B: int, M: int, N: int, k: int) -> Work:
    """The `knn` entry: M queries against N candidates a cloud, each pair
    one distance (PAIR_FLOPS) and each point's and query's |p|^2; reads
    both clouds once, writes (B, M, k) distances and indices."""
    return Work(B * M * N * PAIR_FLOPS + B * (N + M) * NORM_FLOPS,
                4 * 3 * (B * N + B * M) + 2 * 4 * B * M * k)


def joint_fit_work(B: int, K: int, cap: int, H: int,
                   score_points: int) -> Work:
    """The `joint_fit` entry over B frames of K parts: for each of the
    B (K - 1) joints, 2 x H x score_points (hypothesis, point) inlier
    tests of SCORE_FLOPS; reads the part buffers, axes and draws once,
    writes each joint's fit, best hypothesis, scores and inlier sets."""
    J = B * (K - 1)
    return Work(J * 2 * H * score_points * SCORE_FLOPS,
                4 * B * K * cap * 7 + 4 * J * 3 + 4 * J * 2 * H * 3
                + 4 * J * (26 + 1 + H) + J * 2 * cap)


def vector_attention_work(B: int, n: int, k: int, C: int,
                          esize: int) -> Work:
    """The `vector_attention` entry on B clouds of n queries, k
    neighbours each, width C, q, key and v of `esize` bytes an element:
    the f32 work is theta's Linear(3, C) and the weighted sum (4 C
    multiply-adds a (query, neighbour) row); gamma's two products are
    tensor-core work (`vector_attention_gamma_flops`).  Reads p, q, key,
    v and the neighbours once, writes y (B, n, C) f32."""
    rows = B * n * k
    return Work(2 * rows * 4 * C,
                4 * 3 * B * n + 3 * esize * B * n * C + 4 * B * n * k
                + 4 * B * n * C)


def vector_attention_gamma_flops(B: int, n: int, k: int, C: int,
                                 share: int) -> float:
    """gamma's Linear(C, C/share) and Linear(C/share, C/share) over the
    B n k rows of a `vector_attention` call."""
    G = C // share
    return 2.0 * B * n * k * (C * G + G * G)


def scanned_points(idx: torch.Tensor, cnt: torch.Tensor, N: int
                   ) -> Tuple[int, int]:
    """Points a first-S ball query has to examine for these hits: each
    query's cloud up to its S-th hit, all of it when it has fewer.
    Returns (the sum over the queries, the largest)."""
    S = idx.shape[-1]
    n = torch.where(cnt >= S, idx[..., -1].long() + 1, N)
    return int(n.sum()), int(n.max())


def _arg(args, kwargs, i: int, name: str, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def kernel_work(name: str, args, kwargs, out) -> Work:
    """The work of one call of the kernel entry `name` with (args,
    kwargs), which returned `out`, by the work functions above."""
    if name == "fps2":
        xyz = args[0]
        return fps2_work(xyz.shape[0], xyz.shape[1],
                         _arg(args, kwargs, 1, "np1"),
                         _arg(args, kwargs, 2, "np2"))
    if name == "fps":
        xyz = args[0]
        return fps_work(xyz.shape[0], xyz.shape[1],
                        _arg(args, kwargs, 1, "npoint"))
    if name == "knn":
        k, xyz, new_xyz = (_arg(args, kwargs, i, n)
                           for i, n in enumerate(("k", "xyz", "new_xyz")))
        return knn_work(xyz.shape[0], new_xyz.shape[1], xyz.shape[1], k)
    if name == "joint_fit":
        src, draws, cfg = (_arg(args, kwargs, i, n)
                           for i, n in ((0, "src"), (4, "draws"), (5, "cfg")))
        B, K, cap = src.shape[:3]
        return joint_fit_work(B, K, cap, draws.shape[3],
                              launch_config(cfg, B, K, cap).score_points)
    if name == "vector_attention":
        q, nbr = _arg(args, kwargs, 2, "q"), _arg(args, kwargs, 5, "nbr")
        B, n, C = q.shape
        return vector_attention_work(B, n, nbr.shape[-1], C,
                                     q.element_size())
    if name in THREE_NN:
        a, b = args[0], _arg(args, kwargs, 1, "xyz2")
        return three_nn_work(a.shape[0], a.shape[1], b.shape[1])
    radius, nsample, xyz, new_xyz = (
        _arg(args, kwargs, i, n)
        for i, n in enumerate(("radius", "nsample", "xyz", "new_xyz")))
    B, N = xyz.shape[:2]
    M = new_xyz.shape[1]
    emit = bool(_arg(args, kwargs, 4, "emit_idx", True))
    if name == "ball_query_group_bucket":
        return ball_query_work(name, B, N, M, nsample, emit, B * M * N)
    if name in ("ball_query_idx", "ball_query_point"):
        idx, cnt = out
    elif name == "ball_query_point_grouped":
        idx, cnt, _ = out
        emit = True
    else:
        _, cnt, idx = out
    if idx is None:
        # the hits of the entry's own plain version (the packed tier's are
        # exact: it quantises the coordinates it writes, not its test)
        from articulated_pose_tpu_torch.ops.kernels import ball_query

        plain = getattr(ball_query, f"{name}_plain")
        _, cnt, idx = plain(radius, nsample, xyz, new_xyz)
    return ball_query_work(name, B, N, M, nsample, emit,
                           scanned_points(idx, cnt, N)[0])


# ------------------------------------------------------- the counter
EMPTY_OPS = {"aten::empty", "aten::empty_strided", "aten::empty_like",
             "aten::new_empty", "aten::new_empty_strided"}
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _is_view(func) -> bool:
    """Whether every output aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _written(func, args, kwargs):
    """The tensors that `func` writes in place (its `a!` arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) and not a.kwarg_only else \
            kwargs.get(a.name)
        out.extend(t for t in tree_flatten(v)[0] if torch.is_tensor(t))
    return out


def _tensors(tree):
    seen, out = set(), []
    for t in tree_flatten(tree)[0]:
        if torch.is_tensor(t) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _key(t: torch.Tensor):
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


@dataclasses.dataclass
class Count:
    """What one run of a program does, as `Counter` counted it."""

    gemm_flops: Dict[str, float]          # dtype -> GEMM FLOPs
    other_flops: float                    # pointwise and reductions
    kernel_flops: float                   # the hand-written kernels'
    launched_bytes: float
    compulsory_bytes: float
    ops: int                              # aten ops that launch work
    kernels: Dict[str, int]               # kernel entry -> calls
    top_ops: Dict[str, float]             # the 8 ops launching most bytes

    @property
    def gemm(self) -> float:
        return sum(self.gemm_flops.values())

    @property
    def flops(self) -> float:
        return self.gemm + self.other_flops + self.kernel_flops

    def ops_ms(self, f32_flops: float = timing.F32_PEAK_FLOPS,
               tensor_flops: float = timing.TENSOR_PEAK_FLOPS) -> float:
        """ms of the operations: bf16 / fp16 GEMMs at `tensor_flops`,
        every other FLOP at `f32_flops`."""
        tc = sum(v for k, v in self.gemm_flops.items()
                 if k in ("bfloat16", "float16"))
        return (tc / tensor_flops + (self.flops - tc) / f32_flops) * 1e3

    def floors(self, f32_flops: float = timing.F32_PEAK_FLOPS,
               tensor_flops: float = timing.TENSOR_PEAK_FLOPS,
               hbm: float = timing.HBM_BYTES_PER_S) -> Dict[str, object]:
        """The operations' ms, the compulsory and launched bytes' ms at
        `hbm` bytes/s, and the floor (the larger of the operations and
        the compulsory bytes) with which of the two binds."""
        ops = self.ops_ms(f32_flops, tensor_flops)
        byt = self.compulsory_bytes / hbm * 1e3
        return dict(ops_ms=ops, bytes_ms=byt,
                    launched_ms=self.launched_bytes / hbm * 1e3,
                    floor_ms=max(ops, byt),
                    bound_by="operations" if ops >= byt else "bytes")

    def row(self) -> Dict[str, object]:
        return dict(gemm_gflop=self.gemm / 1e9, gflop=self.flops / 1e9,
                    gemm_gflop_by_dtype={k: v / 1e9 for k, v in
                                         self.gemm_flops.items()},
                    compulsory_mb=self.compulsory_bytes / 1e6,
                    launched_mb=self.launched_bytes / 1e6, ops=self.ops,
                    kernels=dict(self.kernels),
                    top_launched_mb={k: v / 1e6 for k, v in
                                     self.top_ops.items()},
                    **self.floors())


class Counter(TorchDispatchMode):
    """Counts the aten ops run under it and the kernel entries' work (see
    the module's docstring).  `count(fn)` is the way to use it."""

    def __init__(self):
        super().__init__()
        self.gemm_flops = collections.Counter()
        self.other_flops = 0.0
        self.kernel_flops = 0.0
        self.launched_bytes = 0.0
        self.ops = 0
        self.kernels = collections.Counter()
        self.by_op = collections.Counter()
        self.read_bytes = 0.0
        self.write_bytes = 0.0
        self._produced, self._read, self._written = set(), set(), set()
        self._inside = 0

    # a kernel entry, through build.counted's hook
    def kernel_call(self, name: str, fn: Callable, args, kwargs):
        if self._inside:
            return fn(*args, **kwargs)
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
            work = kernel_work(name, args, kwargs, out)
        finally:
            self._inside -= 1
        self.kernels[name] += 1
        self.kernel_flops += work.flops
        self.launched_bytes += work.bytes
        self.by_op[f"kernel:{name}"] += work.bytes
        self._track(_tensors((args, kwargs)), [], _tensors(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._inside:
            return func(*args, **kwargs)
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _is_view(func) or func._schema.name in EMPTY_OPS:
            return out
        ins = _tensors((args, kwargs))
        in_ids = {id(t) for t in ins}
        outs = [t for t in _tensors(out) if id(t) not in in_ids]
        written = _written(func, args, kwargs)
        moved = nbytes(*ins, *outs)
        self.ops += 1
        self.launched_bytes += moved
        self.by_op[str(func.overloadpacket)] += moved
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
            self.gemm_flops[str(outs[0].dtype).split(".")[-1]] += flops
        elif (torch.Tag.pointwise in func.tags
              or func._schema.name.startswith("aten::_foreach_")):
            # an in-place op's output is the tensor it writes
            self.other_flops += sum(t.numel() for t in outs or written)
        elif _REDUCTION is not None and _REDUCTION in func.tags:
            self.other_flops += ins[0].numel()
        self._track(ins, written, outs)
        return out

    def _track(self, ins, written, outs) -> None:
        """The compulsory bytes: a storage read that the program did not
        make, once; one written in place, once."""
        for t in ins:
            if t.numel() == 0:
                continue
            k = _key(t)
            if k not in self._produced and k not in self._read:
                self._read.add(k)
                self.read_bytes += t.untyped_storage().nbytes()
        for t in written:
            k = _key(t)
            if t.numel() and k not in self._produced \
                    and k not in self._written:
                self._written.add(k)
                self.write_bytes += t.untyped_storage().nbytes()
        for t in outs:
            if t.numel():
                self._produced.add(_key(t))

    def result(self, returned) -> Count:
        """The totals, with `returned` (the program's return value) as
        its outputs."""
        out_bytes = nbytes(*(t for t in _tensors(returned)
                             if t.numel() and _key(t) in self._produced))
        return Count(
            gemm_flops=dict(self.gemm_flops), other_flops=self.other_flops,
            kernel_flops=self.kernel_flops,
            launched_bytes=self.launched_bytes,
            compulsory_bytes=self.read_bytes + self.write_bytes + out_bytes,
            ops=self.ops, kernels=dict(self.kernels),
            top_ops=dict(self.by_op.most_common(8)))


def count(fn: Callable[[], object]) -> Count:
    """Run fn() once under a `Counter`; its return value is the
    program's output."""
    counter = Counter()
    build.COUNTERS.append(counter)
    try:
        with counter:
            out = fn()
    finally:
        build.COUNTERS.remove(counter)
    return counter.result(out)


def same_counts(a: Count, b: Count) -> bool:
    """Whether two runs counted the same work (the CPU's and the card's
    of one program)."""
    return (a.gemm_flops == b.gemm_flops and a.other_flops == b.other_flops
            and a.kernel_flops == b.kernel_flops
            and a.launched_bytes == b.launched_bytes
            and a.compulsory_bytes == b.compulsory_bytes and a.ops == b.ops
            and a.kernels == b.kernels)


# ------------------------------------------------------------ stages
K_PARTS = 3


def stage_fns(batch: int, points: int, train_batch: int, train_points: int,
              dev: torch.device, spec=None, train_spec=None
              ) -> Dict[str, tuple]:
    """stage -> (label, fn), on inputs from numpy seed 0 in the JAX
    script's order (the cloud, then the pose fit's predictions).  These
    are scripts/roofline_accounting.py's stages, not `profile_stages`'
    (which `roofline_session` counts): bench.py's packed forward, uniform
    pose heads, and the cloud's first points as the SA1 queries."""
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
    from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                        three_nn)
    from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                          fit_frame_batch)
    from articulated_pose_tpu_torch.train.state import (dropout_generator,
                                                        train_step)

    B, N, K = batch, points, K_PARTS
    spec = spec or BackboneSpec()
    rng = np.random.RandomState(0)
    P = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).to(dev)
    pred = random_predictions(rng, B, N, K, dev)
    n1, r1, s1 = spec.sa_npoints[0], spec.sa_radii[0], spec.sa_nsamples[0]
    q = P[:, :n1].contiguous()
    model = bench_model(dev, spec)
    cfg = bench_pose_config()
    draws = PoseDraws.sample(B, cfg, torch.Generator(device=dev).manual_seed(
        1), dev)
    state, batch0, _ = train_setup(train_batch, train_points, dev,
                                   train_spec)
    drop = torch.Generator(device=dev)
    return {
        "forward": ("forward (bf16, packed)", lambda: model(P)),
        "pose": ("pose fit (production cfg)",
                 lambda: fit_frame_batch(pred, P, draws, cfg)),
        "fps": (f"fps {N}->{n1}", lambda: fps.fps(P, n1)),
        "ballq": (f"ball query SA1 ({q.shape[1]}q, {N})",
                  lambda: ball_query.ball_query_point(r1, s1, P, q)),
        "threenn": (f"three_nn FP1 ({N}<-{q.shape[1]})",
                    lambda: three_nn.three_nn(P, q)),
        # the train step differentiates: counted with autograd on
        "train": (f"train step (f32, B={train_batch}, N={train_points})",
                  lambda: train_step(state, batch0, dropout_generator(
                      drop, state.config.seed, 0))),
    }


HEADER = (f"{'stage':<34s} {'GEMM GF':>9s} {'all GF':>9s} {'comp MB':>9s} "
          f"{'launch MB':>10s} {'ops ms':>8s} {'bytes ms':>9s} "
          f"{'floor ms':>9s} {'bound':>10s} {'ops':>6s}")


def print_row(label: str, row: Dict) -> None:
    print(f"{label:<34s} {row['gemm_gflop']:9.3f} {row['gflop']:9.3f} "
          f"{row['compulsory_mb']:9.2f} {row['launched_mb']:10.2f} "
          f"{row['ops_ms']:8.4f} {row['bytes_ms']:9.4f} "
          f"{row['floor_ms']:9.4f} {row['bound_by']:>10s} {row['ops']:6d}",
          flush=True)


def run(batch: int = 64, points: int = 2048, train_batch: int = 16,
        train_points: int = 1024, device: str = "cuda", spec=None,
        train_spec=None) -> Dict:
    """Count every stage; print the table and one JSON line; return the
    readings.  Raises if `device` is a CUDA device that is not
    available."""
    dev = resolve_device(device, "roofline")
    fns = stage_fns(batch, points, train_batch, train_points, dev, spec,
                    train_spec)
    print(f"floors at the published peaks: "
          f"{timing.TENSOR_PEAK_FLOPS / 1e12:g} TFLOP/s bf16 GEMMs, "
          f"{timing.F32_PEAK_FLOPS / 1e12:g} TFLOP/s f32, "
          f"{timing.HBM_BYTES_PER_S / 1e12:g} TB/s", flush=True)
    print(HEADER, flush=True)
    rows = []
    for name, (label, fn) in fns.items():
        with torch.no_grad() if name != "train" else \
                contextlib.nullcontext():
            row = dict(stage=name, label=label, **count(fn).row())
        print_row(label, row)
        rows.append(row)
    result = dict(tool="roofline", card=timing.card_or_none(dev),
                  device=str(dev), batch=batch, points=points,
                  train_batch=train_batch, train_points=train_points,
                  rows=rows)
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    args = ap.parse_args(argv)
    run(args.batch, args.points, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
