"""3-nearest-neighbour search: three kernel entries over `csrc/three_nn.cu`.

- `three_nn` (K3) replaces `articulated_pose_tpu/ops/pallas/three_nn.py::
  three_nn_pallas` with `packed=False` (body `_three_nn_kernel`).
- `three_nn_stream` (B7) replaces `three_nn_stream.py::three_nn_stream`
  (body `_kernel`): the same function for any M.  It launches K3, which
  streams a candidate set too large for shared memory through it a tile
  at a time; its own entry counts its launches.
- `three_nn_packed` (B9) replaces `three_nn_pallas(packed=True)` (body
  `_three_nn_key_kernel`): the 3 smallest int32 keys (truncated d²,
  index), `core.three_nn_packed` states the function.

A thread holds G queries; C neighbouring lanes hold the same queries,
each scans its slice of the candidates (staged whole in shared memory,
or streamed through it in tiles) and keeps its best three, and the C
lists merge by shuffles.  `nn_plan` picks the launch (G, C, staged) from
the shapes alone; the source says what bounds it.  A CPU tensor takes
the plain version; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          require_cuda,
                                                          stream_of)

# csrc/three_nn.cu's variants, in its NN_VARIANTS order: name -> (G
# queries a thread, C lanes a query group)
VARIANTS = {f"g{g}c{c}": (g, c) for g in (1, 2, 8)
            for c in (1, 2, 4, 8, 16, 32)}
CTA_THREADS = 256
TILE_CANDIDATES = 2048              # a streamed tile; two are resident
# shared memory a CTA may take on the H100 (232,448 bytes)
SMEM_BYTES = 232448
# nn_plan's rule, read off the sweep of every plan at the paths' shapes on
# the card (python -m articulated_pose_tpu_torch.nn_sweep; PERF.md section
# 6): stage the candidates up to STAGE_CANDIDATES; one query a thread,
# two from MANY_QUERIES queries a launch or where the candidates stream,
# eight for the packed keys; then the fewest lanes a group that give the
# launch TARGET_THREADS threads, each lane keeping at least MIN_SLICE
# candidates
STAGE_CANDIDATES = 4096
TARGET_THREADS = 65536
MANY_QUERIES = 2 * TARGET_THREADS
MIN_SLICE = 8


class Plan(NamedTuple):
    variant: str                    # a key of VARIANTS
    staged: bool                    # the whole candidate set in shared memory


def queries_per_cta(plan: Plan) -> int:
    G, C = VARIANTS[plan.variant]
    return CTA_THREADS // C * G


def smem_bytes(plan: Plan, M: int) -> int:
    """The launch's dynamic shared memory, as csrc/three_nn.cu sizes it:
    the staged candidates as float4, or two tiles of them."""
    return 16 * (M if plan.staged else 2 * TILE_CANDIDATES)


def nn_plan(B: int, N: int, M: int, packed: bool = False) -> Plan:
    """The launch for B clouds of N queries and M candidates each
    (`packed`: of the packed-key entry), by the rule above.  Needs no
    library, so the CPU tests reach it."""
    if min(B, N, M) < 1:
        raise ValueError(f"nn_plan: need B, N, M > 0, got B={B}, N={N}, "
                         f"M={M}")
    staged = M <= STAGE_CANDIDATES
    G = 8 if packed else 2 if B * N >= MANY_QUERIES or not staged else 1
    C = 1
    while (C < 32 and B * N * C < TARGET_THREADS * G
           and M // (2 * C) >= MIN_SLICE):
        C *= 2
    return Plan(f"g{G}c{C}", staged)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.three_nn_launch, lib.three_nn_packed_launch):
        fn.argtypes = [I, I, P, P, I, I, I, P, P, P]
        fn.restype = I
    lib.three_nn_error_string.argtypes = [I]
    lib.three_nn_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("three_nn", "three_nn.cu",
                    "articulated_pose_tpu/ops/pallas/three_nn.py:111", _bind)
STREAM_KERNEL = CudaKernel(
    "three_nn_stream", "three_nn.cu",
    "articulated_pose_tpu/ops/pallas/three_nn_stream.py:95", _bind)
PACKED_KERNEL = CudaKernel(
    "three_nn_packed", "three_nn.cu",
    "articulated_pose_tpu/ops/pallas/three_nn.py:62", _bind)

three_nn_plain = core.three_nn
three_nn_stream_plain = core.three_nn
three_nn_packed_plain = core.three_nn_packed


def launch(kernel: CudaKernel, xyz1: torch.Tensor, xyz2: torch.Tensor,
           plan: Plan = None):
    """One launch of csrc/three_nn.cu for `kernel` (the packed entry, or
    the exact one) at `plan` (nn_plan's when None), counted on `kernel`:
    (dist, idx).  A launch the card refuses raises with its error text."""
    require_cuda(kernel.name, xyz1)
    require_cuda(kernel.name, xyz2)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B or xyz2.device != xyz1.device:
        raise ValueError(f"{kernel.name}: xyz1 and xyz2 must share batch "
                         "size and device")
    if B * N == 0 or M == 0:
        raise ValueError(f"{kernel.name}: empty problem (B={B}, N={N}, "
                         f"M={M})")
    plan = plan or nn_plan(B, N, M, kernel is PACKED_KERNEL)
    if plan.variant not in VARIANTS:
        raise ValueError(f"{kernel.name}: unknown plan {plan}")
    lib = kernel.lib()
    fn = (lib.three_nn_packed_launch if kernel is PACKED_KERNEL
          else lib.three_nn_launch)
    dev = xyz1.device
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), kernel.scope():
        rc = fn(list(VARIANTS).index(plan.variant), int(plan.staged),
                ptr(xyz1), ptr(xyz2), B, N, M, ptr(dist), ptr(idx),
                stream_of(xyz1))
    check_rc(kernel, rc, lib.three_nn_error_string)
    kernel.launches += 1
    return dist, idx


@counted("three_nn")
def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) f32 -> (dist (B, N, 3) squared,
    ascending, idx (B, N, 3) i32), ties to the lowest index."""
    if xyz1.device.type == "cpu":
        return three_nn_plain(xyz1, xyz2)
    return launch(KERNEL, xyz1, xyz2)


@counted("three_nn_stream")
def three_nn_stream(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """As `three_nn`, for candidate sets of any size M.  The TPU
    wrapper's `block_m` is not taken: it sized the VMEM tile of
    candidates and does not change the result (the running best three
    merge by (distance, index), so ties across tiles and slices still go
    to the lowest index); the kernel's shared-memory tile is fixed."""
    if xyz1.device.type == "cpu":
        return three_nn_stream_plain(xyz1, xyz2)
    return launch(STREAM_KERNEL, xyz1, xyz2)


@counted("three_nn_packed")
def three_nn_packed(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) f32, M <= 65536 -> (dist (B, N, 3)
    d² truncated to its top 16 bits, idx (B, N, 3) i32), ordered by the
    key (truncated d², index); spare slots (M < 3) hold idx 65535 and
    dist NaN.  Raises ValueError for M > 65536."""
    M = xyz2.shape[1]
    if M > core.PACKED_MAX_CANDIDATES:
        raise ValueError(f"three_nn_packed: M={M} exceeds the key's 16-bit "
                         f"index (65536)")
    if xyz1.device.type == "cpu":
        return three_nn_packed_plain(xyz1, xyz2)
    return launch(PACKED_KERNEL, xyz1, xyz2)
