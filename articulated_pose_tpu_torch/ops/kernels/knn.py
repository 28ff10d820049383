"""k-nearest-neighbour search for k <= 16: the kernel entry `knn` over
`csrc/knn.cu`.

It replaces no TPU kernel: the JAX package's `knn_point`
(`articulated_pose_tpu/ops/core.py:259`) is a `lax.top_k` over the whole
distance matrix, which at the Point Transformer's shapes
(`models/point_transformer.py`: B=16, 8192 queries of 8192 points)
would be a 4.3 GB tensor.  The kernel keeps each query's best k in
registers; `core.knn_point` states the function (squared distances in
`pairwise_sqdist`'s arithmetic, ascending, ties to the lowest index) and
is the plain version a CPU tensor takes.

`knn_plan` picks the lanes a query from the shapes alone: C lanes split
a query's candidates and merge their lists at the end, so a launch with
few queries still fills the card.
"""

from __future__ import annotations

import ctypes

import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          require_cuda,
                                                          stream_of)

MAX_K = 16
MAX_LANES = 32
CTA_THREADS = 256
# knn_plan's rule (not swept): the fewest lanes a query that give the
# launch TARGET_THREADS threads, each lane keeping at least MIN_SLICE
# candidates
TARGET_THREADS = 1 << 17
MIN_SLICE = 32


def knn_plan(B: int, M: int, N: int) -> int:
    """Lanes a query for B clouds of M queries against N candidates.
    Needs no library, so the CPU tests reach it."""
    if min(B, M, N) < 1:
        raise ValueError(f"knn_plan: need B, M, N > 0, got B={B}, M={M}, "
                         f"N={N}")
    C = 1
    while (C < MAX_LANES and B * M * C < TARGET_THREADS
           and N // (2 * C) >= MIN_SLICE):
        C *= 2
    return C


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.knn_launch.argtypes = [I, P, P, I, I, I, I, P, P, P]
    lib.knn_launch.restype = I
    lib.knn_error_string.argtypes = [I]
    lib.knn_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("knn", "knn.cu",
                    "none (articulated_pose_tpu/ops/core.py:259 is "
                    "lax.top_k, no Pallas kernel)", _bind)

knn_plain = core.knn_point


def _check(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    N = xyz.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k={k} outside 1..{MAX_K}")
    if k > N:
        raise ValueError(f"knn: k={k} exceeds the {N} candidates")
    if new_xyz.shape[0] != xyz.shape[0] or new_xyz.device != xyz.device:
        raise ValueError("knn: xyz and new_xyz must share batch size and "
                         "device")


def launch(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
           lanes: int = None):
    """One launch of csrc/knn.cu at `lanes` lanes a query (knn_plan's when
    None), counted on KERNEL: (dist, idx).  A launch the card refuses
    raises with its error text."""
    require_cuda("knn", xyz)
    require_cuda("knn", new_xyz)
    _check(k, xyz, new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if B * M == 0:
        raise ValueError(f"knn: empty problem (B={B}, M={M})")
    lanes = lanes or knn_plan(B, M, N)
    lib = KERNEL.lib()
    dev = xyz.device
    dist = torch.empty((B, M, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), KERNEL.scope():
        rc = lib.knn_launch(lanes, ptr(xyz), ptr(new_xyz), B, N, M, k,
                            ptr(dist), ptr(idx), stream_of(xyz))
    check_rc(KERNEL, rc, lib.knn_error_string)
    KERNEL.launches += 1
    return dist, idx


@counted("knn")
def knn(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The k <= 16 nearest of xyz (B, N, 3) to each of new_xyz (B, M, 3),
    f32 -> (dist (B, M, k) squared, ascending, idx (B, M, k) i32), ties
    to the lowest index.  Raises ValueError for k > 16 or k > N."""
    if xyz.device.type == "cpu":
        _check(k, xyz, new_xyz)
        return knn_plain(k, xyz, new_xyz)
    return launch(k, xyz, new_xyz)
