"""The work of the port's point-cloud kernels: a frozen copy of the work
functions of the port's `roofline.py` (`fps2_work`, `ball_query_work`,
`three_nn_work`, `scanned_points`), and the floor of a kernel's work at
the published peaks.  The work is computed from shapes and, for a
first-S ball query, from the hits of these inputs; never from what the
implementation launches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from posebench.metrics.flops import F32_PEAK_FLOPS, HBM_BYTES_PER_S

# FLOPs a kernel's work needs: a (query, point) distance (inner product,
# norms, difference, test) 9; a point's or query's |p|² 5; a 3-NN pair
# 10 (the compare against the third-best); an FPS step 10 a point; the
# packed tier's quantiser ~30 a point
PAIR_FLOPS = 9
NORM_FLOPS = 5
NN_PAIR_FLOPS = 10
FPS_FLOPS = 10
QUANT_FLOPS = 30

# the port's kernel symbols as a trace names them (`csrc/*.cu`)
KERNEL_SYMBOLS = ("fps_kernel", "ball_query_kernel", "quantize_kernel",
                  "three_nn_kernel")


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def floor_us(self) -> float:
        """The least time the card could take: the larger of the FLOPs
        at the float32 peak and the bytes at the HBM peak."""
        return max(self.flops / F32_PEAK_FLOPS,
                   self.bytes / HBM_BYTES_PER_S) * 1e6


def fps2_work(B: int, N: int, np1: int, np2: int) -> Work:
    steps = (min(np1, N) - 1) * N + (min(np2, np1) - 1) * np1
    return Work(B * steps * FPS_FLOPS,
                4 * 3 * B * N + B * (np1 + np2) * (4 + 12))


def ball_query_work(packed: bool, B: int, N: int, M: int, S: int,
                    emit_idx: bool, scanned: int) -> Work:
    """A grouped ball query: B clouds of N points, M queries of S slots,
    which examine `scanned` (query, point) pairs in all; it writes
    (B, M, S, 3) f32 offsets, cnt and, with emit_idx, idx."""
    point_flops = NORM_FLOPS + (QUANT_FLOPS if packed else 0)
    flops = scanned * PAIR_FLOPS + B * N * point_flops + B * M * NORM_FLOPS
    inputs = 4 * 3 * (B * N + B * M)
    grouped = 4 * 3 * B * M * S + 4 * B * M
    return Work(flops, inputs + grouped + (4 * B * M * S if emit_idx else 0))


def three_nn_work(B: int, N: int, M: int) -> Work:
    return Work(B * N * M * NN_PAIR_FLOPS + B * (N + M) * NORM_FLOPS,
                4 * 3 * (B * N + B * M) + 2 * 4 * 3 * B * N)


def scanned_points(idx: torch.Tensor, cnt: torch.Tensor, N: int
                   ) -> Tuple[int, int]:
    """Points a first-S ball query examines for these hits: each query's
    cloud up to its S-th hit, all of it when it has fewer.  (sum, max)."""
    S = idx.shape[-1]
    n = torch.where(cnt >= S, idx[..., -1].long() + 1, N)
    return int(n.sum()), int(n.max())
