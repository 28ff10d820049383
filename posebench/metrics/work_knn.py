"""The work of the port's `knn` kernel entry (`csrc/knn.cu`) and its
floor at the published peaks: (query, candidate) pairs × 9 f32
operations (inner product, norms, difference, clamp) at 67 TFLOP/s,
against the inputs read once and the outputs written once at 3.35 TB/s.
Also the floor of the same forward's FPS and 3-NN kernels, by
`work.py`'s arithmetic (`point_kernels_floor_us`).  Computed from shapes,
never from what the kernels launch."""

from __future__ import annotations

from typing import Dict, List, Tuple

from posebench.metrics.work import FPS_FLOPS, PAIR_FLOPS, Work, three_nn_work

# the kernel's symbol as a trace names it
KNN_SYMBOLS = ("knn_kernel",)


def knn_work(B: int, M: int, N: int, k: int) -> Work:
    """M queries against N candidates in each of B clouds, k kept: reads
    both clouds' xyz, writes (B, M, k) f32 distances and int32 indices."""
    return Work(B * M * N * PAIR_FLOPS,
                4 * 3 * B * (N + M) + 2 * 4 * B * M * k)


def searches(widths: Dict, N: int) -> List[Tuple[int, int, int]]:
    """(M, N, k) of each k-NN search of one Point Transformer forward
    over N-point clouds: every level's self search and every transition
    down's (the sampled points against the level above)."""
    out, n = [], N
    for i, k in enumerate(widths["nsample"]):
        if i:
            m = n // widths["stride"]
            out.append((m, n, k))
            n = m
        out.append((n, n, k))
    return out


def forward_floor_us(widths: Dict, B: int, N: int) -> float:
    """Σ over one forward's searches of each launch's floor."""
    return sum(knn_work(B, m, n, k).floor_us()
               for m, n, k in searches(widths, N))


def forward_pairs(widths: Dict, B: int, N: int) -> int:
    return sum(B * m * n for m, n, _ in searches(widths, N))


def fps_work(B: int, N: int, npoint: int) -> Work:
    """A single-level FPS (`fps`, B2): N -> npoint, one step a pick past
    the first; writes npoint indices and xyz."""
    return Work(B * (min(npoint, N) - 1) * N * FPS_FLOPS,
                4 * 3 * B * N + B * npoint * (4 + 12))


def point_kernels_floor_us(widths: Dict, B: int, N: int) -> float:
    """Σ the floors of one forward's FPS launches (each transition
    down's n -> n / stride) and 3-NN launches (each transition up's
    finer level against the coarser), as `serve.kernel_roofline` reads
    them."""
    sizes = [N]
    for _ in widths["nsample"][1:]:
        sizes.append(sizes[-1] // widths["stride"])
    fine_coarse = list(zip(sizes[:-1], sizes[1:]))
    return (sum(fps_work(B, n, m).floor_us() for n, m in fine_coarse)
            + sum(three_nn_work(B, n, m).floor_us() for n, m in fine_coarse))
