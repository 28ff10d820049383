"""The GEMM FLOPs of ANCSH on MinkUNet34C, from a configuration's widths
and what one forward held (`work_minkunet.convolutions`, from the
backbone's counters) and the B·N input points the heads answer:
2·C_in·C_out a (output, input) pair of each convolution, and the
heads' pointwise layers at their rows.  The grid, the clusters, the
maps, gathers, batch norm, ReLU and the pose fit are no model FLOPs."""

from __future__ import annotations

from typing import Dict

from posebench.metrics.flops_ptv3 import heads_flops
from posebench.metrics.work_minkunet import convolutions


def forward_flops(widths: Dict, K: int, counters: Dict, points: int) -> int:
    """The FLOPs of one forward from its counters (`level_points`,
    `conv_pairs`, `stem_pairs`)."""
    return (sum(2 * c.pairs * c.cin * c.cout
                for c in convolutions(widths, counters))
            + heads_flops(widths["planes"][-1], K, points))
