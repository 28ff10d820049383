"""The analytic GEMM FLOPs of ANCSH on the Point Transformer backbone,
from a configuration's widths, B and N: 2·rows·c_in·c_out for every
Linear, at the rows it runs on.  The attention's position encoding θ
and weight encoding γ run on (n, k) rows, one a (point, neighbour)
pair; everything else on n rows.  Only matrix products count: the
k-NN, FPS, 3-NN, gathers, softmax, batch norm and the pose fit are no
model FLOPs."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _block(n: int, k: int, C: int, s: int) -> int:
    """One block: linear1 and linear3 (C×C), q, k, v (C×C) on n rows; θ
    (3×3, 3×C) and γ (C×C/s, C/s×C/s) on n·k rows."""
    per_point = 2 * n * C * C * 5
    theta = 2 * n * k * (3 * 3 + 3 * C)
    gamma = 2 * n * k * (C * (C // s) + (C // s) ** 2)
    return per_point + theta + gamma


def layer_flops(widths: Dict, K: int, B: int, N: int
                ) -> List[Tuple[str, int]]:
    planes, blocks, ks = widths["planes"], widths["blocks"], widths["nsample"]
    s, stride = widths["share"], widths["stride"]
    sizes = [N]
    for _ in planes[1:]:
        sizes.append(sizes[-1] // stride)
    out = []
    for i, (C, nb, k, n) in enumerate(zip(planes, blocks, ks, sizes)):
        td = (2 * n * 3 * C if i == 0
              else 2 * n * k * (3 + planes[i - 1]) * C)
        out.append((f"enc{i + 1}.td", B * td))
        out.append((f"enc{i + 1}.blocks", B * nb * _block(n, k, C, s)))
    L = len(planes)
    for i in reversed(range(L)):
        C, n, k = planes[i], sizes[i], ks[i]
        if i == L - 1:
            up = 2 * C * C + 2 * n * 2 * C * C
        else:
            up = 2 * n * C * C + 2 * sizes[i + 1] * planes[i + 1] * C
        out.append((f"dec{i + 1}.up", B * up))
        out.append((f"dec{i + 1}.blocks", B * _block(n, k, C, s)))
    hw = planes[0]
    rows = B * N
    out.append(("seg", 2 * rows * hw * hw))
    out.append(("heads", 2 * rows * hw * (K + K + 3 * K + 1)
                + 2 * rows * (hw * 128 + 128 * 3 * K)))
    out.append(("joint_head",
                2 * rows * (hw * 128 + 128 * 128 + 128 * (3 + 3 + 1 + K))))
    return out


def forward_flops(widths: Dict, K: int, B: int, N: int) -> int:
    return sum(f for _, f in layer_flops(widths, K, B, N))
