"""The analytic GEMM FLOPs of the ANCSH forward, from a configuration's
widths, B and N: 2·rows·c_in·c_out for every pointwise layer, at the
rows it runs on.  Only matrix products count: the pose fit's arithmetic,
the ball query, FPS, 3-NN, batch norm and the activations are no model
FLOPs.  A training step is counted as 3× its forward (forward, and the
backward's two products a layer).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
BF16_PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _mlp(rows: int, cin: int, channels: Iterable[int]) -> Tuple[int, int]:
    flops = 0
    for c in channels:
        flops += 2 * rows * cin * c
        cin = c
    return flops, cin


def layer_flops(widths: Dict, K: int, B: int, N: int) -> List[Tuple[str, int]]:
    """(layer, FLOPs) of one forward over B clouds of N points, for a
    PointNet++ pyramid of any depth (no input features) and ANCSH's
    heads: part, part-NOCS (with its private 128-wide branch), global
    scale, global translation, confidence, and the joint head."""
    out = []
    n, feat, levels = N, 0, [(N, 3)]
    for i, (m, S, mlp) in enumerate(zip(widths["sa_npoints"],
                                        widths["sa_nsamples"],
                                        widths["sa_mlps"])):
        f, feat = _mlp(B * m * S, 3 + feat, mlp)
        out.append((f"sa{i + 1}", f))
        n = m
        levels.append((m, feat))
    f, feat = _mlp(B * n, 3 + feat, widths["global_mlp"])
    out.append(("sa_global", f))
    # FP i interpolates onto level L - i and concatenates its skip
    skips = [c for _, c in levels[:0:-1]] + [3]
    rows = [m for m, _ in levels[::-1]]
    for i, (mlp, skip, r) in enumerate(zip(widths["fp_mlps"], skips, rows)):
        f, feat = _mlp(B * r, feat + skip, mlp)
        out.append((f"fp{i + 1}", f))
    hw = widths["head_width"]
    rows = B * N
    out.append(("fc1", 2 * rows * feat * hw))
    heads = (2 * rows * hw * (K + K + 3 * K + 1)       # part, scale, trans, conf
             + 2 * rows * (hw * 128 + 128 * 3 * K))    # part-NOCS branch
    joint = 2 * rows * (hw * 128 + 128 * 128 + 128 * (3 + 3 + 1 + K))
    out.append(("heads", heads))
    out.append(("joint_head", joint))
    return out


def forward_flops(widths: Dict, K: int, B: int, N: int) -> int:
    return sum(f for _, f in layer_flops(widths, K, B, N))
