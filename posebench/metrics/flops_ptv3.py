"""The GEMM and attention FLOPs of ANCSH on Point Transformer V3, from a
configuration's widths and what one forward held: each level's voxels,
its sequences' lengths, its neighbour pairs present (`cpe_pairs`) and
the stem's, and the B·N input points the heads answer.  2·rows·c_in·
c_out for every Linear at the rows it runs on; a submanifold
convolution 2·c_in·c_out a (voxel, neighbour) pair present; an
attention 4·L²·C a sequence of L (q kᵀ and the weighted sum, every head
together).  The grid, the codes, the sorts, the maps, gathers, norms,
GELU, the softmax and the pose fit are no model FLOPs."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def _block(n: int, C: int, pairs: int, seqs: Sequence[int],
           mlp_ratio: int) -> int:
    """One block: the xCPE's convolution and Linear, qkv, the
    projection and the MLP on n rows, the attention of each sequence."""
    return (2 * pairs * C * C
            + 2 * n * C * C * (1 + 3 + 1 + 2 * mlp_ratio)
            + sum(4 * L * L * C for L in seqs))


def heads_flops(hw: int, K: int, rows: int) -> int:
    """ANCSH's heads and joint head on `rows` points of width hw."""
    return (2 * rows * hw * (K + K + 3 * K + 1)
            + 2 * rows * (hw * 128 + 128 * 3 * K)
            + 2 * rows * (hw * 128 + 128 * 128 + 128 * (3 + 3 + 1 + K)))


def layer_flops(widths: Dict, K: int, level_points: Sequence[int],
                sequences: Sequence[Sequence[int]],
                cpe_pairs: Sequence[int], stem_pairs: int, points: int
                ) -> List[Tuple[str, int]]:
    enc, mr = widths["enc_channels"], widths["mlp_ratio"]
    outs = list(widths["dec_channels"]) + [enc[-1]]
    n = level_points
    out = [("stem", 2 * stem_pairs * 3 * enc[0])]
    for l in range(len(enc)):
        if l:
            out.append((f"e{l}.pool", 2 * n[l - 1] * enc[l - 1] * enc[l]))
        out.append((f"e{l}.blocks", widths["enc_depths"][l] * _block(
            n[l], enc[l], cpe_pairs[l], sequences[l], mr)))
    for l in reversed(range(len(enc) - 1)):
        out.append((f"d{l}.unpool", 2 * n[l + 1] * outs[l + 1] * outs[l]
                    + 2 * n[l] * enc[l] * outs[l]))
        out.append((f"d{l}.blocks", widths["dec_depths"][l] * _block(
            n[l], outs[l], cpe_pairs[l], sequences[l], mr)))
    out.append(("heads", heads_flops(outs[0], K, points)))
    return out


def forward_flops(widths: Dict, K: int, counters: Dict, points: int) -> int:
    """The FLOPs of one forward from its counters (`level_points`,
    `sequences`, `cpe_pairs`, `stem_pairs`)."""
    return sum(f for _, f in layer_flops(
        widths, K, counters["level_points"], counters["sequences"],
        counters["cpe_pairs"], counters["stem_pairs"], points))
