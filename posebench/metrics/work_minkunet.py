"""The work of MinkUNet's convolutions in one forward, from a
configuration's widths and what the forward held (the backbone's
counters: `level_points`, the voxels at each stride; `conv_pairs`, each
stride's (voxel, offset) pairs present in its 3³ map; `stem_pairs`),
whatever implements them.

A convolution's pairs are the (output, input) products it needs: a
submanifold one its map's pairs present, a strided one each finer
voxel once (a voxel is one child of one parent), a transposed one each
finer voxel once (it reads its one parent), a projection each voxel
once.  Its floor is the larger of 2·pairs·C_in·C_out FLOPs at the
card's bf16 peak and its input rows, output rows and weights moved once
in bf16 at its HBM rate.

The spans that hold the convolutions (`models/minkunet.py`): the
stem's, each down's and up's, and each block's `.c1`, `.c2` and
`.proj`, each holding its gather and product only; the maps' spans end
in `.map`."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from posebench.metrics.flops import BF16_PEAK_FLOPS, HBM_BYTES_PER_S

BYTES = 2          # bf16
STEM_TAPS = 5 ** 3


class Conv(NamedTuple):
    name: str
    pairs: int
    cin: int
    cout: int
    rows_in: int
    rows_out: int
    taps: int


def is_conv_span(name: str) -> bool:
    return (name == "minkunet.stem"
            or name.startswith(("minkunet.down", "minkunet.up"))
            or name.endswith((".c1", ".c2", ".proj")))


def is_map_span(name: str) -> bool:
    return name.startswith("minkunet.") and name.endswith(".map")


def convolutions(widths: Dict, counters: Dict) -> List[Conv]:
    """Every convolution of one forward, as ME threads its widths."""
    P, layers, init = widths["planes"], widths["layers"], widths["init_dim"]
    D = len(P) // 2
    n, pairs = counters["level_points"], counters["conv_pairs"]
    out = [Conv("stem", counters["stem_pairs"], 3, init, n[0], n[0],
                STEM_TAPS)]

    def blocks(stage: str, l: int, cin: int, width: int, count: int):
        for j in range(count):
            c = cin if j == 0 else width
            out.append(Conv(f"{stage}.b{j}.c1", pairs[l], c, width, n[l],
                            n[l], 27))
            out.append(Conv(f"{stage}.b{j}.c2", pairs[l], width, width, n[l],
                            n[l], 27))
            if c != width:
                out.append(Conv(f"{stage}.b{j}.proj", n[l], c, width, n[l],
                                n[l], 1))

    inplanes = init
    for s in range(1, D + 1):
        out.append(Conv(f"down{s}", n[s - 1], inplanes, inplanes, n[s - 1],
                        n[s], 8))
        blocks(f"e{s}", s, inplanes, P[s - 1], layers[s - 1])
        inplanes = P[s - 1]
    for j in range(1, D + 1):
        l = D - j
        w = P[D + j - 1]
        skip = P[l - 1] if l >= 1 else init
        out.append(Conv(f"up{j}", n[l], inplanes, w, n[l + 1], n[l], 8))
        blocks(f"d{j}", l, w + skip, w, layers[D + j - 1])
        inplanes = w
    return out


def conv_floor_us(c: Conv) -> float:
    moved = BYTES * (c.rows_in * c.cin + c.rows_out * c.cout
                     + c.taps * c.cin * c.cout)
    return 1e6 * max(2.0 * c.pairs * c.cin * c.cout / BF16_PEAK_FLOPS,
                     moved / HBM_BYTES_PER_S)


def forward_floor_us(widths: Dict, counters: Dict) -> float:
    """The floor of one forward's convolutions."""
    return sum(conv_floor_us(c) for c in convolutions(widths, counters))
