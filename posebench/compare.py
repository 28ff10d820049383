"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the plain reference computes from the same
inputs.  Pure functions of arrays, so the CPU tests hold them too.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# the served heads the comparison covers (NAOCS is gocs_per_point)
HEADS = ("W", "nocs_per_point", "confi_per_point", "gocs_per_point",
         "heatmap_per_point", "unitvec_per_point", "joint_axis_per_point",
         "index_per_point")
# the percentile of a cloud's values that `cloud_gaps` reads
HEADS_PERCENTILE = 95.0


def cloud_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
               q: float = HEADS_PERCENTILE) -> np.ndarray:
    """(heads, clouds): for each head and each cloud of the batch, the
    `q`-th percentile, over that head's values in the cloud, of
    |prog − ref| over the head's RMS in the cloud.  A NaN reads inf."""
    out = []
    for k in HEADS:
        p = np.asarray(prog[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        p, r = p.reshape(len(r), -1), r.reshape(len(r), -1)
        rms = np.sqrt((r ** 2).mean(axis=1, keepdims=True))
        rel = np.abs(p - r) / np.maximum(rms, 1e-30)
        out.append(np.nan_to_num(np.percentile(rel, q, axis=1), nan=np.inf))
    return np.stack(out)


def heads_ratio(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                lower: Dict[str, np.ndarray]) -> float:
    """The worst (head, cloud) of the program's `cloud_gaps` from the
    float32 reference `ref`, each in units of the same reading of
    `lower`, the reference computed in the configuration's own rounding
    (bf16): how far rounding moves the heads differs from seed to seed
    and from cloud to cloud, and the ratio leaves that out.  A cloud
    whose reading of `lower` is under a tenth of its head's median over
    the batch is read against that tenth.

    Taken cloud by cloud and at a high percentile of each cloud's
    values, it reads one wrong cloud in the batch, or a wrong share of
    the points of every cloud above 100 − q percent, at the wrong
    values' scale; rounding moves every value a little and leaves it
    near 1, and a lower precision moves the whole distribution up."""
    g = cloud_gaps(prog, ref)
    s = cloud_gaps(lower, ref)
    s = np.maximum(s, 0.1 * np.median(s, axis=1, keepdims=True))
    return float(np.nan_to_num((g / np.maximum(s, 1e-30)).max(), nan=np.inf))


def fit_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> float:
    """The widest gap of the fitted part poses: the largest of |ΔR| (an
    entry of a rotation), |Δs| / |s| and |Δt| (a coordinate, in units
    of the cloud) over every cloud and part."""
    dR = np.abs(np.asarray(prog["R"], np.float64) - ref["R"]).max()
    ds = (np.abs(np.asarray(prog["s"], np.float64) - ref["s"])
          / np.maximum(np.abs(ref["s"]), 1e-12)).max()
    dt = np.abs(np.asarray(prog["t"], np.float64) - ref["t"]).max()
    return float(np.nan_to_num(max(dR, ds, dt), nan=np.inf))


def counts_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The largest difference of a part's point count (exact)."""
    return float(np.abs(np.asarray(prog, np.int64)
                        - np.asarray(ref, np.int64)).max())


def norms(leaves: Sequence) -> np.ndarray:
    return np.array([float(np.linalg.norm(np.asarray(x, np.float64)))
                     for x in leaves])


def kept_leaves(ref_grads: Sequence, share: float = 1e-3) -> List[bool]:
    """The leaves that count: those whose reference gradient is not
    nought to rounding, i.e. not under `share` of the median leaf's
    norm (a bias before batch norm has gradient 0, and Adam moves it by
    round-off alone)."""
    n = norms(ref_grads)
    return list(n >= share * np.median(n))


def leaf_gap(prog: Sequence, ref: Sequence, kept: Sequence[bool]) -> float:
    """The worst kept leaf's gap of norms: |‖prog‖ − ‖ref‖| over the
    larger of ‖ref‖ and the median kept leaf's ‖ref‖."""
    p, r = norms(prog), norms(ref)
    k = np.asarray(kept)
    med = np.median(r[k])
    gap = np.abs(p - r) / np.maximum(r, med)
    return float(np.nan_to_num(gap[k].max(), nan=np.inf))


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    return float(np.nan_to_num((np.abs(p - r) / np.abs(r)).max(),
                               nan=np.inf))
