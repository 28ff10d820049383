"""Prediction I/O: per-frame HDF5 dumps in the reference schema; a copy
of `articulated_pose_tpu/utils/prediction_io.py`, so that a file written
by either package reads back equal in the other.

Writes one .h5 per frame with the keys the reference eval scripts read
(reference: lib/prediction_io.py:65-95 `save_batch_nn`), so saved
predictions stay cross-checkable with the reference evaluation suite:

  P, cls_gt, nocs_gt [, nocs_gt_g], instance_per_point (W),
  nocs_per_point [, gocs_per_point], confidence,
  heatmap_per_point/gt, unitvec_per_point/gt, joint_axis_per_point,
  orient_gt, index_per_point, joint_cls_gt

h5py is imported at the call, not with the module: a host without it
(a GPU host may have none) imports the module and raises ImportError only
when it reads or writes a file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

# (output key, prediction key) pairs; W keeps the reference's legacy name
_PRED_KEYS = [
    ("instance_per_point", "W"),
    ("nocs_per_point", "nocs_per_point"),
    ("gocs_per_point", "gocs_per_point"),
    ("confidence", "confi_per_point"),
    ("heatmap_per_point", "heatmap_per_point"),
    ("unitvec_per_point", "unitvec_per_point"),
    ("joint_axis_per_point", "joint_axis_per_point"),
    ("index_per_point", "index_per_point"),
]
_GT_KEYS = [
    ("P", "P"),
    ("cls_gt", "cls_gt"),
    ("nocs_gt", "nocs_gt"),
    ("nocs_gt_g", "nocs_gt_g"),
    ("heatmap_gt", "heatmap_gt"),
    ("unitvec_gt", "unitvec_gt"),
    ("orient_gt", "orient_gt"),
    ("joint_cls_gt", "joint_cls_gt"),
    # real-data (BMVC15) normalization metadata so offline eval can
    # denormalize poses back to metric camera space
    # (lib/prediction_io.py:97-129 save_batch_nn_real)
    ("P_center", "P_center"),
    ("P_scale", "P_scale"),
]


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("h5py is required for prediction I/O") from None
    return h5py


def save_batch_predictions(pred: Dict[str, np.ndarray],
                           batch: Dict[str, np.ndarray],
                           basenames: Sequence[str], save_dir: str) -> List[str]:
    """One h5 per frame (lib/prediction_io.py:65-95). Returns paths."""
    h5py = _h5py()
    os.makedirs(save_dir, exist_ok=True)
    B = len(basenames)
    paths = []
    for i in range(B):
        path = os.path.join(save_dir, f"{basenames[i]}.h5")
        with h5py.File(path, "w") as f:
            for out_key, k in _PRED_KEYS:
                if k in pred:
                    _write(f, out_key, pred[k][i])
            for out_key, k in _GT_KEYS:
                if k in batch:
                    _write(f, out_key, batch[k][i])
        paths.append(path)
    return paths


def _write(f, key: str, value) -> None:
    """One dataset, gzip level 4 as the reference writes them.  A scalar
    (a frame's P_scale) is written uncompressed: h5py refuses filters on
    scalar datasets, where JAX's writer raises TypeError."""
    data = np.asarray(value)
    kw = dict(compression="gzip", compression_opts=4) if data.ndim else {}
    f.create_dataset(key, data=data, **kw)


def load_prediction(path: str) -> Dict[str, np.ndarray]:
    h5py = _h5py()
    out = {}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            out[k] = f[k][()]
    return out
