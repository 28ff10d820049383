"""Reference (TF1) checkpoint ingestion: counterpart of
`articulated_pose_tpu/utils/tf_ckpt.py`, onto a port state_dict.

Maps the reference's variable naming (scopes like
`SPFN/est_net/layer1/conv0/weights`, `.../bn/...`,
`SPFN/nocs_net/fc2_0/...`, `SPFN/joint_net/fc3_0/...`; see
lib/architecture.py:86-208, pointnet_plusplus/architectures.py:56-95,
tf_util.py conv scopes) onto the port's model in two steps:

    TF name --(_RULES, _LEAF_MAP: JAX's map, copied)--> Flax path
            --(convert.state_dict_from_flax)-->          port name

A TF kernel (1, 1, Cin, Cout) is cut to the Flax layout (Cin, Cout) here
(`_convert_kernel`); `convert.state_dict_from_flax` keeps the transpose
to the port's `dense.weight` (Cout, Cin), as it does for every JAX
checkpoint.

The checkpoint is an `.npz` export ({var_name: array}) or a TF1 bundle
prefix, read by the pure-NumPy `utils/tf_bundle.py`; TensorFlow is not
needed.  An `.npz` is made anywhere TF is installed with:

    import tensorflow as tf, numpy as np
    r = tf.train.load_checkpoint(path)
    np.savez("ckpt.npz", **{k: r.get_tensor(k)
                            for k in r.get_variable_to_shape_map()})
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch.convert import state_dict_from_flax

# (tf scope regex) -> (flax path template) ; \g<n> backrefs carry indices
_RULES: Tuple[Tuple[str, str], ...] = (
    # SA stages: the global stage (layer3) must match before layer[12]
    (r"SPFN/est_net/layer3/conv(\d)",
     r"backbone/sa_global/mlp/conv\1"),
    (r"SPFN/est_net/layer([12])/conv(\d)",
     r"backbone/sa\1/mlp/conv\2"),
    # FP stages
    (r"SPFN/est_net/fa_layer(\d)/conv_(\d)",
     r"backbone/fp\1/mlp/conv\2"),
    # FC head
    (r"SPFN/est_net/fc1",
     r"backbone/fc1"),
    # output heads
    (r"SPFN/nocs_net/fc11_(\d)",
     r"fc11_\1"),
    (r"SPFN/nocs_net/fc2_(\d)",
     r"fc2_\1"),
    # joint head
    (r"SPFN/joint_net/fc3_(\d)",
     r"joint_net/fc3_\1"),
    (r"SPFN/joint_net/fc4_(\d)",
     r"joint_net/fc4_\1"),
)

_LEAF_MAP = {
    "weights": ("dense", "kernel"),
    "biases": ("dense", "bias"),
    "bn/gamma": ("bn", "scale"),
    "bn/beta": ("bn", "bias"),
    "bn/moving_mean": ("bn", "mean"),      # batch_stats collection
    "bn/moving_variance": ("bn", "var"),   # batch_stats collection
}


def map_var_name(tf_name: str) -> Optional[Tuple[Tuple[str, ...], bool]]:
    """TF variable name -> (flax path tuple, is_batch_stat) or None, as
    JAX's map_var_name (tf_ckpt.py:63)."""
    tf_name = tf_name.strip("/")
    for leaf_tf, (sub, leaf) in sorted(_LEAF_MAP.items(),
                                       key=lambda kv: -len(kv[0])):
        if tf_name.endswith("/" + leaf_tf):
            scope = tf_name[: -len(leaf_tf) - 1]
            for pat, repl in _RULES:
                if re.fullmatch(pat, scope):
                    flax_scope = re.sub(pat, repl, scope)
                    is_stat = leaf in ("mean", "var")
                    path = tuple(flax_scope.split("/")) + (sub, leaf)
                    return path, is_stat
            return None
    return None


def _convert_kernel(arr: np.ndarray) -> np.ndarray:
    """TF conv kernels (1, 1, Cin, Cout) / (1, Cin, Cout) -> Dense (Cin, Cout)."""
    if arr.ndim == 4 and arr.shape[0] == 1 and arr.shape[1] == 1:
        return arr[0, 0]
    if arr.ndim == 3 and arr.shape[0] == 1:
        return arr[0]
    return arr


def load_reference_weights(ckpt_path: str,
                           state_dict: Mapping[str, torch.Tensor]):
    """Overlay reference weights onto a port state_dict (tf_ckpt.py:89).

    `ckpt_path` is an `.npz` export, a bundle prefix
    (`.../tf_model.ckpt-<step>`, with `.index` and `.data-*` files next
    to it) or that prefix ending in `.index`.  Returns (new_state_dict,
    report): the new dict holds a copy of every entry, the mapped ones
    replaced (in the entry's dtype, on its device); report lists the
    "mapped", "unmapped" and "mismatched" (name, expected shape,
    checkpoint shape) variables, with shapes in the Flax layout, as
    JAX's does.  Adam slots, `global_step` and `Variable` are skipped.
    """
    if ckpt_path.endswith(".npz"):
        with np.load(ckpt_path) as f:
            raw = {k: f[k] for k in f.files}
    else:
        from articulated_pose_tpu_torch.utils.tf_bundle import read_bundle

        prefix = (ckpt_path[: -len(".index")]
                  if ckpt_path.endswith(".index") else ckpt_path)
        if not os.path.exists(prefix + ".index"):
            raise FileNotFoundError(
                f"{ckpt_path}: neither an .npz export nor a checkpoint "
                f"bundle prefix ({prefix}.index missing)")
        raw = read_bundle(prefix)
    out = {k: v.clone() for k, v in state_dict.items()}
    mapped, unmapped, mismatched = [], [], []
    for name, arr in raw.items():
        if (name.endswith(("/Adam", "/Adam_1"))
                or name in ("global_step", "Variable")):
            continue
        hit = map_var_name(name)
        if hit is None:
            unmapped.append(name)
            continue
        path, is_stat = hit
        arr = _convert_kernel(np.asarray(arr))
        key = "/".join(("batch_stats" if is_stat else "params",) + path)
        ((target, value),) = state_dict_from_flax({key: arr}).items()
        if target not in out:
            unmapped.append(name)
            continue
        if out[target].shape != value.shape:
            want = tuple(out[target].shape)
            if target.endswith("dense.weight"):
                want = want[::-1]
            mismatched.append((name, want, arr.shape))
            continue
        out[target] = value.to(dtype=out[target].dtype,
                               device=out[target].device)
        mapped.append(name)
    report = {"mapped": mapped, "unmapped": unmapped,
              "mismatched": mismatched}
    return out, report
