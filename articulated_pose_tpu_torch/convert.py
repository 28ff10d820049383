"""Weight bridge: Flax variables of the JAX model -> a port state_dict.

The JAX side flattens its `{"params": ..., "batch_stats": ...}` tree to
"/"-joined keys and saves it with `np.savez`; this module reads that
mapping without JAX.  The port's module names follow the Flax tree, so
the mapping is by name:

    params/<path>/dense/kernel (Cin, Cout) -> <path>.dense.weight (Cout, Cin)
    params/<path>/dense/bias               -> <path>.dense.bias
    params/<path>/bn/scale | bias          -> <path>.bn.weight | bias
    batch_stats/<path>/bn/mean | var       -> <path>.bn.running_mean | running_var

`flax_tree` is the way back (parameters, their gradients or the running
statistics): the port's named tensors as a Flax tree, under JAX's names.
`train_state_from_optax` carries a JAX train state across as well: the
optax Adam moments and count and the step, so a run stopped mid-training
continues in the port.  `joint_regression_state_dict_from_flax` does the
same mapping for the joint-regression baseline's nested variables.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

_LEAVES = {
    ("params", "dense", "kernel"): "dense.weight",
    ("params", "dense", "bias"): "dense.bias",
    ("params", "bn", "scale"): "bn.weight",
    ("params", "bn", "bias"): "bn.bias",
    ("batch_stats", "bn", "mean"): "bn.running_mean",
    ("batch_stats", "bn", "var"): "bn.running_var",
}


def state_dict_from_flax(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Flattened Flax variables -> state_dict of the matching port model."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        leaf = _LEAVES.get((parts[0], parts[-2], parts[-1]))
        if leaf is None:
            raise KeyError(f"unexpected Flax variable {key!r}")
        arr = np.asarray(value, np.float32)
        if leaf == "dense.weight":
            arr = arr.T
        out[".".join(parts[1:-2] + [leaf])] = torch.tensor(arr)
    return out


def flax_tree(named: Iterable[Tuple[str, torch.Tensor]],
              collection: str = "params") -> Dict:
    """(port name, tensor) pairs of one Flax collection ("params", or
    "batch_stats" for the running statistics) -> the nested Flax tree
    they come from, float64 numpy leaves under JAX's names: the inverse
    of `state_dict_from_flax` (backbone.sa1.mlp.conv0.dense.weight
    (Cout, Cin) -> ["backbone"]["sa1"]["mlp"]["conv0"]["dense"]["kernel"]
    (Cin, Cout)).  Takes gradients as well as parameters."""
    leaves = {port: flax[1:] for flax, port in _LEAVES.items()
              if flax[0] == collection}
    tree: Dict = {}
    for name, value in named:
        parts = name.split(".")
        leaf = leaves.get(".".join(parts[-2:]))
        if leaf is None:
            raise KeyError(f"unexpected {collection} entry {name!r}")
        arr = value.detach().cpu().double().numpy()
        if leaf == ("dense", "kernel"):
            arr = arr.T
        node = tree
        for p in parts[:-2] + [leaf[0]]:
            node = node.setdefault(p, {})
        node[leaf[1]] = arr
    return tree


def _flatten(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flatten(v, key) if isinstance(v, Mapping)
                   else {key: v})
    return out


def joint_regression_state_dict_from_flax(params: Mapping,
                                          batch_stats: Mapping
                                          ) -> Dict[str, torch.Tensor]:
    """The nested Flax params and batch stats of JAX's
    `DirectJointRegression` (numpy leaves, e.g. from `jax.device_get`)
    -> the state_dict of the port's `models.joint_regression.
    DirectJointRegression`: backbone/sa1/mlp/conv0/dense/kernel ->
    backbone.sa1.mlp.conv0.dense.weight, fc3_0/dense/bias -> fc3_0.dense.bias,
    and so on by `state_dict_from_flax`'s leaf rules."""
    return state_dict_from_flax({**_flatten(params, "params"),
                                 **_flatten(batch_stats, "batch_stats")})


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """state_dict from an `np.savez` of the flattened Flax variables."""
    with np.load(path) as f:
        return state_dict_from_flax({k: f[k] for k in f.files})


def train_state_from_optax(flat: Mapping[str, np.ndarray]) -> Dict:
    """A JAX `TrainState`, flattened to "/"-joined keys of numpy arrays,
    -> `train.state.TrainState.state_dict()` of the port.

    The keys are "params/...", "batch_stats/..." (the model, as
    `state_dict_from_flax` reads them), "mu/..." and "nu/..." (Adam's
    moments, on the params' paths), "count" (Adam's count) and "step".
    From a JAX state `s` whose optimizer is `apply_if_finite(adam(...))`:

        adam = s.opt_state.inner_state[0]
        flax.traverse_util.flatten_dict(
            {"params": s.params, "batch_stats": s.batch_stats,
             "mu": adam.mu, "nu": adam.nu, "count": adam.count,
             "step": s.step}, sep="/")
    """
    groups: Dict[str, Dict[str, np.ndarray]] = {"model": {}, "mu": {},
                                                 "nu": {}}
    for key, value in flat.items():
        head, _, rest = key.partition("/")
        if head in ("params", "batch_stats"):
            groups["model"][key] = value
        elif head in ("mu", "nu") and rest:
            groups[head]["params/" + rest] = value
        elif key not in ("count", "step"):
            raise KeyError(f"unexpected train-state variable {key!r}")
    out = {name: state_dict_from_flax(g) for name, g in groups.items()}
    for key in ("count", "step"):
        out[key] = torch.tensor(int(np.asarray(flat[key])), dtype=torch.int32)
    return out
