"""Export a JAX training run for the PyTorch port.

    python scripts/export_jax_checkpoint.py --work_dir runs/eyeglasses \
        --out eyeglasses.npz [--train_state eyeglasses_state.npz] \
        [--step 30000] [--item eyeglasses] [--nocs_type ancsh] \
        [--backbone reference] [--config cfg/network_config.yml]

Runs where JAX, Flax and Orbax are installed.  It restores the newest
(or `--step`) Orbax snapshot of `<work_dir>/model/` through the JAX
package's own `train.trainer.Checkpointer`, into a `TrainState` template
built by the JAX package's model and optimizer (`train/state.py`) from
the run's configuration: the same `--config`, `--item`, `--nocs_type`
and `--backbone` the run was trained with, mapped as `main.py` maps them.
It writes:

- `--out`: the model's variables flattened to "/"-joined keys
  ("params/...", "batch_stats/..."), the npz that
  `articulated_pose_tpu_torch.convert.load_flax_npz` turns into a port
  state_dict (`torch.save` it for `PosePredictor(ckpt_path=...)`);
- `--train_state` (optional): the same plus Adam's "mu/...", "nu/...",
  "count" (of `opt_state.inner_state[0]`, inside `apply_if_finite`) and
  "step", the npz that `convert.train_state_from_optax` reads, so a run
  continues in the port (`train.state.TrainState.load_state_dict`).

`main(argv)` returns 0 and prints the step exported and the files.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work_dir", required=True,
                    help="the JAX run's work dir (its snapshots in model/)")
    ap.add_argument("--out", required=True,
                    help="npz of the model's variables (load_flax_npz)")
    ap.add_argument("--train_state", default=None,
                    help="npz of the train state (train_state_from_optax)")
    ap.add_argument("--step", type=int, default=None,
                    help="the snapshot to export (default: the newest)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--item", default="eyeglasses")
    ap.add_argument("--nocs_type", default="ancsh", choices=["ancsh", "npcs"])
    ap.add_argument("--backbone", default="reference",
                    choices=["reference", "tiny"])
    return ap.parse_args(argv)


def run_config(args):
    """The run's NetworkConfig, as main.py's build_config makes it."""
    from articulated_pose_tpu.config import load_config
    from articulated_pose_tpu.registry import get_category

    overrides = {"category": args.item, "nocs_type": args.nocs_type,
                 "n_max_parts": get_category(args.item).num_parts}
    if args.backbone != "reference":
        overrides["backbone_preset"] = args.backbone
    return load_config(args.config, **overrides)


def restore_state(work_dir: str, cfg, step: Optional[int] = None):
    """The JAX TrainState of snapshot `step` (default newest) of a run."""
    import jax

    from articulated_pose_tpu.models.ancsh import build_model
    from articulated_pose_tpu.train.state import create_train_state
    from articulated_pose_tpu.train.trainer import Checkpointer

    model = build_model(cfg)
    template = create_train_state(
        model, cfg, jax.random.PRNGKey(0),
        np.zeros((1, cfg.num_points, 3), np.float32))
    ckpt = Checkpointer(os.path.join(work_dir, "model"))
    step = step if step is not None else ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no Orbax snapshot in {ckpt.model_dir}")
    return ckpt.restore(template, step)


def flatten(tree) -> Dict[str, np.ndarray]:
    """A pytree of arrays -> {"/"-joined path: numpy array}."""
    import jax
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(tree), sep="/").items()}


def model_variables(state) -> Dict[str, np.ndarray]:
    return flatten({"params": state.params, "batch_stats": state.batch_stats})


def train_state_variables(state) -> Dict[str, np.ndarray]:
    adam = state.opt_state.inner_state[0]          # apply_if_finite(adam)
    return {**model_variables(state),
            **flatten({"mu": adam.mu, "nu": adam.nu}),
            "count": np.asarray(adam.count), "step": np.asarray(state.step)}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    state = restore_state(args.work_dir, run_config(args), args.step)
    written = [args.out]
    np.savez(args.out, **model_variables(state))
    if args.train_state:
        np.savez(args.train_state, **train_state_variables(state))
        written.append(args.train_state)
    print(f"exported step {int(state.step)} of {args.work_dir} -> "
          f"{', '.join(written)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
