"""Restore a checkpoint and check its predictions on one eval batch
(`scripts/diag_restore_eval.py`).

    python -m articulated_pose_tpu_torch.ab.restore_eval --work RUN \\
        [--category eyeglasses] [--seed 1]

Prints the first parameter's and running statistic's mean and std (JAX's
first leaves, by JAX's names) at init and after the restore, then one
batch of held-out frames from the category's generator (the first batch
that `e2e.evaluate` draws) through the eval forward: the segmentation
accuracy against chance, the mean of W per class, the predicted-class
histogram and the NOCS statistics; the accuracy once more with batch
norm on the batch's own statistics (a corrupted running statistic shows
as a gap); and whether the file's raw entries equal what the restore
loaded, leaf by leaf.  Seg acc near chance means the restore or the
eval path is broken; at the training run's eval, any fault lies after it.
The frames take `SyntheticArticulated`'s default cameras (uniform SO(3)),
as the JAX script's do: a model trained on the reference's camera band
(`e2e.py` without `--full-rotation`) reads far below its own eval here.

`--work` is the port's work dir (`<work>/model/ckpt_<step>.pt`, as
`Trainer` and `e2e.py` write) or an npz of `scripts/export_jax_checkpoint.py`
(the Flax variables, or with `--train_state` the whole train state).
The other tools restore through `restore_state`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch import convert
from articulated_pose_tpu_torch.ab.common import seg_acc
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.device_synthetic import DeviceSynthetic
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.e2e import EVAL_SEED
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.registry import get_category
from articulated_pose_tpu_torch.train.state import (TrainState, eval_step,
                                                    forward_loss)
from articulated_pose_tpu_torch.train.trainer import (Checkpointer,
                                                      checkpoint_path)

TRAIN_BN_SEED = 3       # the dropout stream of the train-mode check


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.restore_eval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="work dir (<work>/model/ckpt_*.pt) or an npz of "
                         "scripts/export_jax_checkpoint.py")
    ap.add_argument("--category", default="eyeglasses")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap



def restore_state(state: TrainState, work: str) -> Tuple[TrainState, str]:
    """Load `work` into `state`: the newest `<work>/model/ckpt_<step>.pt`,
    or an npz from scripts/export_jax_checkpoint.py (a train state when
    it holds "step", else the model's variables).  Returns the state and
    a description of the source."""
    if os.path.isfile(work) and work.endswith(".npz"):
        with np.load(work) as f:
            flat = {k: f[k] for k in f.files}
        if "step" in flat:
            state.load_state_dict(convert.train_state_from_optax(flat))
            return state, f"{work} (JAX train state, step {int(state.step)})"
        state.model.load_state_dict(convert.state_dict_from_flax(flat))
        return state, f"{work} (JAX variables)"
    ck = Checkpointer(os.path.join(work, "model"))
    step = ck.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {work}")
    return ck.restore(state, step), f"{work} @ step {step}"


def raw_entries(work: str) -> Dict[str, torch.Tensor]:
    """The model's entries of `work` as the file holds them, by the
    port's names, without a template."""
    if os.path.isfile(work) and work.endswith(".npz"):
        with np.load(work) as f:
            return convert.state_dict_from_flax(
                {k: f[k] for k in f.files
                 if k.startswith(("params/", "batch_stats/"))})
    ck = Checkpointer(os.path.join(work, "model"))
    payload = torch.load(checkpoint_path(ck.model_dir, ck.latest_step()),
                         map_location="cpu", weights_only=True)
    return payload["model"]


def tree_leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """(path, leaf) of a nested dict in JAX's leaf order (keys sorted at
    every level, as jax.tree.leaves orders a dict)."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.extend(tree_leaves(v, path) if isinstance(v, dict)
                   else [(path, v)])
    return out


def collections(model: torch.nn.Module) -> Dict[str, Dict]:
    """The model's Flax trees: "params" and "batch_stats"."""
    stats = [(n, b) for n, b in model.named_buffers() if "running" in n]
    return {"params": convert.flax_tree(model.named_parameters()),
            "batch_stats": convert.flax_tree(stats, "batch_stats")}




def mean_std(a: np.ndarray) -> Tuple[float, float]:
    return float(np.mean(a)), float(np.std(a))


def run(args, spec: Optional[BackboneSpec] = None) -> Dict:
    """The diagnosis of the flags; returns what it printed, by name.
    `spec` gives the backbone's widths (the tests' tiny one)."""
    device = resolve_device(args.device, "restore_eval")
    cat = get_category(args.category)
    K = cat.n_parts
    cfg = NetworkConfig(n_max_parts=K, num_points=args.points,
                        batch_size=args.batch, val_interval=0,
                        snapshot_interval=0)
    model = build_model(cfg, torch.Generator().manual_seed(0), device=device,
                        spec=spec)
    state = TrainState(model, cfg)
    out: Dict = {}
    trees = collections(model)
    p0 = tree_leaves(trees["params"])[0]
    b0 = tree_leaves(trees["batch_stats"])[0]
    out["init_params0"] = mean_std(p0[1])
    print(f"init params[0] ({p0[0]}) mean/std:", *out["init_params0"],
          flush=True)
    print("init batch_stats[0] mean:", {"bs0": float(np.mean(b0[1]))},
          flush=True)

    state, src = restore_state(state, args.work)
    print(f"restored {src}; step {int(state.step)}", flush=True)
    trees = collections(model)
    out["params0"] = mean_std(tree_leaves(trees["params"])[0][1])
    out["batch_stats0"] = mean_std(tree_leaves(trees["batch_stats"])[0][1])
    print("restored params[0] mean/std:", *out["params0"], flush=True)
    print("restored batch_stats[0] mean/std:", *out["batch_stats0"],
          flush=True)

    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=tuple(cat.joint_types),
                               seed=args.seed)
    dg = DeviceSynthetic(gen, num_points=args.points, noise=args.noise,
                         device=device)
    batch, _ = dg.sample_batch(
        torch.Generator(device=device).manual_seed(EVAL_SEED), args.batch)
    pred, _ = eval_step(state, batch)
    W = pred["W"].float().cpu().numpy()
    out["seg_acc"] = seg_acc(pred, batch)
    print(f"seg acc: {out['seg_acc']:.4f}  (random = {1.0 / K:.3f})",
          flush=True)
    print("W row mean per class:", np.round(W.mean(axis=(0, 1)), 4),
          flush=True)
    out["histogram"] = np.bincount(np.argmax(W, -1).ravel(), minlength=K)
    print("pred class histogram:", out["histogram"], flush=True)
    nocs = pred["nocs_per_point"].float().cpu().numpy()
    print("nocs pred mean/std:", *mean_std(nocs), flush=True)

    # (b) batch norm on the batch's own statistics: if the accuracy
    # recovers, the running statistics are at fault, not the weights
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _, _, pred_t = forward_loss(
            state, batch, train=True,
            generator=torch.Generator(device=device).manual_seed(
                TRAIN_BN_SEED))
    model.load_state_dict(kept)
    model.eval()
    out["seg_acc_train_bn"] = seg_acc(pred_t, batch)
    print(f"seg acc train-mode BN: {out['seg_acc_train_bn']:.4f}", flush=True)

    # (a) the file's raw entries against what the restore loaded
    raw = raw_entries(args.work)
    loaded = model.state_dict()
    out["raw_equal"] = {}
    for part, names in (("params", [n for n, _ in model.named_parameters()]),
                        ("batch_stats", [n for n in loaded
                                         if "running" in n])):
        a = [raw[n] for n in names if n in raw]
        same = len(a) == len(names) and all(
            torch.equal(raw[n].float(), loaded[n].detach().cpu().float())
            for n in names)
        out["raw_equal"][part] = same
        print(f"raw-vs-template {part}: leaves {len(a)} vs {len(names)}, "
              f"equal={same}", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
