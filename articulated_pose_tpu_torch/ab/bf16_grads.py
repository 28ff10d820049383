"""Per-module gradient fidelity of the bf16 training policies against f32
(`scripts/diag_bf16_grads.py`).

    python -m articulated_pose_tpu_torch.ab.bf16_grads [--work RUN] \\
        [--batch 8] [--points 1024] [--depth 4] [--loss-key miou_loss] \\
        [--out grads.json]

docs/dtype_ab.md traced the collapse of bf16 training to the trunk.  A
bf16 trunk rounds (a) the parameters cast to bf16 in the forward, (b)
the activations stored between layers and (c) the backward's operands.
For each arm (the f32 control, the bf16 trunk, and the interventions
that pin heads, pre-pool activations, all activations or whole stages
to f32) this tool takes the gradient of the total loss (or of one
component, `--loss-key`) with `torch.autograd.grad` at the same f32
parameters, on the same batch, with the same dropout stream (a device
generator seeded 11 before each arm), and reports per module the cosine
and the norm ratio against the f32 gradient, then the overall cosine.
Two controls take the f32 gradient at perturbed parameters: each one
rounded to bf16 ("f32@bf16params"), and each moved by a uniform relative
jitter of 2^-9 ("f32@jitterparams").

Modules are named as in the JAX package (through `convert.flax_tree`),
`--depth` levels deep (4 reaches backbone/sa1/mlp/conv0), so the table
reads line for line against docs/dtype_ab.md.  The parameters come from
the f32 init (seed 0) or from `--work` (a work dir or an exported npz;
`restore_eval.restore_state`).  On the card the bf16 products are
cuBLAS's, with f32 accumulation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch import convert
from articulated_pose_tpu_torch import losses as losses_lib
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.ab.restore_eval import (restore_state,
                                                        tree_leaves)
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.device_synthetic import DeviceSynthetic
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.train.state import (TrainState, forward_loss,
                                                    gt_from_batch)

BATCH_SEED = 7          # the batch's generator (PRNGKey(7))
DROP_SEED = 11          # every arm's dropout stream (PRNGKey(11))
JITTER_SEED = 3
JITTER = 2.0 ** -9
# the policy arms (diag_bf16_grads.py:269-290): NetworkConfig fields
ARMS = {
    "f32": dict(compute_dtype="float32"),
    "bf16": dict(compute_dtype="bfloat16"),
    "bf16_f32heads": dict(compute_dtype="bfloat16",
                          head_compute_dtype="float32"),
    # round-3 bisect: f32 pre-pool activations only, against f32
    # activations everywhere (bf16 products only)
    "bf16_f32pool": dict(compute_dtype="bfloat16",
                         head_compute_dtype="float32",
                         pool_compute_dtype="float32"),
    "bf16_f32act": dict(compute_dtype="bfloat16",
                        head_compute_dtype="float32",
                        act_compute_dtype="float32"),
    # the fix: SA1 pinned to f32, the rest bf16
    "bf16_f32sa1": dict(compute_dtype="bfloat16", f32_stages=("sa1",)),
    # round-4 bisect of the residual segmentation damage
    "bf16_f32sa1fc1": dict(compute_dtype="bfloat16",
                           f32_stages=("sa1", "fp3", "fc1")),
    "bf16_f32sa1sa2": dict(compute_dtype="bfloat16",
                           f32_stages=("sa1", "sa2")),
    "bf16_f32enc": dict(compute_dtype="bfloat16",
                        f32_stages=("sa1", "sa2", "sa_global")),
}
PARAM_ARMS = ("f32@bf16params", "f32@jitterparams")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.bf16_grads",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None,
                    help="work dir or exported npz with trained f32 "
                         "parameters; default: the init")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--parts", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--out", default=None, help="optional JSON dump path")
    ap.add_argument("--depth", type=int, default=2,
                    help="module-path depth of the per-module report (4 "
                         "reaches backbone/sa1/mlp/conv0)")
    ap.add_argument("--loss-key", default=None,
                    help="one loss component's gradient instead of the "
                         "total (e.g. miou_loss, nocs_loss, index_loss)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap


def flat_per_module(tree: Dict, depth: int = 2) -> Dict[str, np.ndarray]:
    """{module path: 1-D float64 vector} of a gradient tree
    (diag_bf16_grads.py:186-204): `depth` levels into nested modules
    while every child is a module, the leaves concatenated in JAX's
    order."""
    out = {}
    for name, sub in tree.items():
        if depth > 1 and isinstance(sub, dict) and sub and all(
                isinstance(v, dict) for v in sub.values()):
            for sname, svec in flat_per_module(sub, depth - 1).items():
                out[f"{name}/{sname}"] = svec
        else:
            leaves = ([a for _, a in tree_leaves(sub)]
                      if isinstance(sub, dict) else [sub])
            out[name] = np.concatenate(
                [np.asarray(a, np.float64).ravel() for a in leaves])
    return out


def config(args, **arm) -> NetworkConfig:
    return NetworkConfig(n_max_parts=args.parts, num_points=args.points,
                         batch_size=args.batch, val_interval=0,
                         snapshot_interval=0, **arm)


def perturbed(model: torch.nn.Module, how: str, device) -> List[torch.Tensor]:
    """The parameters rounded to their bf16 neighbours ("f32@bf16params")
    or each times 1 + 2^-9 u, u uniform in [-1, 1) from a generator
    seeded JITTER_SEED ("f32@jitterparams")."""
    params = [p.detach() for p in model.parameters()]
    if how == "f32@bf16params":
        return [p.to(torch.bfloat16).float() for p in params]
    gen = torch.Generator(device=device).manual_seed(JITTER_SEED)
    return [p * (1.0 + JITTER * (2.0 * torch.rand(
        p.shape, generator=gen, device=device) - 1.0)) for p in params]


def arm_tree(base: TrainState, cfg: NetworkConfig, batch: Dict, *,
             params: Optional[Sequence[torch.Tensor]] = None,
             loss_key: Optional[str] = None,
             spec: Optional[BackboneSpec] = None,
             prepare: Optional[Callable] = None) -> Tuple[float, Dict]:
    """(loss, the gradient as JAX's params tree) of one arm: `cfg`'s
    model holding `base`'s parameters and statistics (or `params` in
    place of the parameters), in training mode at `base`'s step, dropout
    from a generator seeded DROP_SEED.  `prepare(model)`, when given,
    runs before the forward and returns hook handles to remove after it
    (the tests turn dropout off and impose a routing)."""
    model = build_model(cfg, device=base.device, spec=spec)
    model.load_state_dict(base.model.state_dict())
    if params is not None:
        with torch.no_grad():
            for p, v in zip(model.parameters(), params):
                p.copy_(v)
    handles = prepare(model) if prepare is not None else []
    state = TrainState(model, cfg)
    state.step.copy_(base.step)
    gen = torch.Generator(device=base.device).manual_seed(DROP_SEED)
    total, _, pred = forward_loss(state, batch, train=True, generator=gen)
    if loss_key is not None:
        total = losses_lib.compute_all_losses(
            pred, gt_from_batch(batch), cfg)[loss_key].mean()
    grads = torch.autograd.grad(total, state.params, allow_unused=True,
                                materialize_grads=True)
    for h in handles:
        h.remove()
    return total.detach().item(), convert.flax_tree(zip(state.names, grads))


def arm_grads(base: TrainState, cfg: NetworkConfig, batch: Dict,
              depth: int, **kw) -> Tuple[float, Dict[str, np.ndarray]]:
    """(loss, {module: gradient vector}) of one arm (`arm_tree`'s
    arguments), `depth` levels deep."""
    loss, tree = arm_tree(base, cfg, batch, **kw)
    return loss, flat_per_module(tree, depth)


def cosine(r: np.ndarray, v: np.ndarray) -> float:
    return float(np.dot(r, v) / (np.linalg.norm(r) * np.linalg.norm(v)
                                 + 1e-30))


def report(grads: Dict[str, Dict[str, np.ndarray]], losses: Dict[str, float],
           src: str, arms: Sequence[str]) -> Dict:
    """The JAX script's table (diag_bf16_grads.py:358-378): per module
    and arm (in the order of `arms`) the cosine and norm ratio against
    "f32", then each arm's overall cosine; returns them as the --out
    JSON holds them."""
    ref = grads["f32"]
    arms = [a for a in arms if a != "f32"]
    out = {"params": src, "losses": losses, "modules": {}}
    print(f"\n{'module':28s} {'arm':14s} {'cosine':>8s} {'|g|/|g32|':>10s}")
    for mod in sorted(ref):
        r = ref[mod]
        rn = np.linalg.norm(r)
        for arm in arms:
            v = grads[arm][mod]
            cos = float(np.dot(r, v) / (rn * np.linalg.norm(v) + 1e-30))
            ratio = float(np.linalg.norm(v) / (rn + 1e-30))
            out["modules"].setdefault(mod, {})[arm] = {"cosine": cos,
                                                      "norm_ratio": ratio}
            print(f"{mod:28s} {arm:14s} {cos:8.4f} {ratio:10.4f}")
    mods = sorted(ref)
    r = np.concatenate([ref[m] for m in mods])
    for arm in arms:
        cos = cosine(r, np.concatenate([grads[arm][m] for m in mods]))
        out[f"overall_cosine_{arm}"] = cos
        print(f"\noverall cosine {arm}: {cos:.5f}")
    return out


def run(args, spec: Optional[BackboneSpec] = None,
        prepare: Optional[Callable] = None,
        arms: Optional[Dict[str, Dict]] = None) -> Dict:
    """Every arm of ARMS (or `arms`) and both parameter controls; prints
    the table, writes --out and returns the report.  `spec` gives the
    backbone's widths and `prepare` as in `arm_grads` (the tests')."""
    device = resolve_device(args.device, "bf16_grads")
    arms = ARMS if arms is None else arms
    K = args.parts
    cfg32 = config(args, **ARMS["f32"])
    model = build_model(cfg32, torch.Generator().manual_seed(0),
                        device=device, spec=spec)
    state = TrainState(model, cfg32)
    src = "init"
    if args.work:
        state, src = restore_state(state, args.work)
    print(f"params: {src}", flush=True)
    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=("revolute",) * (K - 1), seed=0)
    dg = DeviceSynthetic(gen, num_points=args.points, noise=args.noise,
                         device=device)
    batch, _ = dg.sample_batch(
        torch.Generator(device=device).manual_seed(BATCH_SEED), args.batch)

    grads, losses = {}, {}
    for name, arm in arms.items():
        losses[name], grads[name] = arm_grads(
            state, config(args, **arm), batch, args.depth,
            loss_key=args.loss_key, spec=spec, prepare=prepare)
        print(f"  {name}: loss {losses[name]:.6f}", flush=True)
        if name == "f32":
            for pname in PARAM_ARMS:
                _, grads[pname] = arm_grads(
                    state, cfg32, batch, args.depth,
                    params=perturbed(state.model, pname, device),
                    loss_key=args.loss_key, spec=spec, prepare=prepare)
                losses[pname] = float("nan")
                print(f"  {pname}: (grad at perturbed params)", flush=True)
    out = report(grads, losses, src, list(arms) + list(PARAM_ARMS))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
