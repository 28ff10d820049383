"""Run a world of ranks, one process each, over torch.distributed.

`run_ranks(fn, job, devices)` spawns one process per entry of `devices`,
joins them into a gloo world (its rendezvous on a free localhost port),
runs `fn(job)` in each and returns the ranks' results in rank order.
`fn` must be importable by a fresh interpreter (a function of this
package, or of the standard library), since the ranks are spawned, not
forked.  Each rank takes its device: `torch.cuda.set_device` on a card,
one intra-op thread on the CPU (the ranks share the host's cores, and
the test suite runs several workers already).  The job goes to the ranks
and their results come back through files (`torch.save`), so no rank
shares a tensor's memory with another.  The world has a time limit of
its own: past it, every rank is killed and `run_ranks` raises
TimeoutError, so a rank that hangs in a collective cannot hang its
caller.

`train_job` is the function the tests and `chip_smoke.py` run in each
rank: the sharded train step of `parallel/mesh.py` on a `TrainJob`.
"""

from __future__ import annotations

import dataclasses
import pathlib
import socket
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from articulated_pose_tpu_torch.config import NetworkConfig


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, devices: Sequence[str], port: int,
               out_dir: str) -> None:
    out = pathlib.Path(out_dir)
    job = torch.load(out / "job.pt", weights_only=False)   # written below
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=len(devices), rank=rank)
    try:
        result = fn(job)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, out / f"rank{rank}.pt")


def run_ranks(fn: Callable, job, devices: Sequence, timeout: float = 120.0
              ) -> List:
    """`fn(job)` in a gloo world of one rank per device; the ranks'
    results (tensors, numbers, strings and containers of them) in rank
    order.  Raises TimeoutError, after killing the world, when it has not
    finished within `timeout` seconds, and a rank's exception as
    torch.multiprocessing reports it."""
    devices = [str(torch.device(d)) for d in devices]
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(job, pathlib.Path(out_dir) / "job.pt")
        ctx = mp.start_processes(
            _rank_main, args=(fn, devices, _free_port(), out_dir),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{len(devices)} ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(pathlib.Path(out_dir) / f"rank{r}.pt",
                           weights_only=True)
                for r in range(len(devices))]


# the sharded step's bounds against the single-rank step on one step,
# with the same routing (tests/test_train.py's for JAX's sharded step):
# the loss and the grad norm relative, each batch statistic and each
# gradient over its leaf's largest entry (a gradient beyond 1e-7)
BOUNDS = {"loss": 1e-5, "grad_norm": 1e-4, "stats": 1e-4, "leaf": 1e-4}


@dataclasses.dataclass
class TrainJob:
    """Train steps of the sharded step, one global batch a step.

    `model` (on the CPU) and `state` (a `TrainState.state_dict()` on the
    CPU, or None to keep the model's weights and fresh moments) are the
    start; `devices` holds each rank's device, `mesh` the spec over them.
    `routing`, when given, holds for each step a whole batch's choices
    (`train.routing.capture_routing`), which each rank imposes on its
    rows; with `capture`, the ranks record theirs instead, for
    `single_rank_deviations`.
    """

    mesh: str
    devices: List[str]
    config: NetworkConfig
    model: torch.nn.Module
    batches: List[Dict]
    state: Optional[Dict] = None
    routing: Optional[List[Dict]] = None
    capture: bool = False


def _pack(record: Dict[str, torch.Tensor]) -> Dict:
    """Boolean choices as bits (a mask of the reference widths' SA1 is
    tens of millions of entries)."""
    return {k: (torch.from_numpy(np.packbits(v.cpu().numpy().ravel())),
                list(v.shape)) for k, v in record.items()}


def _unpack(packed) -> torch.Tensor:
    bits, shape = packed
    n = int(np.prod(shape))
    return torch.from_numpy(np.unpackbits(bits.numpy(), count=n)
                            .astype(bool).reshape(shape))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def heatmap_target(model: torch.nn.Module, batch: Dict, rows: slice,
                   device) -> Optional[torch.Tensor]:
    """The heatmap's target on `rows` of `batch`, on `device`, for the
    routing records (None for a model without a joint head or a batch
    without the target)."""
    if getattr(model, "joint_net", None) is None or "heatmap_gt" not in batch:
        return None
    return torch.as_tensor(batch["heatmap_gt"][rows], device=device)


def train_job(job: TrainJob) -> Dict:
    """Run `job` in this rank; returns what it saw: each step's metrics
    and host-clock ms (synchronised), the gathered state after the last
    step, this rank's device, the shapes of its sharded weights and its
    kernel launches; rank 0 also each step's full gradients and the
    gathered state after it, and with `capture` each rank of model index
    0 its rows' routing of each step."""
    from articulated_pose_tpu_torch.ops.kernels import launch_counts
    from articulated_pose_tpu_torch.parallel.mesh import (make_mesh,
                                                          shard_train_setup)
    from articulated_pose_tpu_torch.train.routing import (capture_routing,
                                                          impose_routing)
    from articulated_pose_tpu_torch.train.state import TrainState

    rank = dist.get_rank()
    device = torch.device(job.devices[rank])
    mesh = make_mesh(job.mesh, devices=job.devices)
    model = job.model.to(device)
    state = TrainState(model, job.config)
    if job.state is not None:
        state.load_state_dict(job.state)
    step, state, _ = shard_train_setup(state, mesh)
    before = launch_counts()
    out = {"metrics": [], "ms": [], "device": str(device), "grads": [],
           "states": [], "routing": [],
           "sharded": {n: list(state.params[state.names.index(n)].shape)
                       for n in step.sharded}}
    for s, batch in enumerate(job.batches):
        record = {}
        rows = step.rows(len(batch["P"]))
        gt = heatmap_target(state.model, batch, rows, device)
        if job.routing:
            handles = impose_routing(state.model, {
                k: v[rows] for k, v in job.routing[s].items()}, gt)
        else:
            handles = capture_routing(state.model, record, gt) \
                if job.capture else []
        t0 = time.perf_counter()
        summaries, grads = step.loss_and_grads(state, batch)
        metrics = step.apply(state, summaries, grads)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        for h in handles:
            h.remove()
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        # every rank takes part in the gathers; rank 0 keeps them
        full = step.gather(state, grads)
        gathered = step.state_dict(state)
        if rank == 0:
            out["grads"].append(_to_cpu(dict(zip(state.names, full))))
            out["states"].append(_to_cpu(gathered))
        if record and step.model_index == 0:
            out["routing"].append(_pack(record))
    after = launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["state"] = _to_cpu(step.state_dict(state))
    return out


def single_rank_deviations(job: TrainJob, out: List[Dict],
                           device) -> List[Dict[str, float]]:
    """For each step of a world that ran `job` with `capture` (`out`, its
    ranks' results), the single-rank step on the whole batch from the
    world's own state before that step, with the world's routing imposed
    (its data ranks' rows in order), on `device`; the world's deviations
    from it, each to be held to BOUNDS: the loss and grad norm relative,
    the batch statistics after the step over each one's largest entry,
    and the worst gradient over its leaf's largest entry beyond an
    absolute 1e-7 (a dense bias ahead of a batch norm, whose exact
    gradient is 0, by both sides' sizes over its layer's weight
    gradient's), and that leaf's name; and how many of the world's
    choices the single rank's own forward makes otherwise: `flips` of
    the ReLUs and maxes, `heatmap_flips` of the heatmap residual's
    signs."""
    import copy

    from articulated_pose_tpu_torch.train.routing import (HEATMAP,
                                                          capture_routing,
                                                          count_flips,
                                                          grad_deviations,
                                                          impose_routing,
                                                          pre_bn_biases)
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        global_norm,
                                                        loss_and_grads,
                                                        to_device)

    routers = [r["routing"] for r in out if r["routing"]]
    zero = pre_bn_biases(job.model)
    devs = []
    for s, batch in enumerate(job.batches):
        ref = TrainState(copy.deepcopy(job.model).to(device), job.config)
        start = job.state if s == 0 else out[0]["states"][s - 1]
        if start is not None:
            ref.load_state_dict(start)
        world = {k: torch.cat([_unpack(r[s][k]) for r in routers])
                 for k in routers[0][s]}
        gt = heatmap_target(ref.model, batch, slice(None), device)
        own = {}
        # the single rank's own choices first, then the world's imposed
        handles = (capture_routing(ref.model, own, gt)
                   + impose_routing(ref.model, world, gt))
        _, summaries, grads = loss_and_grads(ref, to_device(batch, device))
        for h in handles:
            h.remove()
        got = out[0]["metrics"][s]
        loss = float(summaries["total_loss"].detach())
        norm = float(global_norm(grads))
        after = out[0]["states"][s]["model"]
        stats = max(((after[k] - v.cpu()).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in ref.model.state_dict().items()
                    if "running" in k)
        want = {n: g.detach().cpu() for n, g in zip(ref.names, grads)}
        mine = out[0]["grads"][s]
        leaf, worst = 0.0, ""
        for _, name, err, scale in grad_deviations(mine, want, zero):
            if name in zero:
                err = max(mine[name].abs().max().item(),
                          want[name].abs().max().item())
            dev = max(err - 1e-7, 0.0) / max(scale, 1e-30)
            if dev > leaf:
                leaf, worst = dev, f"{name} ({err:.2e} of {scale:.2e})"
        heat = {k: own.pop(k) for k in (HEATMAP,) if k in own}
        devs.append({"loss": abs(got["total_loss"] - loss) / abs(loss),
                     "grad_norm": abs(got["grad_norm"] - norm) / norm,
                     "stats": stats, "leaf": leaf, "worst_leaf": worst,
                     "flips": count_flips(own, world)[0],
                     "heatmap_flips": count_flips(heat, world)[0]})
    return devs
