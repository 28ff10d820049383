"""Device mesh: counterpart of `articulated_pose_tpu/parallel/mesh.py`.

JAX lays a (data, model) `jax.sharding.Mesh` over the devices and lets
`shard_map` (serving) and GSPMD (training) place the work.  PyTorch has
neither, so the port keeps the mesh as a grid of devices and places the
work itself, under JAX's names, specs, rules and error messages:

- `make_mesh`, `batch_sharding`, `state_shardings`: as JAX's.  The
  data-parallel served call is `serving.PosePredictor`'s own.
- `shard_train_setup`: the train step with one process per mesh device
  over `torch.distributed` (`parallel/launch.py::run_ranks` starts such
  a world).  'data' splits the batch: batch norm reduces its statistics
  over the data ranks (the global batch's, as under GSPMD) and the
  gradients are all-reduced as a mean.  'model' splits the output
  features of the layers that `state_shardings` marks: each model rank
  holds its block of the weight's rows and of their Adam moments, and
  the layer's output is assembled to full width (Megatron's column-
  parallel layer, `parallel/collectives.py`).  The bias and the batch
  norm stay replicated, as JAX's rule leaves them; the replicated
  gradients are the model group's first rank's, broadcast, so that the
  replicated parameters stay equal bit for bit.

Only `all_reduce` and `broadcast` cross ranks.  The worlds that run it
are gloo worlds (`parallel/launch.py::run_ranks`), of ranks on the CPU
or sharing a card; an NCCL world, a card a rank, has not been run.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from articulated_pose_tpu_torch.models.layers import ScheduledBatchNorm
from articulated_pose_tpu_torch.parallel.collectives import (ColumnShard,
                                                             gather_rows)
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    global_norm,
                                                    loss_and_grads, to_device)

# the parameters whose output features are worth splitting on 'model':
# the global SA stage's wide layers and the first FP stage (JAX's
# _TP_PATTERN on the port's names; convert.py maps one onto the other)
_TP_PATTERN = re.compile(r"(sa_global\.mlp\.conv[12]|fp1\.mlp\.conv0)"
                         r"\.dense\.weight$")
_TP_MIN_FEATURES = 256


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices, one grid axis a name.  A device may appear
    more than once (several ranks or shards on one card, or the CPU)."""

    devices: np.ndarray              # of torch.device
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def coords(self, rank: int) -> Dict[str, int]:
        """Device `rank`'s index on each axis (ranks count row-major)."""
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(
            rank, self.devices.shape))))

    def lines(self, axis: str) -> List[List[int]]:
        """The ranks of each line of the grid along `axis`, in order."""
        ranks = np.arange(self.size).reshape(self.devices.shape)
        if axis not in self.axis_names:
            return [[r] for r in range(self.size)]
        k = self.axis_names.index(axis)
        return np.moveaxis(ranks, k, -1).reshape(
            -1, ranks.shape[k]).tolist()


def parse_spec(spec: str) -> Tuple[List[str], List[int]]:
    """"data=4,model=2" -> (["data", "model"], [4, 2])."""
    names, sizes = [], []
    for part in spec.split(","):
        k, v = part.split("=")
        names.append(k.strip())
        sizes.append(int(v))
    return names, sizes


def make_mesh(spec: Optional[str] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from a "data=4,model=2"-style spec (None: every device on
    'data').  `devices` defaults to every visible CUDA device; without a
    card that raises.  A caller may name devices itself, one more than
    once (`[torch.device("cpu")] * 8` is a mesh of eight CPU ranks)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices (e.g. [torch.device('cpu')] * n) to "
                               "build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    n = len(devices)
    if not spec:
        return Mesh(grid, ("data",))
    names, sizes = parse_spec(spec)
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh spec {spec!r} needs {np.prod(sizes)} devices,"
                         f" have {n}")
    return Mesh(grid.reshape(sizes), tuple(names))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading batch axis split over the mesh's 'data' axis."""

    mesh: Mesh

    @property
    def shards(self) -> int:
        return self.mesh.axis_size("data")

    @property
    def devices(self) -> List[torch.device]:
        """Each data shard's first device (every other axis at 0), in
        shard order."""
        return [self.mesh.devices.flat[r] for r in self.mesh.lines("data")[0]]

    def rows(self, batch: int, index: int) -> slice:
        """Shard `index`'s rows of a batch of `batch`."""
        if batch % self.shards:
            raise ValueError(
                f"batch {batch} must divide by the mesh's data axis "
                f"({self.shards}) for SPMD serving — pad the batch")
        n = batch // self.shards
        return slice(index * n, (index + 1) * n)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading batch axis over the 'data' mesh axis."""
    return BatchSharding(mesh)


def _param_spec(name: str, t: torch.Tensor, mesh: Mesh) -> Tuple:
    """JAX's rule: a marked weight with at least _TP_MIN_FEATURES output
    features, divisible by the 'model' size, is split on its output
    features (the port's dim 0, JAX's kernel's last axis)."""
    if ("model" in mesh.axis_names and t.dim() >= 1
            and _TP_PATTERN.search(name)
            and t.shape[0] >= _TP_MIN_FEATURES
            and t.shape[0] % mesh.shape["model"] == 0):
        return ("model",) + (None,) * (t.dim() - 1)
    return ()


def state_shardings(state: TrainState, mesh: Mesh) -> Dict:
    """The placement of each leaf of `state.state_dict()`, in its
    layout: () replicated, or the mesh axis each dimension is split on
    (None: not split), like JAX's PartitionSpecs.  Adam's moments follow
    their parameters."""
    sd = state.state_dict()
    out = {key: {name: _param_spec(name, t, mesh)
                 for name, t in sd[key].items()}
           for key in ("model", "mu", "nu")}
    out["count"] = out["step"] = ()
    return out


def _rank_of(mesh: Mesh) -> int:
    """This process's rank: 0 on a mesh of one device, else
    `torch.distributed`'s."""
    if mesh.size == 1:
        return 0
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"a mesh of {mesh.size} devices needs a "
                           f"torch.distributed world of {mesh.size} ranks "
                           "(parallel/launch.py::run_ranks starts one)")
    return dist.get_rank()


def _group(mesh: Mesh, axis: str, rank: int):
    """This rank's process group along `axis` (None for a size of 1);
    every rank creates every group, in the same order."""
    if mesh.axis_size(axis) == 1:
        return None
    mine = None
    for ranks in mesh.lines(axis):
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


class ShardedTrainStep:
    """One rank's part of the train step over a mesh (see the module
    docstring); made by `shard_train_setup`.

    `step(state, batch)` takes the global batch (every rank the same) and
    trains on this rank's rows; it returns `train_step`'s metrics, the
    losses averaged over the data shards.  `loss_and_grads` and `apply`
    are its two halves.  `state_dict(state)` gathers the sharded state
    into the unsharded layout, for `Checkpointer` and `convert`.  On a
    mesh of one device it is `train_step` bit for bit.
    """

    def __init__(self, state: TrainState, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        coords = mesh.coords(rank)
        self.data_index = coords.get("data", 0)
        self.model_index = coords.get("model", 0)
        self.data_size = mesh.axis_size("data")
        self.model_size = mesh.axis_size("model")
        self.sharding = batch_sharding(mesh)
        device = mesh.devices.flat[rank]
        _place(state, device)
        if mesh.size > 1:
            _broadcast(state)           # every rank starts from rank 0's
        self.data_group = _group(mesh, "data", rank)
        self.model_group = _group(mesh, "model", rank)
        self.model_root = next(line[0] for line in mesh.lines("model")
                               if rank in line)
        if self.data_group is not None:
            for m in state.model.modules():
                if isinstance(m, ScheduledBatchNorm):
                    m.data_group = self.data_group
        specs = state_shardings(state, mesh)["model"]
        self.sharded = ([n for n in state.names if specs.get(n)]
                        if self.model_size > 1 else [])
        modules = dict(state.model.named_modules())
        for name in self.sharded:
            conv = modules[name[:-len(".dense.weight")]]
            conv.columns = ColumnShard(self.model_group, self.model_index,
                                       self.model_size)
            i = state.names.index(name)
            with torch.no_grad():
                state.params[i].data = self._block(state.params[i])
                state.opt.mu[i] = self._block(state.opt.mu[i])
                state.opt.nu[i] = self._block(state.opt.nu[i])
        self._is_sharded = torch.tensor([n in self.sharded
                                         for n in state.names], device=device)
        self.generator = torch.Generator(device=device)
        self.steps = int(state.step)    # the dropout seed's, on the host

    def _block(self, t: torch.Tensor) -> torch.Tensor:
        rows = t.shape[0] // self.model_size
        return t[self.model_index * rows:(self.model_index + 1) * rows].clone()

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch`."""
        return self.sharding.rows(batch, self.data_index)

    def loss_and_grads(self, state: TrainState, batch: Dict
                       ) -> Tuple[Dict, List[torch.Tensor]]:
        """(summaries, gradients) of the global batch: each the mean over
        the data shards (the batch's mean, since the shards are equal);
        a sharded weight's gradient is its block's."""
        rows = self.rows(len(batch["P"]))
        local = to_device({k: v[rows] for k, v in batch.items()},
                          state.device)
        gen = dropout_generator(self.generator, state.config.seed,
                                self.steps, self.data_index)
        _, summaries, grads = loss_and_grads(state, local, gen)
        summaries = {k: v.detach() for k, v in summaries.items()}
        if self.data_group is not None:
            grads = _reduced(grads, lambda t: dist.all_reduce(
                t, group=self.data_group))
            grads = [g / self.data_size for g in grads]
            keys = list(summaries)
            values = torch.stack([summaries[k] for k in keys])
            dist.all_reduce(values, group=self.data_group)
            summaries = dict(zip(keys, (values / self.data_size).unbind()))
        if self.sharded:
            # the model ranks compute the replicated gradients alike, but
            # not bit for bit on a card (atomic sums in the gathers'
            # backward): take the first one's, so that the replicated
            # parameters stay equal
            rep = [i for i, n in enumerate(state.names)
                   if n not in self.sharded]
            sent = _reduced([grads[i] for i in rep], lambda t: dist.broadcast(
                t, src=self.model_root, group=self.model_group))
            for i, g in zip(rep, sent):
                grads[i] = g
        return summaries, grads

    def apply(self, state: TrainState, summaries: Dict,
              grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Adam on this rank's parameters (all ranks accept or skip the
        update together) and the step's metrics."""
        finite = None
        if self.model_group is not None:
            bad = (~torch.isfinite(torch.cat(
                [g.reshape(-1) for g in grads])).all()).to(torch.float32)
            dist.all_reduce(bad, group=self.model_group)
            finite = bad == 0
        finite = state.tx.apply(state.params, grads, state.opt, finite)
        state.step.add_(1)
        self.steps += 1
        metrics = dict(summaries)
        metrics["grads_finite"] = finite
        metrics["grad_norm"] = self.grad_norm(grads)
        return metrics

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Dict[str, torch.Tensor]:
        summaries, grads = self.loss_and_grads(state, batch)
        return self.apply(state, summaries, grads)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the whole gradient: the sharded blocks'
        squares summed over 'model'."""
        if not self.sharded:
            return global_norm(grads)
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        blocks = sq[self._is_sharded].sum()
        dist.all_reduce(blocks, group=self.model_group)
        return torch.sqrt(sq[~self._is_sharded].sum() + blocks)

    def gather(self, state: TrainState, tensors: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """Per-parameter tensors (gradients, moments) at full size."""
        return [gather_rows(t, self.model_group, self.model_index,
                            self.model_size) if n in self.sharded else t
                for n, t in zip(state.names, tensors)]

    def state_dict(self, state: TrainState) -> Dict:
        """`state.state_dict()` with the sharded leaves gathered: the
        unsharded trainer's layout."""
        sd = state.state_dict()
        out = {k: dict(v) if isinstance(v, dict) else v
               for k, v in sd.items()}
        for name in self.sharded:
            for key in ("model", "mu", "nu"):
                out[key][name] = gather_rows(
                    out[key][name], self.model_group, self.model_index,
                    self.model_size)
        return out


def _reduced(tensors: Sequence[torch.Tensor], collective) -> List[
        torch.Tensor]:
    """`tensors` through one collective on a flat copy of them all."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _place(state: TrainState, device: torch.device) -> None:
    """The state on `device` (the model's parameters stay the same
    objects, so `state.params` still holds them)."""
    state.model.to(device)
    state.opt.mu = [t.to(device) for t in state.opt.mu]
    state.opt.nu = [t.to(device) for t in state.opt.nu]
    state.opt.count = state.opt.count.to(device)
    state.step = state.step.to(device)
    state.device = device


@torch.no_grad()
def _broadcast(state: TrainState) -> None:
    for t in (*state.model.state_dict().values(), *state.opt.mu,
              *state.opt.nu, state.opt.count, state.step):
        dist.broadcast(t, src=0)


def shard_train_setup(state: TrainState, mesh: Mesh):
    """The train step over the mesh, for this process's rank
    (`torch.distributed`'s; no process group is needed for a mesh of one
    device).  The state moves to the rank's device, is broadcast from
    rank 0, and its marked weights and their moments keep this rank's
    block (`state_shardings`).

    Returns (sharded_step, state, batch_sharding), as JAX's does: call
    `sharded_step(state, batch)` with the global batch.
    """
    step = ShardedTrainStep(state, mesh, _rank_of(mesh))
    return step, state, step.sharding
