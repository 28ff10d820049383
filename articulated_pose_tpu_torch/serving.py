"""Serving API: clouds in, part poses out.  Counterpart of
`articulated_pose_tpu/serving.py` and of `main.py::cmd_serve`'s batch loop.

`PosePredictor` holds the model on one device, or with a mesh on each
device of its 'data' axis, and runs the forward and the pose fit for a
batch of clouds; `serve_clouds` pads a stream of clouds to the
predictor's batch and trims the answers.  The RANSAC draws come from a
torch.Generator on the device, seeded from `config.seed`, and are the
same on every call, so the same cloud always gets the same poses (the
JAX server likewise reuses one key for every call); a mesh's shard i
draws from its own, seeded from (`config.seed`, i), shard 0 as the
unsharded predictor does.

Each data shard runs the forward and the fit as one captured program
(`compiled.py`), as the JAX server compiles them as one (serving.py:
84-103): on the card a shard's first batch of a shape is run and
captured, and every later one replays the graph.  A backbone whose
forward reads the host (its `capturable` is False: Point Transformer
V3, whose shapes follow the points) runs its forward eagerly on the
shard's stream, and the program captures the segmentation's argmax and
the fit (`fit_heads`), whose shapes are the batch's (B, N); such a
backbone's order shuffle is drawn once from the shard's seeded
generator (`shuffles`), as the RANSAC draws are.  One host thread
queues every shard's program before any result is read back, so shards
on different cards run at once; threads would only contend for the
interpreter's lock, since the fit is bound by the host's launches (two
threads on one card served at a quarter of one thread's rate).
JAX replicates the variables and shards nothing on 'model' when serving
(its shard_map maps 'data' alone), so the devices along 'model' of one
data shard would compute the same rows: the port computes each shard
once, on the shard's first device.

Each field of a call's `PoseResult` is one host tensor, and every
shard's array is copied once, into its rows.  From the card the tensor
is page-locked and the copy is queued on the shard's stream; it comes
from torch's caching host allocator, so a dropped result's blocks serve
a later call's copies.  The predictor keeps no host buffer: what it
returns stays the caller's for as long as the caller holds it.

Under a trace (`utils/profiling.trace`) a call is the span
"predictor.call call=<n>", holding "predictor.h2d" (the clouds to each
shard's device), each shard's eager "predictor.forward" where the
program holds only the fit, its "program.capture" or "program.replay",
"predictor.d2h" (every field's copies queued) and "predictor.wait"
(each shard's stream finishing, the copies with it); the last two carry
the call's index as well, the others are known by their parent.  Inside
the program, the forward and the fit's partition, one-part RANSAC and
joint groups are stage marks (`stage_ms()`).  `calls` and `d2h_bytes`
count the calls served and the bytes copied back; `pinned_fields` the
fields copied into page-locked memory and `pinned_allocs` the blocks
the host allocator had to allocate anew for them, so that
1 - pinned_allocs / pinned_fields is the share of fields whose block
was reused.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch.compiled import compiled
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.parallel.mesh import (Mesh, batch_sharding,
                                                      make_mesh)
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws, PoseFitConfig,
                                                      fit_frame_batch)
from articulated_pose_tpu_torch.train.state import shard_seed
from articulated_pose_tpu_torch.train.trainer import (checkpoint_path,
                                                      checkpoint_steps)
from articulated_pose_tpu_torch.utils.profiling import span, stage

POSE_KEYS = ("W", "nocs_per_point", "joint_axis_per_point", "index_per_point")


def _host_allocs() -> int:
    """Page-locked blocks torch's caching host allocator has allocated
    from CUDA in this process (cached blocks handed out again count
    nothing)."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def forward_fit(model, P: torch.Tensor, part: torch.Tensor,
                joint: torch.Tensor, pose_cfg: PoseFitConfig
                ) -> Dict[str, Any]:
    """The forward and the fit of one batch (or shard) on P's device with
    the draws (part, joint), queued: the outputs stay there, the
    segmentation (W's argmax) among them.  The body of each shard's
    program in `PosePredictor`; eager when called."""
    pred = model(P)
    segmentation = pred["W"].argmax(dim=-1)
    stage("forward")
    fits = fit_frame_batch({k: pred[k] for k in POSE_KEYS if k in pred},
                           P, PoseDraws(part=part, joint=joint), pose_cfg)
    return {"pred": pred, "fits": fits, "segmentation": segmentation}


def fit_heads(pred: Dict[str, torch.Tensor], P: torch.Tensor,
              part: torch.Tensor, joint: torch.Tensor,
              pose_cfg: PoseFitConfig) -> Dict[str, Any]:
    """The segmentation and the fit of heads a forward outside the
    program computed, queued: the body of each shard's program when the
    backbone cannot be captured."""
    segmentation = pred["W"].argmax(dim=-1)
    fits = fit_frame_batch(pred, P, PoseDraws(part=part, joint=joint),
                           pose_cfg)
    return {"fits": fits, "segmentation": segmentation}


@dataclasses.dataclass
class PoseResult:
    """Per-batch pose outputs (host numpy)."""

    R: np.ndarray              # (B, K, 3, 3) part rotations
    scale: np.ndarray          # (B, K)
    t: np.ndarray              # (B, K, 3)
    segmentation: np.ndarray   # (B, N) argmax part labels
    part_counts: np.ndarray    # (B, K)
    raw: Dict[str, np.ndarray]  # full prediction dict (NOCS, heatmaps, ...)


class PosePredictor:
    """ANCSH forward + pose fit on one device.

    >>> pred = PosePredictor(cfg, work_dir="results/ancsh")   # on the card
    >>> out = pred(clouds)          # (B, N, 3) float32
    >>> out.R[b, j], out.scale[b, j], out.t[b, j]

    Weights come from exactly one of `state_dict`, `ckpt_path` (a
    `torch.save`d state dict; `convert.load_flax_npz` turns a JAX
    checkpoint into one) and `work_dir`, whose newest trainer checkpoint
    (`<work_dir>/model/`) it serves, as the JAX server restores the
    newest Orbax step (serving.py:51-70); FileNotFoundError when there is
    none.
    It serves on the card unless `device` names another one; without a
    card the default raises rather than serving on the CPU.

    With `mesh` (`parallel.mesh.make_mesh`), whose devices replace
    `device`, each call splits the batch over the mesh's 'data' axis and
    runs the forward and the fit of each shard on that shard's device,
    with that shard's draws (`draws(b, shard)`), then gathers the answers
    in shard order.  A batch that does not divide raises JAX's
    ValueError.  Without one it serves through a mesh of one shard on
    `device`: the unsharded predictor is that mesh.
    """

    def __init__(self, config: NetworkConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 ckpt_path: Optional[str] = None,
                 pose_cfg: Optional[PoseFitConfig] = None,
                 use_nonlinear: bool = True, device="cuda",
                 work_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        if sum(x is not None for x in (state_dict, ckpt_path, work_dir)) != 1:
            raise ValueError("PosePredictor needs exactly one of state_dict, "
                             "ckpt_path and work_dir")
        device = torch.device(device)
        devices = list(mesh.devices.flat) if mesh is not None else [device]
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            raise RuntimeError(f"PosePredictor: device {device} is not "
                               "available; pass device='cpu' to serve on "
                               "the CPU")
        if mesh is None:
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = make_mesh("data=1", devices=[device])
        if work_dir is not None:
            model_dir = os.path.join(work_dir, "model")
            steps = checkpoint_steps(model_dir)
            if not steps:
                raise FileNotFoundError(f"no trainer checkpoint in "
                                        f"{model_dir}")
            state_dict = torch.load(checkpoint_path(model_dir, steps[-1]),
                                    map_location="cpu",
                                    weights_only=True)["model"]
        if ckpt_path is not None:
            state_dict = torch.load(ckpt_path, map_location="cpu",
                                    weights_only=True)
        self.config = config
        self.mesh = mesh
        self.batch_sharding = batch_sharding(mesh)
        devices = self.batch_sharding.devices
        self.device = devices[0]
        self.model = build_model(config, device=self.device)
        self.model.load_state_dict(state_dict)
        spec = config.category_spec
        self.pose_cfg = pose_cfg or PoseFitConfig(
            n_parts=config.n_max_parts,
            niter_part=config.ransac_niter_part,
            niter_joint=config.ransac_niter_joint,
            inlier_th=config.ransac_inlier_th,
            joint_types=tuple(spec.joint_types))
        self.use_nonlinear = use_nonlinear and config.pred_joint
        # each data shard's model, generator and forward + fit: the model
        # once a device (an eval forward changes nothing in it), one
        # program (and static buffers) a shard, so that shards queued on
        # one device keep their inputs
        replicas = {self.device: self.model}
        for d in devices:
            if d not in replicas:
                replicas[d] = copy.deepcopy(self.model).to(d)
        self._models = [replicas[d] for d in devices]
        self._generators = [torch.Generator(device=d) for d in devices]
        self.captures_forward = getattr(self.model.backbone, "capturable",
                                        True)
        body = forward_fit if self.captures_forward else fit_heads
        self._programs = [compiled(functools.partial(
            body, pose_cfg=self.pose_cfg)) for _ in devices]
        # each shard's order shuffle, for a backbone that takes one
        self.shuffles = [None] * len(devices)
        if hasattr(self.model.backbone, "draw_shuffle"):
            for shard, g in enumerate(self._generators):
                g.manual_seed(shard_seed(config.seed, shard))
                self.shuffles[shard] = self.model.backbone.draw_shuffle(g)
        self._default_draws: Dict[Tuple[int, int], PoseDraws] = {}
        self.calls = 0          # calls served
        self.d2h_bytes = 0      # results copied to the host
        self.pinned_fields = 0  # result fields copied into page-locked memory
        self.pinned_allocs = 0  # page-locked blocks allocated anew

    def stage_ms(self) -> Dict[str, float]:
        """{stage: device ms} of the first data shard's last replayed call
        (`compiled.Program.stage_ms`): "forward" (where the program holds
        the forward), then the fit's "fit.partition", "fit.ransac" and
        "fit.joint"."""
        return self._programs[0].stage_ms()

    def draws(self, batch: int, shard: int = 0) -> PoseDraws:
        """The RANSAC draws of one call (of data shard `shard`'s rows):
        the same for every call."""
        g = self._generators[shard]
        g.manual_seed(shard_seed(self.config.seed, shard))
        return PoseDraws.sample(batch, self.pose_cfg, g, g.device)

    @torch.no_grad()
    def _run(self, clouds, draws: Optional[Sequence[PoseDraws]] = None
             ) -> list:
        """Each data shard's `forward_fit` outputs, in shard order, left
        on its device: its rows of the (B, N, 3) host batch copied there,
        then its program queued with the caller's draws for the shard or
        its own, drawn once a batch size; where the program holds only
        the fit, the forward runs eagerly before it."""
        devices = self.batch_sharding.devices
        with span("predictor.h2d"):
            clouds = np.asarray(clouds, np.float32)
            inputs = [torch.as_tensor(
                clouds[self.batch_sharding.rows(len(clouds), i)], device=d)
                for i, d in enumerate(devices)]
        outs = []
        for shard, (d, P) in enumerate(zip(devices, inputs)):
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()):
                if draws is not None:
                    shard_draws = draws[shard]
                else:
                    key = (len(P), shard)
                    if key not in self._default_draws:
                        self._default_draws[key] = self.draws(*key)
                    shard_draws = self._default_draws[key]
                program = self._programs[shard]
                if self.captures_forward:
                    outs.append(program(self._models[shard], P,
                                        shard_draws.part, shard_draws.joint))
                    continue
                with span("predictor.forward"):
                    pred = self._models[shard](P,
                                               shuffle=self.shuffles[shard])
                heads = {k: pred[k] for k in POSE_KEYS if k in pred}
                outs.append(dict(program(heads, P, shard_draws.part,
                                         shard_draws.joint), pred=pred))
        return outs

    def _host(self, arrays, pinned: bool) -> torch.Tensor:
        """One host tensor holding the shards' arrays end to end, each
        copied into its rows: page-locked, with each copy queued on its
        shard's stream, when `pinned` (the arrays are on the card);
        copied at once otherwise."""
        out = torch.empty((sum(len(a) for a in arrays), *arrays[0].shape[1:]),
                          dtype=arrays[0].dtype, pin_memory=pinned)
        lo = 0
        for a in arrays:
            out[lo:lo + len(a)].copy_(a, non_blocking=pinned)
            lo += len(a)
        self.d2h_bytes += out.nbytes
        return out

    def _result(self, parts, call: int) -> PoseResult:
        """The host PoseResult of one or more `forward_fit` outputs, in
        order along the batch: every field's copies queued, then every
        shard's stream waited for, then the fields handed back as NumPy
        views of their host tensors."""
        fits = [p["fits"] for p in parts]
        prefix = "nonlinear" if (self.use_nonlinear
                                 and "nonlinear_R" in fits[0]) else "baseline"
        fields = {
            "R": [f[f"{prefix}_R"] for f in fits],
            "scale": [f[f"{prefix}_s"] for f in fits],
            "t": [f[f"{prefix}_t"] for f in fits],
            "segmentation": [p["segmentation"] for p in parts],
            "part_counts": [f["part_counts"] for f in fits]}
        raw = {k: [p["pred"][k] for p in parts] for k in parts[0]["pred"]}
        on_card = any(d.type == "cuda" for d in self.batch_sharding.devices)
        allocs = _host_allocs() if on_card else 0
        with span("predictor.d2h", call=call):
            fields = {k: self._host(a, on_card) for k, a in fields.items()}
            raw = {k: self._host(a, on_card) for k, a in raw.items()}
        if on_card:
            self.pinned_fields += len(fields) + len(raw)
            self.pinned_allocs += _host_allocs() - allocs
        with span("predictor.wait", call=call):
            for d in self.batch_sharding.devices:
                if d.type == "cuda":
                    torch.cuda.current_stream(d).synchronize()
        return PoseResult(**{k: t.numpy() for k, t in fields.items()},
                          raw={k: t.numpy() for k, t in raw.items()})

    def __call__(self, clouds, draws=None) -> PoseResult:
        """Poses of a (B, N, 3) batch.  `draws` replaces the predictor's
        own: a PoseDraws on a mesh of one shard, or a sequence of one per
        shard."""
        if isinstance(draws, PoseDraws):
            draws = [draws]
        if draws is not None and len(draws) != self.batch_sharding.shards:
            raise ValueError(
                f"a PosePredictor over {self.batch_sharding.shards} data "
                f"shards draws each shard's own RANSAC draws: pass one "
                f"PoseDraws per shard, not {len(draws)}")
        call = self.calls
        self.calls += 1
        with span("predictor.call", call=call):
            return self._result(self._run(clouds, draws), call)


def serve_clouds(predictor: PosePredictor, clouds: np.ndarray,
                 batch_size: int) -> Dict[str, np.ndarray]:
    """Serve (C, N, 3) clouds in batches of `batch_size`; a short last
    batch is padded with copies of its last cloud and trimmed after
    (main.py:475-491).  Returns R, s, t, seg, part_counts for the C
    clouds."""
    clouds = np.asarray(clouds, np.float32)
    if clouds.ndim != 3 or clouds.shape[-1] != 3 or len(clouds) == 0:
        raise ValueError(f"expected (C, N, 3) clouds with C > 0, got "
                         f"{clouds.shape}")
    out = None
    for s in range(0, len(clouds), batch_size):
        chunk = clouds[s:s + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = np.repeat(chunk[-1:], batch_size - n, axis=0)
            chunk = np.concatenate([chunk, pad])
        res = predictor(chunk)
        got = {"R": res.R, "s": res.scale, "t": res.t,
               "seg": res.segmentation, "part_counts": res.part_counts}
        if out is None:
            out = {k: np.empty((len(clouds), *a.shape[1:]), a.dtype)
                   for k, a in got.items()}
        for k, a in got.items():
            out[k][s:s + n] = a[:n]
        # the batch's answers are copied out: its result's host blocks go
        # back before the next call, which reuses them
        del res, got
    return out
