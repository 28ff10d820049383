"""Synthetic frames generated on the card: counterpart of
`articulated_pose_tpu/data/device_synthetic.py`.

The canonical part geometry, the joints and every per-point label
(articulation does not change canonical coordinates, so the labels are
static per point) are computed once on the host in NumPy float64 from a
`SyntheticArticulated` generator, as the JAX package computes them, and
held on the device.  A batch then costs only its random draws and a few
batched tensor ops: articulate, place with a camera similarity, add
noise, pick N points.  Ground-truth part poses come with every frame.

The draws are data (`SynthDraws`), as the pose fit's are (`PoseDraws`):
`draw` makes them from an explicit torch.Generator on the device,
`frames` is a pure function of them, and the tests hand in draws rebuilt
from JAX's keys.  Nothing here reads the device from the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch.compiled import compiled
from articulated_pose_tpu_torch.data.labeling import (nocs_normalize,
                                                      point_line_offset)
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.train.state import (dropout_generator,
                                                    train_step)
from articulated_pose_tpu_torch.utils.profiling import span, stage

_JT = {"revolute": 0, "prismatic": 1, "fixed": 2}
PITCH_RANGE = (math.radians(-75.0), math.radians(-15.0))
# the data stream's generator seeds lie apart from dropout_generator's
DATA_STREAM = 1 << 63


@dataclasses.dataclass
class SynthDraws:
    """The random draws of a batch of B frames.

    states (B, max(J, 1)): joint states, uniform in [-1.2, 1.2];
    s (B,): camera scale, uniform in [0.8, 1.2];
    rot: (B, 2) yaw in [0, 2π) and pitch in [-75°, -15°] (radians), or,
    under full_rotation, (B, 4) normals (an unnormalised quaternion);
    t (B, 3): camera translation, uniform in [-0.5, 0.5];
    noise (B, n_total, 3): standard normals, None when the noise is 0;
    sel (B, N) int64: the N points each frame keeps, distinct indices
    into the (tiled) canonical cloud.
    """

    states: torch.Tensor
    s: torch.Tensor
    rot: torch.Tensor
    t: torch.Tensor
    noise: Optional[torch.Tensor]
    sel: torch.Tensor

    def to(self, device) -> "SynthDraws":
        return SynthDraws(**{f.name: None if getattr(self, f.name) is None
                             else getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def _skew(axis: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues for one unit axis (3,) and angles (B,) -> (B, 3, 3):
    I + sin(a) K + (1 - cos(a)) K², as device_synthetic.py:134-139."""
    K = _skew(axis)
    a = angle[:, None, None]
    return (torch.eye(3, dtype=angle.dtype, device=angle.device)
            + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K))


class DeviceSynthetic:
    """Device-resident twin of a SyntheticArticulated generator.

    Holds its constants on `device`, the card unless the caller names
    another one; without a card the default raises.
    """

    def __init__(self, gen: SyntheticArticulated, *, num_points: int = 1024,
                 noise: float = 0.005, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DeviceSynthetic: device {device} is not "
                               "available; pass device='cpu' for the CPU")
        self.device = device
        self.num_points = num_points
        self.noise = noise
        self.n_parts = gen.n_parts
        self.full_rotation = gen.full_rotation
        K = gen.n_parts

        canon = np.concatenate(gen.parts_canon, axis=0)         # (Ntot, 3)
        part_of = np.concatenate([np.full(len(p), j, np.int64)
                                  for j, p in enumerate(gen.parts_canon)])
        if canon.shape[0] < num_points:
            # tile short clouds (lib/dataset.py:290-317)
            tile = num_points // canon.shape[0] + 1
            canon = np.concatenate([canon] * tile, axis=0)
            part_of = np.concatenate([part_of] * tile, axis=0)
        self.n_total = canon.shape[0]

        corners = np.stack([np.asarray(c, np.float64)
                            for c in gen.norm.corners])
        factors = np.asarray(gen.norm.factors, np.float64)
        g_c, g_f = corners[0], factors[0]

        # per-point part NOCS and global NAOCS
        nocs_p = np.zeros_like(canon)
        for j in range(K):
            sel = part_of == j
            nocs_p[sel] = nocs_normalize(canon[sel], corners[j + 1],
                                         factors[j + 1])
        nocs_g = nocs_normalize(canon, g_c, g_f)

        # joint lines in global NOCS and the per-point joint labels
        n_joints = len(gen.joints)
        jP0, jL, jtypes = [], [], []
        joint_params = np.zeros((K, 7), np.float32)
        for k, jt in enumerate(gen.joints):
            P0 = nocs_normalize(jt.position.reshape(1, 3), g_c, g_f)[0]
            L = np.asarray(jt.axis, np.float64)
            L = L / max(np.linalg.norm(L), 1e-9)
            jP0.append(P0)
            jL.append(L)
            jtypes.append(_JT[jt.jtype])
            slot = min(k + 1, K - 1)
            orth = point_line_offset(P0, L, np.zeros((1, 3)))[0]
            d = float(np.linalg.norm(orth))
            joint_params[slot, 0:3] = L
            joint_params[slot, 6] = d
            joint_params[slot, 3:6] = orth / max(d, 1e-9)

        incidence = np.zeros((K, n_joints), bool)
        for k, jt in enumerate(gen.joints):
            incidence[jt.child, k] = True
            incidence[jt.parent, k] = True

        thres_r = 0.2
        heat = np.zeros(self.n_total, np.float32)
        unitv = np.zeros((self.n_total, 3), np.float32)
        orient = np.zeros((self.n_total, 3), np.float32)
        jcls = np.zeros(self.n_total, np.float32)
        for k in range(n_joints):
            if jtypes[k] == 2:
                continue
            touch = incidence[part_of, k]
            if jtypes[k] == 1:
                off = np.full((self.n_total, 3), 0.5 * thres_r)
                hm = np.full(self.n_total, np.sqrt(3) * 0.5 * thres_r)
                idc = touch
            else:
                off = point_line_offset(jP0[k], jL[k], nocs_g)
                hm = np.linalg.norm(off, axis=1)
                idc = touch & (hm < thres_r)
            heat[idc] = 1 - hm[idc] / thres_r
            unitv[idc] = off[idc] / (hm[idc, None] + 1e-8)
            orient[idc] = jL[k]
            jcls[idc] = k + 1

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.canon = f32(canon)
        self.part_of = torch.as_tensor(part_of, device=device)
        # each point's one-hot part mask, gathered like the other labels
        self.mask_of = f32(np.eye(K)[part_of])
        self.nocs_p = f32(nocs_p)
        self.nocs_g = f32(nocs_g)
        self.heat = f32(heat)
        self.unitv = f32(unitv)
        self.orient = f32(orient)
        self.jcls = f32(jcls)
        self.joint_params = f32(joint_params)
        self.g_factor = float(g_f)
        # per-part box centres and factors for the GT pose
        self.part_centers = f32((corners[1:, 0] + corners[1:, 1]) / 2.0)
        self.part_factors = f32(factors[1:])
        # joint geometry in the canonical frame, for articulation
        self.joint_pos = f32(np.stack([j.position for j in gen.joints])
                             if n_joints else np.zeros((0, 3)))
        self.joint_axis = f32(
            np.stack([j.axis / np.linalg.norm(j.axis) for j in gen.joints])
            if n_joints else np.zeros((0, 3)))
        self.joint_type = tuple(int(t) for t in jtypes)
        # pitch about x, yaw about z; made here, not on the hot path
        self.cam_axes = f32(np.eye(3)[[0, 2]])
        self.n_joints = n_joints

    # ------------------------------------------------------------------
    def draw(self, generator: torch.Generator, batch_size: int) -> SynthDraws:
        """A batch's draws from `generator`, on the generator's device.

        The permutation of each frame is the argsort of n_total uniform
        keys, one batched op; its first N entries are `sel`."""
        B = batch_size
        dev = generator.device

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=dev)

        states = uniform((B, max(self.n_joints, 1)), -1.2, 1.2)
        s = uniform((B,), 0.8, 1.2)
        if self.full_rotation:
            rot = torch.randn((B, 4), generator=generator, device=dev)
        else:
            rot = torch.stack([uniform((B,), 0.0, 2 * math.pi),
                               uniform((B,), *PITCH_RANGE)], -1)
        t = uniform((B, 3), -0.5, 0.5)
        noise = (torch.randn((B, self.n_total, 3), generator=generator,
                             device=dev) if self.noise > 0 else None)
        keys = torch.rand((B, self.n_total), generator=generator, device=dev)
        sel = keys.argsort(dim=1)[:, :self.num_points]
        return SynthDraws(states=states, s=s, rot=rot, t=t, noise=noise,
                          sel=sel)

    def camera_rotation(self, rot: torch.Tensor) -> torch.Tensor:
        """(B, 3, 3) camera rotations from the rotation draws
        (device_synthetic.py:143-162)."""
        if self.full_rotation:
            q = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
            a, b, c, d = q.unbind(-1)
            return torch.stack([
                torch.stack([a*a+b*b-c*c-d*d, 2*(b*c-a*d), 2*(b*d+a*c)], -1),
                torch.stack([2*(b*c+a*d), a*a-b*b+c*c-d*d, 2*(c*d-a*b)], -1),
                torch.stack([2*(b*d-a*c), 2*(c*d+a*b), a*a-b*b-c*c+d*d], -1),
            ], -2)
        x, z = self.cam_axes
        return axis_angle(x, rot[:, 1]) @ axis_angle(z, rot[:, 0])

    def articulation(self, states: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-part rotation (B, K, 3, 3) and translation (B, K, 3) in the
        canonical frame (device_synthetic.py:170-188)."""
        B = states.shape[0]
        eye = torch.eye(3, device=states.device).expand(B, 3, 3)
        zero = torch.zeros((B, 3), device=states.device)
        partR, partT = [eye], [zero]
        for j in range(1, self.n_parts):
            k = j - 1
            jt = self.joint_type[k]
            if jt == 0:      # revolute about (pos, axis)
                R = axis_angle(self.joint_axis[k], states[:, k])
                t = self.joint_pos[k] - R @ self.joint_pos[k]
            elif jt == 1:    # prismatic, in [0, 0.3]
                R = eye
                t = self.joint_axis[k] * (0.125 * states[:, k:k + 1] + 0.15)
            else:
                R, t = eye, zero
            partR.append(R)
            partT.append(t)
        return torch.stack(partR, 1), torch.stack(partT, 1)

    def frames(self, draws: SynthDraws
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(sample, gt) of a batch, device_synthetic.py:164-225 for every
        frame at once: sample holds the training labels (B, N, ...) as
        `data.synthetic` names them, gt the per-part similarity R
        (B, K, 3, 3), s (B, K), t (B, K, 3) from part NOCS to P."""
        B = draws.s.shape[0]
        K = self.n_parts
        partR, partT = self.articulation(draws.states)
        # each point moved by its own part's transform
        art = (torch.einsum("bnij,nj->bni", partR[:, self.part_of],
                            self.canon) + partT[:, self.part_of])
        R_cam = self.camera_rotation(draws.rot)
        s_cam = draws.s[:, None, None]
        t_cam = draws.t[:, None, :]
        pts = (s_cam * art) @ R_cam.transpose(1, 2) + t_cam
        if self.noise > 0:
            pts = pts + self.noise * draws.noise

        sel = draws.sel
        P = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3)) \
            * self.g_factor
        part = self.part_of[sel]
        jcls = self.jcls[sel]
        sample = {
            "P": P,
            "cls_gt": part.to(torch.float32),
            "mask_array": self.mask_of[sel],
            "nocs_gt": self.nocs_p[sel],
            "nocs_gt_g": self.nocs_g[sel],
            "heatmap_gt": self.heat[sel],
            "unitvec_gt": self.unitv[sel],
            "orient_gt": self.orient[sel],
            "joint_cls_gt": jcls,
            "joint_cls_mask": (jcls > 0).to(torch.float32),
            "joint_params_gt": self.joint_params.expand(B, K, 7),
        }

        # GT similarity per part, part NOCS -> input frame:
        # X = (nocs - 0.5)/f_j + c_j ; Y = f0 (s_cam R_cam (R_j X + t_j) + t_cam)
        R_gt = R_cam[:, None] @ partR                                 # (B,K,3,3)
        s_gt = self.g_factor * draws.s[:, None] / self.part_factors   # (B,K)
        base = self.part_centers - 0.5 / self.part_factors[:, None]   # (K,3)
        inner = torch.einsum("bkij,kj->bki", partR, base) + partT     # (B,K,3)
        t_gt = self.g_factor * ((draws.s[:, None, None] * inner)
                                @ R_cam.transpose(1, 2) + t_cam)      # (B,K,3)
        return sample, {"R": R_gt, "s": s_gt, "t": t_gt}

    def sample_batch(self, generator: torch.Generator, batch_size: int):
        """(sample, gt) of `batch_size` fresh frames drawn from
        `generator`."""
        return self.frames(self.draw(generator, batch_size))


def data_seed(seed: int, step: int) -> int:
    """The data generator's seed for train step `step`: a function of
    (seed, step), as `fold_in(key, state.step)` makes JAX's batch key
    (device_synthetic.py:252), so a resumed run draws the batches an
    uninterrupted one would.  Apart from `dropout_generator`'s seeds."""
    return DATA_STREAM | (seed << 32) | step


def make_fused_synthetic_train_step(config, device_gen: DeviceSynthetic,
                                    batch_size: int, steps_per_call: int = 1,
                                    seed: int = 1, *, jit: bool = True
                                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Train step with the data generated on the device:
    `fused(state, step) -> metrics` runs `steps_per_call` steps from
    `step`, the host's count of `state.step` (a Python int: the host never
    reads the device for it), and returns the last step's metrics as
    device tensors (device_synthetic.py:233-263).

    Each step reseeds a device generator from (seed, step) and draws its
    batch from it, then runs `train_step` (`make_train_step(config,
    jit=False)`, JAX's `base_step`) with the dropout masks of
    `dropout_generator(config.seed, step)`, as `Trainer.fit` does.
    Nothing in it syncs with the host.

    With `jit` (JAX's `jax.jit(one)`) the draw and the step are one
    program, captured on the card at the first call and replayed
    (`compiled.py`), both generators registered with its graph.  A window
    of `steps_per_call` steps replays it that many times, each after the
    host reseeds the generators: a graph cannot reseed a generator within
    a replay, and the seeds are a function of the host's step count, so
    JAX's `lax.scan` over the window becomes a loop of replays, each one
    host call.  `jit=False` runs the same body eagerly, for the tools that
    count or trace its ops.  With `jit`, `fused.program` is the
    `compiled.Program`: its `stage_ms()` reads the last step's "datagen"
    (the draw) and "step" (the train step) in device ms.  Under a trace
    each step's reseed is the span "fused.reseed step=<n>", before the
    program's "program.replay".
    """
    dev = device_gen.device
    data = torch.Generator(device=dev)
    dropout = torch.Generator(device=dev)

    def one(state, data_gen: torch.Generator,
            dropout_gen: torch.Generator) -> Dict[str, torch.Tensor]:
        batch, _ = device_gen.sample_batch(data_gen, batch_size)
        stage("datagen")
        metrics = train_step(state, batch, dropout_gen)
        stage("step")
        return metrics

    run = compiled(one) if jit else one

    def fused(state, step: int) -> Dict[str, torch.Tensor]:
        for s in range(step, step + steps_per_call):
            with span("fused.reseed", step=s):
                data.manual_seed(data_seed(seed, s))
                dropout_generator(dropout, config.seed, s)
            metrics = run(state, data, dropout)
        return metrics

    if jit:
        fused.program = run
    return fused
