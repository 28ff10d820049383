"""The synthetic articulated category and its on-card frame generator:
the benchmark's frozen copy of the port's `data/synthetic.py` (the
canonical parts of `SyntheticArticulated`), `data/labeling.py` (the
normalisation) and `data/device_synthetic.py` (`DeviceSynthetic`'s
draws and frames, and the data stream's seeds).  The reference draws a
train step's batch again from its seed with these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

EPS = 1e-8

@dataclasses.dataclass
class JointSpec:
    """One joint in the canonical (rest) frame.

    `position` is a point on the joint axis; `axis` its direction;
    `parent`/`child` are part indices; `jtype` one of
    'revolute' | 'prismatic' | 'fixed'.
    """

    position: np.ndarray
    axis: np.ndarray
    parent: int
    child: int
    jtype: str = "revolute"


@dataclasses.dataclass(frozen=True)
class NormInfo:
    """Normalization of one frame: corner boxes + 1/diagonal factors.

    Index 0 is the global (whole object) box; index j+1 is part j
    (reference: lib/data_utils.py:447-575).
    """

    corners: Sequence[np.ndarray]   # each (2, 3): min corner, max corner
    factors: Sequence[float]        # 1 / diagonal length

    @classmethod
    def from_parts(cls, parts_canon: Sequence[np.ndarray]) -> "NormInfo":
        allpts = np.concatenate(parts_canon, axis=0)
        boxes = [np.stack([allpts.min(0), allpts.max(0)])]
        boxes += [np.stack([p.min(0), p.max(0)]) for p in parts_canon]
        factors = [1.0 / max(float(np.linalg.norm(b[1] - b[0])), EPS) for b in boxes]
        return cls(corners=boxes, factors=factors)


def nocs_normalize(pts: np.ndarray, corner: np.ndarray, factor: float) -> np.ndarray:
    """Corner/diagonal NOCS normalization (lib/dataset.py:494).

    nocs = (pts - c0)*f + 0.5 - 0.5*(c1 - c0)*f  — i.e. centered on the
    box center, scaled by 1/diagonal, shifted to ~[0.5-ish] cube.
    """
    c0, c1 = corner[0], corner[1]
    return (pts - c0) * factor + 0.5 - 0.5 * (c1 - c0) * factor


def point_line_offset(position: np.ndarray, axis: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Perpendicular offset vectors from points to the line (P0, l).

    Mirrors lib/d3_utils.py:192-203: PP = (P0P·l) l/|l|² − P0P, the vector
    FROM each point TO its projection on the line.
    """
    l = axis.reshape(1, 3)
    P0P = points - position.reshape(1, 3)
    return (P0P @ l.T) * l / max(float(np.sum(l * l)), EPS) - P0P


class SyntheticArticulated:
    """Procedural category of articulated objects.

    Geometry: a base box with `n_parts - 1` flaps attached by joints at
    its ±x faces (revolute, z axis) or sliding along x (prismatic) —
    topologically the eyeglasses / laptop / drawer categories.
    """

    def __init__(self, n_parts: int = 3, points_per_part: int = 512,
                 joint_types: Optional[Sequence[str]] = None, seed: int = 0,
                 full_rotation: bool = True):
        self.n_parts = n_parts
        self.points_per_part = points_per_part
        self.joint_types = list(joint_types or ["revolute"] * (n_parts - 1))
        # full_rotation=False restricts camera poses to the reference
        # renderer's yaw/pitch band (tools/render_synthetic.py:116-127)
        # instead of uniform SO(3) — a much easier learning problem.
        self.full_rotation = full_rotation
        assert len(self.joint_types) == n_parts - 1
        rng = np.random.RandomState(seed)

        # canonical part boxes: base centered at origin, flaps outboard
        self.extents = [np.array([0.8, 0.25, 0.12])]
        self.centers = [np.zeros(3)]
        self.joints: List[JointSpec] = []
        for j in range(1, n_parts):
            side = 1.0 if j % 2 == 1 else -1.0
            ext = np.array([0.5, 0.2, 0.1]) * rng.uniform(0.8, 1.2)
            center = np.array([side * (0.4 + ext[0] / 2 + 0.02), 0.0, 0.0])
            self.extents.append(ext)
            self.centers.append(center)
            jt = self.joint_types[j - 1]
            if jt == "prismatic":
                axis = np.array([side, 0.0, 0.0])
            else:
                axis = np.array([0.0, 0.0, 1.0])
            pos = np.array([side * 0.4, 0.0, 0.0])
            self.joints.append(JointSpec(position=pos, axis=axis,
                                         parent=0, child=j, jtype=jt))

        # fixed canonical surface point sets per part
        self.parts_canon = [
            self._box_points(self.centers[j], self.extents[j], rng)
            for j in range(n_parts)
        ]
        self.norm = NormInfo.from_parts(self.parts_canon)

    def _box_points(self, center, ext, rng) -> np.ndarray:
        n = self.points_per_part
        pts = (rng.rand(n, 3) - 0.5) * ext.reshape(1, 3)
        # push points to the surface on a random axis for box-like shells
        ax = rng.randint(0, 3, size=n)
        sign = np.sign(rng.rand(n) - 0.5)
        pts[np.arange(n), ax] = sign * ext[ax] / 2
        return pts + center.reshape(1, 3)


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
