"""Synthetic articulated-object generator: a NumPy copy of
`articulated_pose_tpu/data/synthetic.py`; for a seed its frames equal
the JAX package's bit for bit, on the NumPy labeling path
(`use_native=False`) and on the C++ one (`native/`), and `export_hdf5`
writes the same files (it needs h5py, imported at the call).

The reference pipelines Shape2Motion/SAPIEN assets through PyBullet
renders into HDF5 (reference: tools/render_synthetic.py,
tools/preprocess_data.py).  This module generates equivalent samples
procedurally — multi-part objects with revolute/prismatic joints,
articulated and placed with a random camera similarity — with exact
ground-truth poses attached.  It drives unit tests, the end-to-end
training smoke tests and the benchmark when no dataset is mounted.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from articulated_pose_tpu_torch import native
from articulated_pose_tpu_torch.data.labeling import JointSpec, NormInfo, build_sample
from articulated_pose_tpu_torch.utils import transforms as tr


def sample_mesh_points(vertices: np.ndarray, faces: np.ndarray, n: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Area-weighted surface sampling of a triangle mesh (synthetic.py:24).

    The capability behind the reference's ProbSample op self-test
    (reference: tf_ops/sampling/tf_sampling.py:60-89 — cumsum over
    triangle areas + inverse-CDF draw + barycentric placement).
    """
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    cdf = np.cumsum(areas)
    cdf = cdf / cdf[-1]
    tri = np.searchsorted(cdf, rng.rand(n), side="right")
    tri = np.minimum(tri, len(faces) - 1)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri])


@dataclasses.dataclass
class FrameGT:
    """Ground truth for one rendered frame."""

    # per part: 4x4 similarity mapping part-NOCS -> network input frame
    # (camera points scaled by the global norm factor, lib/dataset.py:351)
    rt_nocs2cam: List[np.ndarray]
    scales: List[float]
    # per joint: axis direction + a point on the axis, in the input frame
    joint_axes_cam: List[np.ndarray]
    joint_points_cam: List[np.ndarray]
    # articulation state (angle in rad, or translation for prismatic)
    states: List[float]
    # per part: 4x4 similarity mapping global NAOCS -> input frame (the
    # GT the NAOCS baseline is scored against, baseline_naocs.py:216-218)
    rt_naocs2cam: List[np.ndarray] = None


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

    # ------------------------------------------------------------------
    def articulation_transforms(self, states: Sequence[float]) -> List[np.ndarray]:
        """4x4 canonical->articulated transform per part."""
        mats = [np.eye(4)]
        for j in range(1, self.n_parts):
            jt = self.joints[j - 1]
            if jt.jtype == "revolute":
                mats.append(tr.rotation_about_line(jt.axis, jt.position, states[j - 1]))
            elif jt.jtype == "prismatic":
                mats.append(tr.translation_along(jt.axis, states[j - 1]))
            else:
                mats.append(np.eye(4))
        return mats

    def frame(self, rng: np.random.RandomState, *, num_points: int = 1024,
              n_max_parts: Optional[int] = None, nocs_type: str = "AC",
              noise: float = 0.0, use_native: Optional[bool] = None):
        """Generate one frame: (sample_dict, FrameGT).

        use_native selects the C++ labeling fast path (native/): None
        takes it where the library builds and the output layout matches
        (nocs_type 'AC', n_max_parts equal to the part count); True takes
        it and raises if the library does not build; False takes the
        NumPy labeling.
        """
        K = n_max_parts or self.n_parts
        states = []
        for jt in self.joint_types:
            if jt == "prismatic":
                states.append(rng.uniform(0.0, 0.3))
            elif jt == "revolute":
                states.append(rng.uniform(-1.2, 1.2))
            else:
                states.append(0.0)
        art = self.articulation_transforms(states)

        s_cam = rng.uniform(0.8, 1.2)
        if self.full_rotation:
            R_cam = tr.random_rotation(rng)
        else:
            yaw = rng.uniform(0, 2 * np.pi)
            pitch = rng.uniform(np.radians(-75), np.radians(-15))
            R_cam = (tr.axis_angle_matrix(np.array([1.0, 0, 0]), pitch)
                     @ tr.axis_angle_matrix(np.array([0.0, 0, 1]), yaw))
        t_cam = rng.uniform(-0.5, 0.5, size=3)
        cam = tr.similarity(s_cam, R_cam, t_cam)

        parts_pts = []
        for j in range(self.n_parts):
            p = tr.apply_similarity(cam @ art[j], self.parts_canon[j])
            if noise > 0:
                p = p + rng.randn(*p.shape) * noise
            parts_pts.append(p)

        if use_native is None:
            use_native = nocs_type == "AC" and K == self.n_parts \
                and native.available()
        if use_native:
            sample = native.build_labels_native(
                parts_pts, self.parts_canon, self.joints, self.norm,
                num_points=num_points, n_max_parts=K, rng=rng)
        else:
            sample = build_sample(parts_pts, self.parts_canon, self.joints,
                                  self.norm, num_points=num_points,
                                  n_max_parts=K, nocs_type=nocs_type, rng=rng)

        # ground-truth per-part similarity: NOCS -> input frame.
        # nocs = f_j*(X - box_center_j) + 0.5  =>  X = (nocs-0.5)/f_j + bc_j
        f0 = self.norm.factors[0]
        input_scale = np.eye(4) * f0
        input_scale[3, 3] = 1.0
        rts, scales, rts_g = [], [], []
        gc = (self.norm.corners[0][0] + self.norm.corners[0][1]) / 2.0
        naocs2canon = tr.similarity(1.0 / f0, np.eye(3), gc - 0.5 / f0)
        for j in range(self.n_parts):
            fj = self.norm.factors[j + 1]
            c = self.norm.corners[j + 1]
            bc = (c[0] + c[1]) / 2.0
            nocs2canon = tr.similarity(1.0 / fj, np.eye(3), bc - 0.5 / fj)
            T = input_scale @ cam @ art[j] @ nocs2canon
            rts.append(T)
            scales.append(tr.decompose_similarity(T)[0])
            rts_g.append(input_scale @ cam @ art[j] @ naocs2canon)

        jaxes, jpoints = [], []
        for jt in self.joints:
            jaxes.append(R_cam @ jt.axis)
            jpoints.append(f0 * (tr.apply_similarity(cam, jt.position.reshape(1, 3))[0]))

        gt = FrameGT(rt_nocs2cam=rts, scales=scales, joint_axes_cam=jaxes,
                     joint_points_cam=jpoints, states=states,
                     rt_naocs2cam=rts_g)
        return sample, gt

    def export_hdf5(self, root_dir: str, category: str, *,
                    n_instances: int = 2, frames_per_instance: int = 4,
                    num_expr: str = "0.01", seed: int = 0,
                    test_fraction: float = 0.25,
                    instance_names: Optional[Sequence[str]] = None):
        """Write frames to disk in the reference HDF5 layout.

        Produces <root>/hdf5/<cat>/<ins>/<art>/<frame>.h5 with
        gt_points/<part> + gt_coords/<part> groups (the schema of
        tools/preprocess_data.py:337-348), per-instance
        <root>/info/<cat>/<ins>/model_info.json, and split txts —
        enabling full-loader tests and demo runs with no external data.
        """
        import h5py

        from articulated_pose_tpu_torch.data.hdf5_dataset import InstanceInfo

        rng = np.random.RandomState(seed)
        train_files, test_files = [], []
        names = (list(instance_names) if instance_names is not None
                 else [f"{i:04d}" for i in range(n_instances)])
        for ins in names:
            info_dir = os.path.join(root_dir, "info", category, ins)
            os.makedirs(info_dir, exist_ok=True)
            InstanceInfo(self.norm, list(self.joints)).dump(
                os.path.join(info_dir, "model_info.json"))
            for fr in range(frames_per_instance):
                states = [rng.uniform(-1.0, 1.0) if jt == "revolute"
                          else rng.uniform(0.0, 0.3)
                          for jt in self.joint_types]
                art = self.articulation_transforms(states)
                s_cam = rng.uniform(0.8, 1.2)
                cam = tr.similarity(s_cam, tr.random_rotation(rng),
                                    rng.uniform(-0.5, 0.5, 3))
                rel = os.path.join("hdf5", category, ins, "0", f"{fr}.h5")
                full = os.path.join(root_dir, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with h5py.File(full, "w") as f:
                    gp = f.create_group("gt_points")
                    gc = f.create_group("gt_coords")
                    for j in range(self.n_parts):
                        pts = tr.apply_similarity(cam @ art[j], self.parts_canon[j])
                        gp.create_dataset(str(j), data=pts.astype(np.float32))
                        gc.create_dataset(str(j),
                                          data=self.parts_canon[j].astype(np.float32))
                (test_files if fr >= frames_per_instance * (1 - test_fraction)
                 else train_files).append(rel)
        split_dir = os.path.join(root_dir, "splits", category, num_expr)
        os.makedirs(split_dir, exist_ok=True)
        for name, files in (("train", train_files), ("test", test_files)):
            with open(os.path.join(split_dir, f"{name}.txt"), "w") as f:
                f.write("\n".join(files) + "\n")
        return train_files, test_files

    def batch(self, rng: np.random.RandomState, batch_size: int, *,
              num_points: int = 1024, n_max_parts: Optional[int] = None,
              nocs_type: str = "AC", noise: float = 0.0):
        """Stacked batch of frames: (dict of (B, ...) arrays, list of FrameGT)."""
        samples, gts = [], []
        for _ in range(batch_size):
            s, g = self.frame(rng, num_points=num_points,
                              n_max_parts=n_max_parts, nocs_type=nocs_type,
                              noise=noise)
            samples.append(s)
            gts.append(g)
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        return batch, gts
