"""PyBullet synthetic renderer (gated: pybullet is optional); counterpart
of `articulated_pose_tpu/tools/render.py`.

Equivalent of the reference renderer (reference:
tools/render_synthetic.py:52-244): loads per-part URDFs in DIRECT mode,
drives joints to sampled articulation states, waits for convergence, and
captures depth/RGB/segmentation from randomized viewpoints, recording
viewMat/projMat/link poses per frame for the preprocessor.

pybullet is imported when a renderer is made, never at module import;
without it the constructor raises ImportError pointing at the procedural
generator (data/synthetic.py), which covers everything downstream.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _pybullet():
    try:
        import pybullet  # type: ignore
    except ImportError:
        raise ImportError(
            "pybullet is not installed in this environment; use "
            "articulated_pose_tpu_torch.data.synthetic.SyntheticArticulated "
            "(procedural frames with exact GT) instead") from None
    return pybullet


class PyBulletRenderer:
    """Randomized-viewpoint depth/RGB/mask renderer for articulated URDFs."""

    def __init__(self, urdf_paths: Sequence[str], width: int = 512,
                 height: int = 512, fov: float = 75.0):
        self.pb = pb = _pybullet()
        self.width, self.height, self.fov = width, height, fov
        self.client = pb.connect(pb.DIRECT)
        self.bodies = [pb.loadURDF(p) for p in urdf_paths]

    def set_articulation(self, states: Sequence[float],
                         settle_steps: int = 240) -> None:
        pb = self.pb
        body = self.bodies[0]
        for j, q in enumerate(states):
            pb.setJointMotorControl2(body, j, pb.POSITION_CONTROL,
                                     targetPosition=q)
        for _ in range(settle_steps):
            pb.stepSimulation()

    def capture(self, yaw: float, pitch: float, dist: float = 2.0,
                target=(0.0, 0.0, 0.0)) -> Dict[str, np.ndarray]:
        pb = self.pb
        view = pb.computeViewMatrixFromYawPitchRoll(
            cameraTargetPosition=target, distance=dist, yaw=yaw, pitch=pitch,
            roll=0, upAxisIndex=2)
        proj = pb.computeProjectionMatrixFOV(
            fov=self.fov, aspect=self.width / self.height,
            nearVal=0.1, farVal=10.0)
        w, h, rgb, depth, seg = pb.getCameraImage(
            self.width, self.height, view, proj,
            renderer=pb.ER_TINY_RENDERER)
        link_states = []
        for body in self.bodies:
            n = pb.getNumJoints(body)
            pos0, orn0 = pb.getBasePositionAndOrientation(body)
            states = [(pos0, orn0)]
            for j in range(n):
                ls = pb.getLinkState(body, j)
                states.append((ls[4], ls[5]))
            link_states.append(states)
        return {
            "rgb": np.asarray(rgb).reshape(h, w, -1)[..., :3],
            "depth": np.asarray(depth).reshape(h, w),
            "seg": np.asarray(seg).reshape(h, w),
            "viewMat": np.asarray(view).reshape(4, 4),
            "projMat": np.asarray(proj).reshape(4, 4),
            "link_states": link_states,
        }

    def close(self):
        self.pb.disconnect(self.client)


def random_viewpoints(rng: np.random.RandomState, n: int,
                      yaw_range=(0.0, 360.0), pitch_range=(-75.0, -15.0),
                      dist_range=(1.5, 2.5)):
    """Viewpoint sampling matching the reference's randomized camera
    (tools/render_synthetic.py:116-127)."""
    return [(rng.uniform(*yaw_range), rng.uniform(*pitch_range),
             rng.uniform(*dist_range)) for _ in range(n)]
