"""The general traffic generator: every mix under `traffic/` is a file of
parameters that these functions read.  All of it is NumPy from the run's
seed, so the same seed gives the same traffic on any machine.

- `object_pool`: distinct articulated objects, each a cloud of N points
  in its camera frame.  The geometry is the port's synthetic category
  (`data/synthetic.py::SyntheticArticulated`): a base box of extent
  (0.8, 0.25, 0.12) with flaps of extent (0.5, 0.2, 0.1) × U(0.8, 1.2)
  on its ±x faces, each on a revolute joint about z through (±0.4, 0,
  0) at a state in U(−1.2, 1.2); points on the boxes' surfaces; a
  camera similarity of scale U(0.8, 1.2), a uniform rotation and a
  translation in U(−0.5, 0.5)³, all over the object's diagonal.
- `batches`: the closed loop's batches, each cloud of the pool under a
  fresh rigid motion and Gaussian noise, so no two clouds of the ring
  repeat.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

BASE_EXTENT = np.array([0.8, 0.25, 0.12])
FLAP_EXTENT = np.array([0.5, 0.2, 0.1])


def _rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """n uniform rotations (n, 3, 3), from normalised Gaussian
    quaternions."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a, b, c, d = q.T
    return np.stack([
        np.stack([a*a+b*b-c*c-d*d, 2*(b*c-a*d), 2*(b*d+a*c)], -1),
        np.stack([2*(b*c+a*d), a*a-b*b+c*c-d*d, 2*(c*d-a*b)], -1),
        np.stack([2*(b*d-a*c), 2*(c*d+a*b), a*a-b*b-c*c+d*d], -1)], -2)


def _box_shell(rng: np.random.Generator, n_obj: int, n: int,
               ext: np.ndarray) -> np.ndarray:
    """(n_obj, n, 3) points on the surfaces of boxes centred at 0 with
    extents ext (n_obj, 3): uniform in the box, one random axis pushed
    to a face."""
    pts = (rng.random((n_obj, n, 3)) - 0.5) * ext[:, None, :]
    ax = rng.integers(0, 3, size=(n_obj, n))
    sign = np.where(rng.random((n_obj, n)) < 0.5, -1.0, 1.0)
    face = sign * np.take_along_axis(ext, ax, axis=1) / 2
    np.put_along_axis(pts, ax[..., None], face[..., None], axis=2)
    return pts


def object_pool(seed: int, n_objects: int, points: int) -> np.ndarray:
    """(n_objects, points, 3) float32 articulated clouds of 3 parts
    (base and two flaps, points split evenly, the remainder to the
    base), each in a camera frame of its own."""
    rng = np.random.default_rng(seed)
    per = points // 3
    sizes = [points - 2 * per, per, per]
    parts = [_box_shell(rng, n_objects, sizes[0],
                        np.tile(BASE_EXTENT, (n_objects, 1)))]
    for j, side in ((1, 1.0), (2, -1.0)):
        ext = FLAP_EXTENT * rng.uniform(0.8, 1.2, (n_objects, 1))
        centre = np.zeros((n_objects, 3))
        centre[:, 0] = side * (0.4 + ext[:, 0] / 2 + 0.02)
        pts = _box_shell(rng, n_objects, sizes[j], ext) + centre[:, None]
        # revolute about z through (side * 0.4, 0, 0)
        angle = rng.uniform(-1.2, 1.2, n_objects)
        c, s = np.cos(angle)[:, None], np.sin(angle)[:, None]
        x = pts[..., 0] - side * 0.4
        y = pts[..., 1]
        pts = np.stack([c * x - s * y + side * 0.4, s * x + c * y,
                        pts[..., 2]], -1)
        parts.append(pts)
    cloud = np.concatenate(parts, axis=1)
    R = _rotations(rng, n_objects)
    scale = rng.uniform(0.8, 1.2, (n_objects, 1, 1))
    t = rng.uniform(-0.5, 0.5, (n_objects, 1, 3))
    # in units of the object's diagonal, as the port's frames are
    # (`DeviceSynthetic` scales by the global NOCS factor)
    diag = np.linalg.norm(cloud.max(axis=1) - cloud.min(axis=1), axis=1)
    cloud = (scale * cloud @ R.transpose(0, 2, 1) + t) / diag[:, None, None]
    # each cloud's points in an order of their own
    order = np.argsort(rng.random((n_objects, points)), axis=1)
    cloud = np.take_along_axis(cloud, order[..., None], axis=1)
    return cloud.astype(np.float32)


def moved(rng: np.random.Generator, clouds: np.ndarray, noise: float
          ) -> np.ndarray:
    """Each cloud under a fresh rigid motion (a uniform rotation about
    its centroid, a shift in U(−0.2, 0.2)³) and Gaussian noise."""
    n = len(clouds)
    R = _rotations(rng, n)
    centre = clouds.mean(axis=1, keepdims=True)
    shift = rng.uniform(-0.2, 0.2, (n, 1, 3))
    out = (clouds - centre) @ R.transpose(0, 2, 1) + centre + shift
    out = out + noise * rng.standard_normal(out.shape)
    return out.astype(np.float32)


def batches(seed: int, mix: Dict) -> List[np.ndarray]:
    """The closed loop's ring of `mix["ring"]` batches of
    `mix["batch"]` clouds of `mix["points"]` points."""
    pool = object_pool(seed, mix["pool"], mix["points"])
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(mix["ring"]):
        pick = rng.integers(0, len(pool), mix["batch"])
        out.append(moved(rng, pool[pick], mix["noise"]))
    return out
