"""ctypes bindings to the native (C++) fast paths: counterpart of
`articulated_pose_tpu/native/__init__.py`.

`labeling.cpp` and `render_balls.cpp` are built together at first use
with `g++ -O3 -fPIC -shared -std=c++17` into one library in the
package's `_build/` (listed in `.gitignore`), keyed by a hash of the
sources and the flags, and loaded through ctypes.
`build_labels_native` has the interface and semantics of
`data.labeling.build_sample`'s inner math ('AC' layout);
`render_balls_native` is `utils/ball_viewer.py`'s rasterizer.
`available()` says whether the library builds and loads (`render_available()`
whether it holds the renderer, as JAX's); `load()` raises
with the compiler's message when it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "labeling.cpp"
RENDER_SOURCE = SOURCE.with_name("render_balls.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_JT = {"revolute": 0, "prismatic": 1, "fixed": 2}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("native library: no C++ compiler (g++ or $CXX)")
    return cxx


def _build() -> pathlib.Path:
    """Compile the sources into _build/ unless that exact build exists."""
    cxx = _compiler()
    sources = [SOURCE, RENDER_SOURCE]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                            + " ".join([cxx, *CXX_FLAGS]).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"native_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                           *(str(s) for s in sources)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native library: {cxx} failed (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built and bound library; raises RuntimeError when it does not
    build or load (the failure is kept: later calls raise it at once)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _error = str(e)
            else:
                c_f32 = ctypes.POINTER(ctypes.c_float)
                c_f64 = ctypes.POINTER(ctypes.c_double)
                c_i32 = ctypes.POINTER(ctypes.c_int32)
                lib.ancsh_build_labels.restype = ctypes.c_int
                lib.ancsh_build_labels.argtypes = [
                    c_f32, c_f32, c_i32, ctypes.c_int32, ctypes.c_int32,
                    c_f64, c_f64,
                    c_f64, c_f64, c_i32, c_i32, c_i32, ctypes.c_int32,
                    ctypes.c_double, c_i32, ctypes.c_int32, ctypes.c_int32,
                    c_f32, c_f32, c_f32, c_f32, c_f32,
                    c_f32, c_f32, c_f32, c_f32, c_f32, c_f32,
                ]
                lib.ancsh_render_balls.restype = ctypes.c_int
                lib.ancsh_render_balls.argtypes = [
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, c_i32,
                    c_f32, c_f32, c_f32, ctypes.c_int32,
                ]
                _lib = lib
                return _lib
        raise RuntimeError(f"the native library is unavailable: "
                           f"{_error}")


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def render_available() -> bool:
    """Whether the ball renderer's entry loads (native/__init__.py:162):
    the library builds, and it holds `ancsh_render_balls`."""
    return available() and hasattr(load(), "ancsh_render_balls")


def build_labels_native(parts_pts: Sequence[np.ndarray],
                        parts_canon: Sequence[np.ndarray],
                        joints, norm, *, num_points: int,
                        n_max_parts: int, thres_r: float = 0.2,
                        sel: Optional[np.ndarray] = None,
                        rng: Optional[np.random.RandomState] = None
                        ) -> Dict[str, np.ndarray]:
    """C++ twin of labeling.build_sample (nocs_type='AC' layout); draws
    `sel` from `rng` as build_sample does when it is not given."""
    lib = load()
    n_parts = len(parts_pts)
    if n_parts > n_max_parts or len(joints) > 15:
        raise ValueError(f"native labeling takes at most n_max_parts parts "
                         f"and 15 joints, got {n_parts} parts and "
                         f"{len(joints)} joints")
    pts = np.ascontiguousarray(np.concatenate(parts_pts, 0), np.float32)
    canon = np.ascontiguousarray(np.concatenate(parts_canon, 0), np.float32)
    part_of = np.concatenate([np.full(len(p), j, np.int32)
                              for j, p in enumerate(parts_pts)])
    n_total = pts.shape[0]
    corners = np.ascontiguousarray(
        np.stack([np.asarray(c, np.float64) for c in norm.corners]), np.float64)
    factors = np.ascontiguousarray(np.asarray(norm.factors, np.float64))
    n_joints = len(joints)
    jpos = np.ascontiguousarray(
        np.stack([np.asarray(j.position, np.float64).reshape(3) for j in joints])
        if n_joints else np.zeros((0, 3)))
    jaxis = np.ascontiguousarray(
        np.stack([np.asarray(j.axis, np.float64).reshape(3) for j in joints])
        if n_joints else np.zeros((0, 3)))
    jparent = np.asarray([j.parent for j in joints], np.int32)
    jchild = np.asarray([j.child for j in joints], np.int32)
    jtype = np.asarray([_JT[j.jtype] for j in joints], np.int32)

    if sel is None:
        rng = rng or np.random.RandomState(0)
        if n_total < num_points:
            tile_n = num_points // n_total + 1
            sel = rng.permutation(tile_n * n_total)[:num_points]
        else:
            sel = rng.permutation(n_total)[:num_points]
    sel = np.ascontiguousarray(sel, np.int32)
    if sel.shape != (num_points,):
        raise ValueError(f"sel must have shape ({num_points},), got "
                         f"{sel.shape}")

    P = np.empty((num_points, 3), np.float32)
    cls = np.empty((num_points,), np.float32)
    mask = np.empty((num_points, n_max_parts), np.float32)
    nocs = np.empty((num_points, 3), np.float32)
    nocs_g = np.empty((num_points, 3), np.float32)
    heat = np.empty((num_points,), np.float32)
    unitv = np.empty((num_points, 3), np.float32)
    orient = np.empty((num_points, 3), np.float32)
    jcls = np.empty((num_points,), np.float32)
    jmask = np.empty((num_points,), np.float32)
    jparams = np.empty((n_max_parts, 7), np.float32)

    def fp32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def fp64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def ip32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.ancsh_build_labels(
        fp32(pts), fp32(canon), ip32(part_of),
        np.int32(n_total), np.int32(n_parts),
        fp64(corners), fp64(factors),
        fp64(jpos), fp64(jaxis), ip32(jparent), ip32(jchild), ip32(jtype),
        np.int32(n_joints), ctypes.c_double(thres_r),
        ip32(sel), np.int32(num_points), np.int32(n_max_parts),
        fp32(P), fp32(cls), fp32(mask), fp32(nocs), fp32(nocs_g),
        fp32(heat), fp32(unitv), fp32(orient), fp32(jcls), fp32(jmask),
        fp32(jparams))
    if rc != 0:
        raise RuntimeError(f"native labeling failed rc={rc}")
    return {
        "P": P, "cls_gt": cls, "mask_array": mask, "nocs_gt": nocs,
        "nocs_gt_g": nocs_g, "heatmap_gt": heat, "unitvec_gt": unitv,
        "orient_gt": orient, "joint_cls_gt": jcls, "joint_cls_mask": jmask,
        "joint_params_gt": jparams,
    }


def render_balls_native(image: np.ndarray, xyz: np.ndarray,
                        colors: np.ndarray, ballradius: int) -> None:
    """Z-buffered sphere splatting into `image` (H, W, 3 uint8, C order),
    in place (the JAX package's native/__init__.py:164-190).  xyz is
    (N, 3) int32 screen coordinates (row, col, depth; larger depth is
    closer); colors (N, 3) float32 in [0, 255].  Native twin of
    utils.ball_viewer._render_balls_numpy."""
    lib = load()
    if (image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3
            or not image.flags.c_contiguous):
        raise ValueError("image must be a C-contiguous (H, W, 3) uint8 array")
    xyz = np.ascontiguousarray(xyz, np.int32)
    r, g, b = (np.ascontiguousarray(colors[:, c], np.float32)
               for c in range(3))

    def fp32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    rc = lib.ancsh_render_balls(
        np.int32(image.shape[0]), np.int32(image.shape[1]),
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(xyz.shape[0]),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fp32(r), fp32(g), fp32(b), np.int32(ballradius))
    if rc != 0:
        raise RuntimeError(f"native ball render failed rc={rc}")
