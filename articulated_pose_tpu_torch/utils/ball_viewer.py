"""Point-cloud ball renderer / interactive viewer: counterpart of
`articulated_pose_tpu/utils/ball_viewer.py`.

Capability twin of the reference's ctypes viewer
(pointnet_plusplus/utils/show3d_balls.py): point clouds rendered as
z-buffered shaded spheres, with mouse-rotate/zoom when an interactive
display is available.  Two differences by design:

- The rasterizer core is our own C++ (native/render_balls.cpp, built
  with g++ at first use and bound with ctypes) with a NumPy twin of the
  same semantics; the reference shipped only a prebuilt binary with no
  source.
- Headless-first: `render_points` returns a uint8 image and never needs
  a display, so it is usable from tests/CI and for dumping eval frames;
  `showpoints` adds the interactive cv2 loop when cv2 + a display exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from articulated_pose_tpu_torch import native


def _disk_template(radius: int):
    """Texel offsets within a ball: (dx, dy, dz, shade) arrays."""
    d = np.arange(-radius, radius + 1)
    dx, dy = np.meshgrid(d, d, indexing="ij")
    d2 = (dx * dx + dy * dy).astype(np.float32)
    keep = d2 <= radius * radius
    dx, dy, d2 = dx[keep], dy[keep], d2[keep]
    dz = np.sqrt(radius * radius - d2)
    shade = 0.3 + 0.7 * dz / float(radius)
    return dx.astype(np.int64), dy.astype(np.int64), dz, shade.astype(np.float32)


def _render_balls_numpy(image: np.ndarray, xyz: np.ndarray,
                        colors: np.ndarray, ballradius: int) -> None:
    """NumPy twin of native.render_balls_native (same z-buffer semantics).

    Painter's algorithm made exact: expand every (point, texel) candidate
    write, sort by depth ascending, write in order — the closest surface
    lands last, which is precisely what the per-pixel depth test in the
    C++ kernel computes.
    """
    h, w, _ = image.shape
    n = xyz.shape[0]
    if n == 0:
        return
    dx, dy, dz, shade = _disk_template(ballradius)
    x = xyz[:, 0:1].astype(np.int64) + dx[None, :]    # (N, T)
    y = xyz[:, 1:2].astype(np.int64) + dy[None, :]
    depth = xyz[:, 2:3].astype(np.float32) + dz[None, :]
    rgb = (colors[:, None, :].astype(np.float32)
           * shade[None, :, None])                    # (N, T, 3)
    valid = (x >= 0) & (x < h) & (y >= 0) & (y < w)
    pix = (x * w + y)[valid]
    depth = depth[valid]
    rgb = np.clip(rgb[valid], 0, 255)
    order = np.argsort(depth, kind="stable")
    flat = image.reshape(-1, 3)
    flat[pix[order]] = rgb[order].astype(np.uint8)


def render_points(xyz: np.ndarray, colors: Optional[np.ndarray] = None,
                  size: int = 800, ballradius: int = 10,
                  background: Tuple[int, int, int] = (0, 0, 0),
                  xangle: float = 0.0, yangle: float = 0.0,
                  zoom: float = 1.0, normalizecolor: bool = True,
                  use_native: Optional[bool] = None) -> np.ndarray:
    """Render a cloud to a (size, size, 3) uint8 image, headless.

    Normalization, the two-axis mouse rotation parameterization, and the
    per-channel color normalization follow the reference viewer's screen
    mapping (show3d_balls.py:26-73) so saved frames look the same.
    `use_native`: None takes the C++ rasterizer where it builds, True
    takes it or raises, False takes the NumPy one.
    """
    xyz = np.asarray(xyz, np.float64)
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    radius = float(np.sqrt((xyz ** 2).sum(-1)).max()) or 1.0
    xyz = xyz / ((radius * 2.2) / size)

    if colors is None:
        colors = np.full((len(xyz), 3), 255.0, np.float32)
    else:
        colors = np.asarray(colors, np.float32).copy()
        if normalizecolor:
            colors /= (colors.max(axis=0, keepdims=True) + 1e-14) / 255.0

    cx, sx = np.cos(xangle), np.sin(xangle)
    cy, sy = np.cos(yangle), np.sin(yangle)
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    rotmat = rot_x @ rot_y * zoom
    nxyz = xyz @ rotmat + np.array([size / 2.0, size / 2.0, 0.0])
    ixyz = nxyz.astype(np.int32)

    image = np.empty((size, size, 3), np.uint8)
    image[:] = np.asarray(background, np.uint8)
    if use_native is None:
        use_native = native.available()
    if use_native:
        native.render_balls_native(image, ixyz, colors, ballradius)
    else:
        _render_balls_numpy(image, ixyz, colors, ballradius)
    return image


def showpoints(xyz: np.ndarray, colors: Optional[np.ndarray] = None,
               size: int = 800, ballradius: int = 10,
               background: Tuple[int, int, int] = (0, 0, 0),
               save_path: Optional[str] = None) -> Optional[np.ndarray]:
    """Interactive viewer when cv2 + a display are available; otherwise
    render one frame headlessly (returned, and saved if save_path).

    Keys (interactive mode): q quit, +/- zoom, arrows rotate — the same
    interaction surface as the reference viewer, without requiring the
    mouse-callback path.
    """
    try:
        import cv2  # type: ignore
        interactive = bool(cv2.getWindowProperty) and bool(
            __import__("os").environ.get("DISPLAY"))
    except Exception:
        interactive = False

    if not interactive:
        img = render_points(xyz, colors, size=size, ballradius=ballradius,
                            background=background)
        if save_path:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.imshow(img)
            ax.axis("off")
            fig.savefig(save_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
        return img

    xangle, yangle, zoom = 0.0, 0.0, 1.0
    cv2.namedWindow("show3d")
    while True:
        img = render_points(xyz, colors, size=size, ballradius=ballradius,
                            background=background, xangle=xangle,
                            yangle=yangle, zoom=zoom)
        cv2.imshow("show3d", img[:, :, ::-1])
        cmd = cv2.waitKey(10) % 256
        if cmd == ord("q"):
            break
        elif cmd in (ord("+"), ord("=")):
            zoom *= 1.1
        elif cmd == ord("-"):
            zoom /= 1.1
        elif cmd == 81:   # left
            yangle -= 0.1
        elif cmd == 83:   # right
            yangle += 0.1
        elif cmd == 82:   # up
            xangle -= 0.1
        elif cmd == 84:   # down
            xangle += 0.1
    cv2.destroyWindow("show3d")
    return None
