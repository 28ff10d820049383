"""Visualization utilities (matplotlib, headless-safe): counterpart of
`articulated_pose_tpu/utils/vis.py`.

Equivalent of the reference's debug plotting layer (reference:
lib/vis_utils.py:96-470): multi-set 3D scatter, per-point offset arrows,
joint-line overlays, histograms.  All functions save to file when
`save_path` is given.  matplotlib is imported at the call, with the Agg
backend; without it each function raises ImportError naming it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    """matplotlib.pyplot on the Agg backend (no display needed)."""
    try:
        import matplotlib
    except ImportError:
        raise ImportError("the plots of utils/vis.py need matplotlib, "
                          "which is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot3d_pts(pts_list: Sequence[Sequence[np.ndarray]],
               names: Optional[Sequence[Sequence[str]]] = None,
               title: str = "", s: float = 2.0,
               save_path: Optional[str] = None, color_channel=None):
    """Grid of 3D scatters; pts_list[i][j] is point set j of subplot i
    (lib/vis_utils.py:96-196)."""
    plt = _plt()
    n = len(pts_list)
    fig = plt.figure(figsize=(5 * n, 5))
    for i, sets in enumerate(pts_list):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        for j, p in enumerate(sets):
            label = names[i][j] if names else f"set {j}"
            if color_channel is not None:
                ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=s,
                           c=np.clip(color_channel[i][j], 0, 1))
            else:
                ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=s, label=label)
        ax.legend(loc="upper right", fontsize=6)
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig


def plot_arrows(points: np.ndarray, offsets: np.ndarray,
                joint: Optional[Dict] = None, sparse: int = 20,
                title: str = "", save_path: Optional[str] = None):
    """Per-point offset arrows + optional joint line
    (lib/vis_utils.py:223-289)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2)
    sel = np.arange(0, len(points), max(1, len(points) // sparse))
    ax.quiver(points[sel, 0], points[sel, 1], points[sel, 2],
              offsets[sel, 0], offsets[sel, 1], offsets[sel, 2],
              color="r", length=1.0)
    if joint is not None:
        p0 = np.asarray(joint["point"]).reshape(3)
        a = np.asarray(joint["axis"]).reshape(3)
        line = p0[None] + np.linspace(-0.5, 0.5, 10)[:, None] * a[None]
        ax.plot(line[:, 0], line[:, 1], line[:, 2], "g-", linewidth=3)
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig


def plot_bbox(ax_or_path, bbox: np.ndarray, pts: Optional[np.ndarray] = None,
              title: str = ""):
    """Wireframe oriented box (8 corners in eval.metrics.get_3d_bbox
    order) with optional points (lib/vis_utils.py:346)."""
    plt = _plt()
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    own = isinstance(ax_or_path, str)
    if own:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = ax_or_path
    for a, b in edges:
        ax.plot(*np.stack([bbox[a], bbox[b]], 1), "b-")
    if pts is not None:
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="gray")
    ax.set_title(title)
    if own:
        fig.savefig(ax_or_path, dpi=90)
        plt.close(fig)


def plot_arrows_list(points_list: Sequence[np.ndarray],
                     offsets_list: Sequence[np.ndarray],
                     joints: Optional[Sequence[Dict]] = None,
                     titles: Optional[Sequence[str]] = None, sparse: int = 20,
                     save_path: Optional[str] = None):
    """Row of arrow plots, one subplot per (points, offsets[, joint])
    triple (lib/vis_utils.py:291-344 plot_arrows_list)."""
    plt = _plt()
    n = len(points_list)
    fig = plt.figure(figsize=(5 * n, 5))
    for i in range(n):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        p, off = points_list[i], offsets_list[i]
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2)
        sel = np.arange(0, len(p), max(1, len(p) // sparse))
        ax.quiver(p[sel, 0], p[sel, 1], p[sel, 2],
                  off[sel, 0], off[sel, 1], off[sel, 2], color="r")
        if joints is not None and joints[i] is not None:
            p0 = np.asarray(joints[i]["point"]).reshape(3)
            a = np.asarray(joints[i]["axis"]).reshape(3)
            line = p0[None] + np.linspace(-0.5, 0.5, 10)[:, None] * a[None]
            ax.plot(line[:, 0], line[:, 1], line[:, 2], "g-", linewidth=3)
        if titles:
            ax.set_title(titles[i])
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig


def plot_joints_bb_list(pts: np.ndarray, bboxes: Sequence[np.ndarray],
                        joints: Sequence[Dict], title: str = "",
                        save_path: Optional[str] = None):
    """Posed per-part boxes + joint lines over the input cloud
    (lib/vis_utils.py:346-430 plot_joints_bb_list)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="gray")
    for b in bboxes:
        plot_bbox(ax, np.asarray(b))
    for j in joints:
        if j is None:
            continue
        p0 = np.asarray(j["point"]).reshape(3)
        a = np.asarray(j["axis"]).reshape(3)
        line = p0[None] + np.linspace(-0.5, 0.5, 10)[:, None] * a[None]
        ax.plot(line[:, 0], line[:, 1], line[:, 2], "g-", linewidth=3)
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig


def draw_segmentation_2d(image: np.ndarray, mask: np.ndarray,
                         n_parts: int, alpha: float = 0.5,
                         save_path: Optional[str] = None):
    """Per-part segmentation overlay on an RGB image
    (lib/vis_utils.py:508-571 2D draws, matplotlib instead of cv2)."""
    plt = _plt()
    cmap = plt.get_cmap("tab10")
    over = np.asarray(image, np.float64).copy()
    if over.max() > 1.0:
        over /= 255.0
    for j in range(n_parts):
        sel = mask == j
        color = np.asarray(cmap(j % 10)[:3])
        over[sel] = (1 - alpha) * over[sel] + alpha * color
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.clip(over, 0, 1))
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=90, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def viz_err_distri(errs: np.ndarray, bins: int = 30, title: str = "",
                   save_path: Optional[str] = None):
    """Error-distribution plot (lib/vis_utils.py:470-506 hist/cdf)."""
    plt = _plt()
    errs = np.asarray(errs).ravel()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    a1.hist(errs, bins=bins)
    a1.set_title(f"{title} histogram")
    xs = np.sort(errs)
    a2.plot(xs, np.arange(1, len(xs) + 1) / len(xs))
    a2.set_title(f"{title} CDF")
    a2.set_ylim(0, 1)
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig


def hist_show(values: Sequence[np.ndarray], labels: Sequence[str],
              bins: int = 50, title: str = "",
              save_path: Optional[str] = None):
    """Error histograms (lib/vis_utils.py:470)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for v, lab in zip(values, labels):
        ax.hist(np.asarray(v).ravel(), bins=bins, alpha=0.5, label=lab)
    ax.legend()
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=90)
        plt.close(fig)
        return None
    return fig
