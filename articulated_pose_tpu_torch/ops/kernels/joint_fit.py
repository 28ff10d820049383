"""The joint stage of the pose fit in one launch: the kernel entry
`joint_fit` over `csrc/joint_fit.cu`.

It replaces no TPU kernel: the JAX package solves the joints with XLA
ops (`articulated_pose_tpu/pose/pipeline.py:256-320`), and the port's
plain version (`pose/pipeline.py::joint_fit_plain`) launches ~5,700
small kernels a joint.  One CTA solves one (frame, joint) problem: the
alternating-Kabsch hypotheses, their inlier counts over both parts'
score prefix, the best one's inlier sets and the damped Gauss-Newton
refit, for every joint of the batch in one launch.  What feeds a vote
is computed in the plain path's order and rounding on the card, so the
kernel picks the hypotheses and the inliers the plain path picks.

`launch_config` reads the launch's scalars from the fit config and the
buffers' shape alone, so the CPU tests reach it.  The product tables
below are re-read on a card by `python3 chip_smoke.py --joint-orders`
(`dot3_orders`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          stream_of)

# one bit a joint in the launch's prismatic mask
MAX_JOINTS = 32
# R0 (9), s0, t0 (3), R1 (9), s1, t1 (3) a problem
FIT_WIDTH = 26


# The order in which cuBLAS sums a batched (3, 3) @ (3, 1) product (and
# (1, 3) @ (3, 3)) of n matrices on the card, by n: (from, order) steps,
# order as csrc/joint_fit.cu::dot3 numbers them (0: fma chain; 1:
# fma(a1, b1, a0 b0) + a2 b2; 2: fma(a2, b2, a0 b0) + a1 b1; 3, 4: the
# products added in order 0 1 2, 0 2 1; None: no order gives torch's
# products, and the kernel takes 1).  Read on an H100 with the toolkit
# ORDERS_TOOLKIT by comparing each order with torch's products bit for
# bit (`dot3_orders`, `python3 chip_smoke.py --joint-orders`): every n up
# to 64, a grid up to ORDERS_CHECKED_TO, each step bisected to its count.
MV_ORDERS = ((1, 1), (12998, 2), (37293, 1), (78533, None), (102828, 1))
# the same with the matrix transposed, A^T v
MVT_ORDERS = ((1, 1), (2, 0), (127, 4), (130, 1), (150, 0), (190, 1),
              (1336, 2), (2853, 1), (131072, None))
# the toolkit the tables were read on: torch's release and its CUDA
# (torch.__version__ 2.11.0+cu128, torch.version.cuda 12.8)
ORDERS_TOOLKIT = ("2.11", "12.8")
# the largest batch count the tables were read at
ORDERS_CHECKED_TO = 131072
# the forms of the products dot3_orders compares: A v, the row form
# v^T A^T (the hypotheses' `a @ R^T`) and A^T v, with their tables
PRODUCT_FORMS = {"mv": MV_ORDERS, "row": MV_ORDERS, "mvt": MVT_ORDERS}


def toolkit_of(version: str, cuda: Optional[str]) -> Tuple[str, Optional[str]]:
    """(torch's release, its CUDA) of a `torch.__version__` and a
    `torch.version.cuda`: "2.11.0+cu128", "12.8" -> ("2.11", "12.8")."""
    return ".".join(version.split("+")[0].split(".")[:2]), cuda


@functools.lru_cache(maxsize=None)
def check_toolkit(version: str, cuda: Optional[str]) -> bool:
    """Whether the product tables were read on this toolkit; warns (once a
    toolkit) where they were not, since torch and cuBLAS may sum the
    plain path's tiny products in other orders there, and the kernel's
    votes may then part from the plain path's."""
    same = toolkit_of(version, cuda) == ORDERS_TOOLKIT
    if not same:
        warnings.warn(
            f"joint_fit: the product orders were read on torch "
            f"{ORDERS_TOOLKIT[0]} with CUDA {ORDERS_TOOLKIT[1]}, this is "
            f"torch {version} with CUDA {cuda}; re-read them with "
            f"`python3 chip_smoke.py --joint-orders`", RuntimeWarning,
            stacklevel=3)
    return same


def dot_order(n: int, transposed: bool = False) -> Optional[int]:
    """dot3's order of a batched product of n matrices (MV_ORDERS,
    MVT_ORDERS); None where no order gives torch's products."""
    order = 1
    for start, o in MVT_ORDERS if transposed else MV_ORDERS:
        if n >= start:
            order = o
    return order


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """The launch's scalars: rows scored and refit, the joints'
    prismatic bits and the inlier thresholds (rounded to float32 by
    ctypes, as torch rounds a Python scalar it compares with)."""

    score_points: int
    refit_points: int
    prismatic: int
    inlier_th: float
    inlier_th2: float
    order_hyp: int
    order_mv: int
    order_mvt: int


def launch_config(cfg, batch: int, parts: int, cap: int) -> LaunchConfig:
    """The scalars of a launch over (batch, parts, cap, 3) buffers with the
    fit config `cfg` (a `PoseFitConfig`): `ransac_score_points` and
    `lm_refit_points` cut to the buffers' rows as the plain path cuts
    them, joint j prismatic where `cfg.joint_types[j]` says so, and the
    orders of the tiny products at the plain path's batch counts (the
    hypotheses' batch x niter_joint, the refit's batch).  Warns where no
    order read gives torch's products at a count, or where the count is
    past ORDERS_CHECKED_TO; the kernel takes order 1 there."""
    if not 2 <= parts <= MAX_JOINTS + 1:
        raise ValueError(f"joint_fit: {parts} parts; it takes 2 to "
                         f"{MAX_JOINTS + 1}")
    if cap < 1:
        raise ValueError(f"joint_fit: empty buffers (cap={cap})")

    def cut(n):
        return n if (n is not None and n < cap) else cap

    orders = []
    for n, transposed in ((batch * cfg.niter_joint, False), (batch, False),
                          (batch, True)):
        order = dot_order(n, transposed)
        if order is None or n > ORDERS_CHECKED_TO:
            warnings.warn(
                f"joint_fit: no product order read matches torch's at a "
                f"batch of {n} (tables read up to {ORDERS_CHECKED_TO}); "
                f"the fits may part from the plain path's by rounding",
                RuntimeWarning, stacklevel=2)
        orders.append(1 if order is None else order)
    bits = 0
    for j in range(parts - 1):
        if cfg.joint_types[j] == "prismatic":
            bits |= 1 << j
    return LaunchConfig(cut(cfg.ransac_score_points), cut(cfg.lm_refit_points),
                        bits, float(cfg.inlier_th),
                        float(cfg.inlier_th) * float(cfg.inlier_th),
                        *orders)


class JointStage(NamedTuple):
    """The joint stage of a batch: every joint's two part poses, (B, J,
    ...) for J = K - 1 joints (part 0 is the base of each), the chosen
    hypothesis (B, J) and the hypotheses' scores (B, J, H), the refit's
    inlier sets (B, J, 2, cap) bool, and with `diagnostics` the fit of
    every hypothesis (B, J, H, 26: R0 s0 t0 R1 s1 t1)."""

    R0: torch.Tensor
    s0: torch.Tensor
    t0: torch.Tensor
    R1: torch.Tensor
    s1: torch.Tensor
    t1: torch.Tensor
    best: torch.Tensor
    scores: torch.Tensor
    inliers: torch.Tensor
    hypotheses: Optional[torch.Tensor]


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.joint_fit_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                                     ctypes.c_uint, F, F, I, I, I, P, P, P,
                                     P, P, P, P]
    lib.joint_fit_launch.restype = I
    lib.joint_fit_dot3.argtypes = [P, P, P, I, I, I, P]
    lib.joint_fit_dot3.restype = I
    lib.joint_fit_error_string.argtypes = [I]
    lib.joint_fit_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("joint_fit", "joint_fit.cu",
                    "none (articulated_pose_tpu/pose/pipeline.py:256-320 "
                    "is XLA ops, no Pallas kernel)", _bind)


def _check(src, tgt, mask, axes, draws) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"joint_fit: expected CUDA tensors, got {src.device}")
    for name, t in (("src", src), ("tgt", tgt), ("mask", mask),
                    ("axes", axes), ("draws", draws)):
        if t.dtype != torch.float32:
            raise ValueError(f"joint_fit: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != src.device:
            raise ValueError("joint_fit: every input must be on one device")
    B, K, cap = src.shape[:3]
    J = K - 1
    if (src.dim() != 4 or src.shape[-1] != 3 or tgt.shape != src.shape
            or mask.shape != (B, K, cap) or axes.shape != (B, J, 3)
            or draws.dim() != 5 or draws.shape[:3] != (B, J, 2)
            or draws.shape[-1] != 3 or draws.shape[3] < 1):
        raise ValueError(
            f"joint_fit: expected src/tgt (B, K, cap, 3), mask (B, K, cap), "
            f"axes (B, K-1, 3), draws (B, K-1, 2, H, 3); got "
            f"{tuple(src.shape)}, {tuple(tgt.shape)}, {tuple(mask.shape)}, "
            f"{tuple(axes.shape)}, {tuple(draws.shape)}")


@counted("joint_fit")
def joint_fit(src: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor,
              axes: torch.Tensor, draws: torch.Tensor, cfg,
              diagnostics: bool = False) -> JointStage:
    """Every joint of a batch in one launch of csrc/joint_fit.cu, counted
    on KERNEL.  src/tgt (B, K, cap, 3) and mask (B, K, cap) are
    `build_part_buffers_sorted`'s buffers, axes (B, K-1, 3) the voted
    axes, draws (B, K-1, 2, H, 3) `PoseDraws.joint`, cfg a
    `PoseFitConfig` with alternating hypotheses.  CUDA float32 only; a
    launch the card refuses raises with its error text."""
    _check(src, tgt, mask, axes, draws)
    B, K, cap = src.shape[:3]
    J, H = K - 1, draws.shape[3]
    if B == 0:
        raise ValueError("joint_fit: empty batch")
    if H != cfg.niter_joint:
        raise ValueError(f"joint_fit: {H} draws a joint part, the config "
                         f"says niter_joint={cfg.niter_joint}")
    check_toolkit(torch.__version__, torch.version.cuda)
    lc = launch_config(cfg, B, K, cap)
    src, tgt, mask, axes, draws = (t.contiguous() for t in
                                   (src, tgt, mask, axes, draws))
    lib = KERNEL.lib()
    dev = src.device
    work = torch.empty((B, J, 12 * lc.refit_points + 4), dtype=torch.float32,
                       device=dev)
    fit = torch.empty((B, J, FIT_WIDTH), dtype=torch.float32, device=dev)
    best = torch.empty((B, J), dtype=torch.int32, device=dev)
    scores = torch.empty((B, J, H), dtype=torch.float32, device=dev)
    inliers = torch.empty((B, J, 2, cap), dtype=torch.uint8, device=dev)
    hyp = (torch.empty((B, J, H, FIT_WIDTH), dtype=torch.float32, device=dev)
           if diagnostics else None)
    with torch.cuda.device(dev), KERNEL.scope():
        rc = lib.joint_fit_launch(
            ptr(src), ptr(tgt), ptr(mask), ptr(axes), ptr(draws), B, K, cap,
            H, lc.score_points, lc.refit_points, cfg.lm_iters_refit,
            lc.prismatic, lc.inlier_th, lc.inlier_th2, lc.order_hyp,
            lc.order_mv, lc.order_mvt, ptr(work), ptr(fit), ptr(best),
            ptr(scores), ptr(inliers),
            ctypes.c_void_p(None if hyp is None else hyp.data_ptr()),
            stream_of(src))
    check_rc(KERNEL, rc, lib.joint_fit_error_string)
    KERNEL.launches += 1
    return JointStage(
        R0=fit[..., 0:9].reshape(B, J, 3, 3), s0=fit[..., 9],
        t0=fit[..., 10:13], R1=fit[..., 13:22].reshape(B, J, 3, 3),
        s1=fit[..., 22], t1=fit[..., 23:26], best=best, scores=scores,
        inliers=inliers.view(torch.bool), hypotheses=hyp)


def dot3_products(A: torch.Tensor, v: torch.Tensor, order: int,
                  transposed: bool = False) -> torch.Tensor:
    """A v (or A^T v), A (n, 3, 3) and v (n, 3) CUDA float32 -> (n, 3),
    each entry summed by csrc/joint_fit.cu::dot3 in `order`: the kernel's
    tiny products, for reading the tables against torch's."""
    if A.device.type != "cuda" or A.dtype != torch.float32 or \
            v.dtype != torch.float32 or A.shape[1:] != (3, 3) or \
            v.shape != (A.shape[0], 3):
        raise ValueError(f"dot3_products: expected CUDA float32 A (n, 3, 3) "
                         f"and v (n, 3); got {A.dtype} {tuple(A.shape)} on "
                         f"{A.device}, {v.dtype} {tuple(v.shape)}")
    A, v = A.contiguous(), v.contiguous()
    out = torch.empty_like(v)
    lib = KERNEL.lib()
    with torch.cuda.device(A.device):
        rc = lib.joint_fit_dot3(ptr(A), ptr(v), ptr(out), A.shape[0], order,
                                int(transposed), stream_of(A))
    check_rc(KERNEL, rc, lib.joint_fit_error_string)
    return out


def dot3_orders(n: int, form: str, device, draws: int = 4,
                seed: int = 0) -> Tuple[int, ...]:
    """The dot3 orders that give torch's product of the plain path, bit
    for bit, on `draws` batches of n random (A, v) pairs: `form` "mv" is
    lm._mv(A, v), "row" the hypotheses' v^T A^T and "mvt"
    lm._mv(A^T, v).  An order the tables name at n should be among
    them."""
    from articulated_pose_tpu_torch.pose.lm import _mv

    g = torch.Generator(device=device).manual_seed(seed)
    found = set(range(5))
    for _ in range(draws):
        A = torch.rand((n, 3, 3), generator=g, device=device) * 2 - 1
        v = torch.rand((n, 3), generator=g, device=device) * 2 - 1
        if form == "mv":
            want = _mv(A, v)
        elif form == "row":
            want = (v.unsqueeze(-2) @ A.transpose(-1, -2)).squeeze(-2)
        elif form == "mvt":
            want = _mv(A.transpose(-1, -2), v)
        else:
            raise ValueError(f"dot3_orders: form {form!r}; it takes "
                             f"{tuple(PRODUCT_FORMS)}")
        found &= {o for o in found if torch.equal(
            dot3_products(A, v, o, transposed=form == "mvt"), want)}
    return tuple(sorted(found))
