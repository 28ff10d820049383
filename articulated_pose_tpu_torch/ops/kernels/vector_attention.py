"""The Point Transformer's vector attention after its q, k, v Linears, in
one launch: the kernel entry `vector_attention` over
`csrc/vector_attention.cu`.

It replaces no TPU kernel: the JAX package has no Point Transformer.
The plain version is the layer's own composition,
`PointTransformerLayer.plain` (`models/point_transformer.py`), which
writes each step to device memory as a (B, n, k, ·) tensor; the kernel
writes only y (B, n, C) float32, rounding to the layer's dtype where the
plain path rounds (the module docstring of the source lists the points).

The entry takes the layer itself (its parameters and batch-norm state,
read on the card as the f32 tensors they are, so a captured graph reads
whatever they hold when it replays) with the layer's inputs.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises: in training mode (batch norm would take the batch's statistics)
and where a gradient is wanted (the kernel has no backward), and on
shapes it does not take (`check`).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          stream_of)

# the widths C the kernel is built for, each with G = C / SHARE outputs
# of gamma (the Point Transformer's published 32-512 and the tiny 16)
WIDTHS = (16, 32, 64, 128, 256, 512)
SHARE = 8
MAX_K = 16
# the layer's f32 parameters and batch-norm state in the order
# csrc/vector_attention.cu's `Param` takes them
PARAMS = ("pos.linear.weight", "pos.linear.bias", "pos.bn.running_mean",
          "pos.bn.running_var", "pos.bn.weight", "pos.bn.bias",
          "pos_out.weight", "pos_out.bias",
          "w_bn.running_mean", "w_bn.running_var", "w_bn.weight",
          "w_bn.bias",
          "w.linear.weight", "w.linear.bias", "w.bn.running_mean",
          "w.bn.running_var", "w.bn.weight", "w.bn.bias",
          "w_out.weight", "w_out.bias")
# the batch norms whose eps the kernel takes, in its order
NORMS = ("pos.bn", "w_bn", "w.bn")
DTYPES = (torch.bfloat16, torch.float32)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vector_attention_launch.argtypes = [
        I, I, I, I, I, P, P, P, P, P, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_float), P, P]
    lib.vector_attention_launch.restype = I
    lib.vector_attention_bn_scale.argtypes = [P, P, ctypes.c_float, I, P, P]
    lib.vector_attention_bn_scale.restype = I
    lib.vector_attention_error_string.argtypes = [I]
    lib.vector_attention_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("vector_attention", "vector_attention.cu",
                    "none (the JAX package has no Point Transformer)", _bind)


def vector_attention_plain(layer, p, q, key, v, nbr) -> torch.Tensor:
    """The plain version: the layer's own composition."""
    return layer.plain(p, q, key, v, nbr)


def check(layer, p, q, key, v, nbr) -> None:
    """Raise ValueError on what the kernel does not take: k outside
    1..16 or above n, C not divisible by the layer's share, C above 512
    or outside WIDTHS with share 8, or mismatched shapes and dtypes."""
    if q.dim() != 3 or key.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"vector_attention: q, key, v must be one (B, n, C) "
                         f"shape, got {tuple(q.shape)}, {tuple(key.shape)}, "
                         f"{tuple(v.shape)}")
    B, n, C = q.shape
    if nbr.dim() != 3 or nbr.shape[:2] != (B, n):
        raise ValueError(f"vector_attention: nbr must be (B, n, k) = ({B}, "
                         f"{n}, k), got {tuple(nbr.shape)}")
    if p.shape != (B, n, 3) or p.dtype != torch.float32:
        raise ValueError(f"vector_attention: p must be float32 ({B}, {n}, "
                         f"3), got {p.dtype} {tuple(p.shape)}")
    k = nbr.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"vector_attention: k={k} outside 1..{MAX_K}")
    if k > n:
        raise ValueError(f"vector_attention: k={k} exceeds the level's {n} "
                         f"points")
    share = layer.share
    if C % share:
        raise ValueError(f"vector_attention: C={C} is not divisible by "
                         f"share {share}")
    if C > max(WIDTHS):
        raise ValueError(f"vector_attention: C={C} above {max(WIDTHS)}")
    if C not in WIDTHS or share != SHARE:
        raise ValueError(f"vector_attention: takes C in {WIDTHS} with share "
                         f"{SHARE}, got C={C}, share {share}")
    if key.dtype != q.dtype or v.dtype != q.dtype or q.dtype != layer.dtype \
            or q.dtype not in DTYPES:
        raise ValueError(f"vector_attention: q, key, v must be the layer's "
                         f"dtype ({layer.dtype}, bf16 or f32), got "
                         f"{q.dtype}, {key.dtype}, {v.dtype}")
    if nbr.dtype != torch.int32:
        raise ValueError(f"vector_attention: nbr must be int32, got "
                         f"{nbr.dtype}")


def layer_tensors(layer) -> list:
    """The layer's PARAMS tensors, in order."""
    return [operator.attrgetter(name)(layer) for name in PARAMS]


def _check_card(layer, tensors) -> None:
    if layer.training:
        raise ValueError("vector_attention: the layer is in training mode; "
                         "the kernel takes batch norm's running statistics")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("vector_attention: a gradient is wanted and the "
                         "kernel has no backward")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"vector_attention: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("vector_attention: every input and parameter "
                             "must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("vector_attention: expected contiguous tensors "
                             "on 16-byte boundaries")
    if any(t.dtype != torch.float32 for t in tensors[5:]):
        raise ValueError("vector_attention: the layer's parameters and "
                         "batch-norm state must be float32")


def launch(layer, p, q, key, v, nbr) -> torch.Tensor:
    """One launch of csrc/vector_attention.cu, counted on KERNEL: y (B, n,
    C) float32.  A launch the card refuses raises with its error text."""
    params = layer_tensors(layer)
    _check_card(layer, [p, q, key, v, nbr, *params])
    B, n, C = q.shape
    k = nbr.shape[-1]
    lib = KERNEL.lib()
    dev = q.device
    y = torch.empty((B, n, C), dtype=torch.float32, device=dev)
    prm = (ctypes.c_void_p * len(PARAMS))(*[t.data_ptr() for t in params])
    eps = (ctypes.c_float * len(NORMS))(
        *[operator.attrgetter(name)(layer).eps for name in NORMS])
    with torch.cuda.device(dev), KERNEL.scope():
        rc = lib.vector_attention_launch(
            int(q.dtype == torch.bfloat16), C, B, n, k, ptr(p), ptr(q),
            ptr(key), ptr(v), ptr(nbr), prm, eps, ptr(y), stream_of(q))
    check_rc(KERNEL, rc, lib.vector_attention_error_string)
    KERNEL.launches += 1
    return y


@counted("vector_attention")
def vector_attention(layer, p, q, key, v, nbr) -> torch.Tensor:
    """y (B, n, C) float32 of the `PointTransformerLayer` `layer` for its
    q, key, v (B, n, C) in the layer's dtype, the level's points p (B, n,
    3) float32 and neighbours nbr (B, n, k) int32.  A CPU tensor takes the
    plain version; raises ValueError on what the kernel does not take
    (`check`)."""
    check(layer, p, q, key, v, nbr)
    if q.device.type == "cpu":
        return vector_attention_plain(layer, p, q, key, v, nbr)
    return launch(layer, p, q, key, v, nbr)


def bn_scale(var: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """rsqrt(var + eps) * weight as the kernel forms a batch norm's scale
    (CUDA float32 vectors), to hold against torch's."""
    var, weight = var.contiguous(), weight.contiguous()
    out = torch.empty_like(var)
    lib = KERNEL.lib()
    with torch.cuda.device(var.device):
        rc = lib.vector_attention_bn_scale(ptr(var), ptr(weight), eps,
                                           var.numel(), ptr(out),
                                           stream_of(var))
    check_rc(KERNEL, rc, lib.vector_attention_error_string)
    return out
