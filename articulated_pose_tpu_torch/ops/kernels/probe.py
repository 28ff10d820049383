"""The card-limits probe's kernels (`csrc/probe.cu`), for `probe_card`.

`fma_chain` launches the FMA chain, `empty_launch` a kernel that does
nothing.  They replace no TPU kernel, so they are not in `KERNELS` and
no path counts them; each keeps its own launch count.  They have no CPU
path: a CPU tensor raises.  `fma_chain_plain` is the chain in float64
NumPy, what the kernel is held to.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          ptr, stream_of)

# scripts/probe_chip_limits.py's chain: 64 deep, y * 1.000001 + 1e-9
DEPTH = 64
A = 1.000001
B = 1e-9


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_fma_launch.argtypes = [P, P, ctypes.c_longlong, I, F, F, P]
    lib.probe_fma_launch.restype = I
    lib.probe_empty_launch.argtypes = [P]
    lib.probe_empty_launch.restype = I
    lib.probe_error_string.argtypes = [I]
    lib.probe_error_string.restype = ctypes.c_char_p


NO_TPU_KERNEL = "none (the card-limits probe)"
FMA_KERNEL = CudaKernel("probe_fma", "probe.cu", NO_TPU_KERNEL, _bind)
EMPTY_KERNEL = CudaKernel("probe_empty", "probe.cu", NO_TPU_KERNEL, _bind)
PROBE_KERNELS = (FMA_KERNEL, EMPTY_KERNEL)


def fma_chain(x: torch.Tensor, depth: int = DEPTH, a: float = A,
              b: float = B) -> torch.Tensor:
    """x (n,) f32 on a card -> y (n,): `depth` dependent fused
    multiply-adds y = fma(y, a, b) from y = x, one launch."""
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain: the probe runs on a CUDA device, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("fma_chain: expected a contiguous 1-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    lib = FMA_KERNEL.lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.probe_fma_launch(ptr(x), ptr(y), x.numel(), depth, a, b,
                                  stream_of(x))
    check_rc(FMA_KERNEL, rc, lib.probe_error_string)
    FMA_KERNEL.launches += 1
    return y


def fma_chain_plain(x: np.ndarray, depth: int = DEPTH, a: float = A,
                    b: float = B) -> np.ndarray:
    """The chain in float64, from the f32 values of x, a and b that the
    kernel takes."""
    y = np.asarray(x, np.float32).astype(np.float64)
    a64, b64 = float(np.float32(a)), float(np.float32(b))
    for _ in range(depth):
        y = y * a64 + b64
    return y


def empty_launch(device: torch.device) -> None:
    """One launch of the empty kernel on `device`'s current stream."""
    lib = EMPTY_KERNEL.lib()
    rc = lib.probe_empty_launch(ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream))
    check_rc(EMPTY_KERNEL, rc, lib.probe_error_string)
    EMPTY_KERNEL.launches += 1
