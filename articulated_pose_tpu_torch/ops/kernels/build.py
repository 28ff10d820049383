"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` exposes plain C launch functions that take device
pointers, sizes and a stream, and return `cudaGetLastError()`.  The
shared library is compiled for `sm_90a` into `_build/` inside the
package (listed in `.gitignore`), keyed by a hash of the source and the
flags, so an edited kernel rebuilds and an unchanged one loads at once.
No PyTorch header is compiled, so a build takes seconds.

`CudaKernel` also carries the launch counter that the wrappers bump each
time they launch the kernel: a run can show that its path went through
the kernel and not through the plain version.  Several kernels may share
one source (the six ball-query entries share `ball_query.cu`, the
three 3-NN entries `three_nn.cu`): its library is built once, and the
loader maps it once for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import torch

from articulated_pose_tpu_torch.utils.profiling import span

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false backs up the __fmul_rn/__fadd_rn intrinsics in the
# sources: no multiply-add contraction anywhere, so distances round
# exactly as the plain PyTorch versions' separate elementwise ops do.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-fmad=false", "-Xptxas", "-v"]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build_library(source: str) -> pathlib.Path:
    """Compile csrc/<source> into _build/ unless that exact build exists."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(kernels: Iterable["CudaKernel"]) -> Dict[str, float]:
    """Build every kernel's source at once, one nvcc per source, then
    load and bind them all.  Returns each source's build seconds."""
    kernels = list(kernels)
    sources = sorted({k.source for k in kernels})

    def timed_build(source: str) -> float:
        t0 = time.perf_counter()
        build_library(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        seconds = dict(zip(sources, pool.map(timed_build, sources)))
    for k in kernels:
        k.lib()
    return seconds


class CudaKernel:
    """One hand-written kernel: its source, its library and its count.

    `bind(lib)` sets the ctypes signatures of the kernel's exports; it
    runs once, right after the library is first loaded.
    """

    def __init__(self, name: str, source: str, replaces: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source            # file under csrc/
        self.replaces = replaces        # file:line of the TPU kernel
        self.launches = 0
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._path: Optional[pathlib.Path] = None

    @property
    def source_path(self) -> str:
        return f"articulated_pose_tpu_torch/csrc/{self.source}"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self._path = build_library(self.source)
            lib = ctypes.CDLL(str(self._path))
            self._bind(lib)
            self._lib = lib
        return self._lib

    def scope(self):
        """The scope of one launch: under torch.profiler, a span named
        "kernel:<name>", so a trace (`utils/profiling.trace`) names the
        entry that launched each CUDA function; nothing otherwise."""
        return span(f"kernel:{self.name}")

    def build_log(self) -> str:
        """What ptxas reported (registers, shared memory, spills)."""
        self.lib()
        return self._path.with_suffix(".log").read_text()


# the work counters (`roofline.Counter`) counting now, innermost last; an
# entry costs one truth test of this list while none is
COUNTERS: list = []


def counted(name: str):
    """Decorator of the kernel entry `name`: under a work counter the call
    goes through `counter.kernel_call(name, fn, args, kwargs)`, which
    counts the kernel's work from its shapes and leaves out whatever ran
    inside (the plain version's ops on the CPU, the wrapper's
    allocations on the card), so both devices count the same."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if COUNTERS:
                return COUNTERS[-1].kernel_call(name, fn, args, kwargs)
            return fn(*args, **kwargs)
        return entry
    return wrap


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_rc(kernel: CudaKernel, rc: int, error_string) -> None:
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{kernel.name} kernel launch failed: "
                           f"cudaError {rc} ({msg})")


def require_cuda(name: str, t: torch.Tensor) -> None:
    """Device/dtype/shape/contiguity checks shared by the wrappers: a
    contiguous float32 (B, N, 3) tensor on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name}: expected (B, N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
