// The card-limits probe's two kernels (articulated_pose_tpu_torch/
// probe_card.py).  They replace no TPU kernel and are no entry of the
// port's kernel table: the probe measures the card, not a path.
//
// 1. probe_fma_launch: each element's chain of `depth` dependent fused
//    multiply-adds, y = fma(y, a, b) from y = x[i], then y[i] = y; the
//    counterpart of scripts/probe_chip_limits.py's VPU chain
//    (`y * 1.000001 + 1e-9`, 64 deep, on an 8 MiB block).  Each FMA is
//    __fmaf_rn: the build passes -fmad=false to every source, which would
//    otherwise round a*b + c twice.  a and b are arguments and every
//    element seeds its own chain, so the compiler folds nothing, and the
//    stored result keeps the chain live.  What bounds it: at 64 deep an
//    element does 128 FLOPs against 8 bytes of memory, about the card's
//    ratio of f32 rate to HBM rate, so it reads the FMA ceiling only
//    where the block stays in L2 (8 MiB of 50 MB, called again and
//    again), as the JAX probe's block stayed in VMEM.  A first design,
//    one element a thread, read 25.1 TFLOP/s at 8 MiB on an H100 (700 W):
//    eight waves of CTAs, each waiting out its loads before its short
//    chain.  Here a grid of about one wave gives each thread kIlp
//    elements, the grid's width apart (each warp's loads still
//    coalesced): their loads issue together, and kIlp independent chains
//    hide each FMA's latency.  It read 28.3 TFLOP/s: at 64 deep a launch
//    is ~4 us of FMAs at the peak between its loads, its stores and the
//    gap to the next launch, which stay.
// 2. probe_empty_launch: a kernel that does nothing, for the host's cost
//    of one launch through ctypes.
//
// Each launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 8;                 // independent chains a thread

__global__ void fma_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, long long n,
                                 int depth, float a, float b) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
       base < n; base += stride * kIlp) {
    float v[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * stride;
      v[j] = i < n ? x[i] : 0.0f;
    }
    for (int k = 0; k < depth; ++k) {
#pragma unroll
      for (int j = 0; j < kIlp; ++j) v[j] = __fmaf_rn(v[j], a, b);
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + j * stride;
      if (i < n) y[i] = v[j];
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int probe_fma_launch(const float* x, float* y, long long n, int depth,
                     float a, float b, cudaStream_t stream) {
  if (n < 1 || depth < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kThreads) * kIlp;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  fma_chain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, y, n, depth, a, b);
  return static_cast<int>(cudaGetLastError());
}

int probe_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
