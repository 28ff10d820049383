// 3-nearest-neighbour search: the exact kernel and the packed-key kernel.
//
// 1. three_nn_launch (K3) replaces the TPU kernels
//    articulated_pose_tpu/ops/pallas/three_nn.py::three_nn_pallas with
//    packed=False (body _three_nn_kernel) and three_nn_stream.py::
//    three_nn_stream (body _kernel, the blockwise-M variant).  For each
//    xyz1 point, the 3 nearest xyz2 points by squared distance
//    max((|q|^2 + |p|^2) - 2 q.p, 0), ascending, ties to the lowest
//    index; with fewer than 3 candidates the spare slots hold (inf, 0).
// 2. three_nn_packed_launch replaces three_nn_pallas with packed=True
//    (body _three_nn_key_kernel): the same distance, turned into the int32
//    key (bits(d2) & 0xFFFF0000) | j for candidate j; the 3 smallest keys
//    give idx = key & 0xFFFF and dist = the key's high half as a float.
//    Spare slots hold the key 0x7FFFFFFF: idx 65535, dist NaN.  m <= 65536.
//
// What bounds them on the card: ~9 FLOPs and one shared-memory read per
// (query, candidate) pair, N*M pairs per cloud (1M at 2048 <- 512), so
// they are bound by shared-memory bandwidth and issue rate, never by
// device memory.  The TPU kernels built the whole (N, M) distance tile in
// VMEM and swept it three times with masked arg-mins (the stream variant
// tiled M through VMEM and merged a running best-3 per tile); here the
// tile never exists: one thread per query streams the candidates once
// from shared memory (staged 512 at a time as float4 (x, y, z, |p|^2),
// 8 KB), which is the stream variant's design for any M, and keeps its
// best three in registers.  K3 inserts with a strict < in index order,
// which gives the lowest index on ties.  The packed kernel keeps three
// integer keys: the keys are unique, so a min/max insertion network (no
// separate index) is exactly the TPU's three min-and-mask sweeps.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;
constexpr int kKeyHigh = static_cast<int>(0xFFFF0000u);
constexpr int kSpareKey = INT_MAX;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Candidates [t0, t0 + tn) of one cloud into shared memory.
__device__ __forceinline__ void stage(float4* cand, const float* pts, int t0,
                                      int tn) {
  for (int k = threadIdx.x; k < tn; k += kThreads) {
    const float* p = pts + 3 * (static_cast<size_t>(t0) + k);
    cand[k] = make_float4(p[0], p[1], p[2], sqnorm(p[0], p[1], p[2]));
  }
}

// max((q2 + |p|^2) - 2 q.p, 0), in the plain version's operation order.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float q2, float4 c) {
  const float inner = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)), __fmul_rn(qz, c.z));
  return fmaxf(__fsub_rn(__fadd_rn(q2, c.w), __fmul_rn(2.0f, inner)), 0.0f);
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ xyz1,
                    const float* __restrict__ xyz2, int n, int m,
                    float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 cand[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < n;
  const float* query = xyz1 + (static_cast<size_t>(b) * n + q) * 3;
  const float* pts = xyz2 + static_cast<size_t>(b) * m * 3;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    qx = query[0];
    qy = query[1];
    qz = query[2];
  }
  const float q2 = sqnorm(qx, qy, qz);
  // K3: (distance, index) per slot; packed: one key per slot in k*
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = 0, i1 = 0, i2 = 0;
  int k0 = kSpareKey, k1 = kSpareKey, k2 = kSpareKey;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    __syncthreads();  // the previous tile is no longer read
    stage(cand, pts, t0, tn);
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < tn; ++k) {
      const float d = sqdist(qx, qy, qz, q2, cand[k]);
      const int j = t0 + k;
      if (kPacked) {
        // sorted k0 < k1 < k2; the keys are unique
        const int key = (__float_as_int(d) & kKeyHigh) | j;
        k2 = max(k1, min(k2, key));
        k1 = max(k0, min(k1, key));
        k0 = min(k0, key);
      } else if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
  }
  if (active) {
    if (kPacked) {
      d0 = __int_as_float(k0 & kKeyHigh);
      d1 = __int_as_float(k1 & kKeyHigh);
      d2 = __int_as_float(k2 & kKeyHigh);
      i0 = k0 & 0xFFFF;
      i1 = k1 & 0xFFFF;
      i2 = k2 & 0xFFFF;
    }
    const size_t o = (static_cast<size_t>(b) * n + q) * 3;
    dist[o + 0] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
    idx[o + 0] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
  }
}

}  // namespace

extern "C" {

// Grid (ceil(n / 256), batch).  Returns cudaGetLastError().
int three_nn_launch(const float* xyz1, const float* xyz2, int batch, int n,
                    int m, float* dist, int* idx, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  three_nn_kernel<false><<<grid, kThreads, 0, stream>>>(xyz1, xyz2, n, m,
                                                        dist, idx);
  return static_cast<int>(cudaGetLastError());
}

// As three_nn_launch, with the packed key; the caller keeps m <= 65536.
int three_nn_packed_launch(const float* xyz1, const float* xyz2, int batch,
                           int n, int m, float* dist, int* idx,
                           cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  three_nn_kernel<true><<<grid, kThreads, 0, stream>>>(xyz1, xyz2, n, m,
                                                       dist, idx);
  return static_cast<int>(cudaGetLastError());
}

const char* three_nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
