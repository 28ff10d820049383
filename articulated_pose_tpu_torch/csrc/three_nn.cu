// Exact 3-nearest-neighbour search.
//
// Replaces the TPU kernel articulated_pose_tpu/ops/pallas/three_nn.py::
// three_nn_pallas with packed=False (body _three_nn_kernel).  Same
// semantics: for each xyz1 point, the 3 nearest xyz2 points by squared
// distance max((|q|^2 + |p|^2) - 2 q.p, 0), ascending, ties to the
// lowest index; with fewer than 3 candidates the spare slots hold
// (inf, index 0).
//
// What bounds it on the card: ~15 FLOPs and one shared-memory read per
// (query, candidate) pair, N*M pairs per cloud (1M at 2048 <- 512), so
// it is bound by shared-memory bandwidth and issue rate, never by device
// memory.  The TPU kernel built the whole (N, M) distance tile in VMEM
// and swept it three times with masked arg-mins; here the tile never
// exists: one thread per query streams the candidates once from shared
// memory (staged 512 at a time as float4 (x, y, z, |p|^2), 8 KB) and
// keeps its best three in registers with a strict < in index order,
// which gives the lowest index on ties.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

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
  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = 0, i1 = 0, i2 = 0;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tn = min(kTile, m - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < tn; k += kThreads) {
      const float px = pts[3 * (t0 + k) + 0];
      const float py = pts[3 * (t0 + k) + 1];
      const float pz = pts[3 * (t0 + k) + 2];
      cand[k] = make_float4(px, py, pz, sqnorm(px, py, pz));
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < tn; ++k) {
      const float4 c = cand[k];
      const float inner = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)),
          __fmul_rn(qz, c.z));
      const float d = fmaxf(
          __fsub_rn(__fadd_rn(q2, c.w), __fmul_rn(2.0f, inner)), 0.0f);
      const int j = t0 + k;
      if (d < d2) {
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
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(xyz1, xyz2, n, m, dist,
                                                 idx);
  return static_cast<int>(cudaGetLastError());
}

const char* three_nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
