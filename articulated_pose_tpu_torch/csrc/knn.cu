// k-nearest-neighbour search for k <= 16: the `knn` entry.
//
// It replaces no TPU kernel.  The JAX package's knn_point
// (articulated_pose_tpu/ops/core.py:259) takes lax.top_k over the whole
// (M, N) distance matrix, and the port's plain version
// (ops/core.py::knn_point) sorts it.  At the Point Transformer's
// shapes that matrix is B*M*N floats (4.3 GB at B = 16, M = N = 8192),
// so this kernel keeps each query's best k in registers and never
// writes a distance it does not return.  The Point Transformer backbone
// (models/point_transformer.py) runs it for every level's self search
// and every transition down's.
//
// For each query, the k candidates nearest by squared distance
// max((|q|^2 + |p|^2) - 2 q.p, 0), ascending, ties to the lowest index.
// q.p = (qx px + qy py) + qz pz, and the last subtraction is
// fma(-2, inner, |q|^2 + |p|^2): 2 inner is exact, so it rounds as the
// plain version's separate multiply and subtraction do (K3's arithmetic,
// csrc/three_nn.cu).
//
// What bounds it on the card: M*N (query, candidate) pairs a cloud,
// each ~9 f32 operations and a compare against the k-th best, from
// candidates every query of the cloud shares; instruction issue binds
// it, never device memory (the inputs are 12 bytes a point).  Design:
//   - C neighbouring lanes hold one query and split the candidates:
//     lane c takes candidates c, c + C, ... (a warp's loads of one step
//     are consecutive float4s).  Each lane keeps its best KP (k rounded
//     up to a power of two) sorted in registers; a candidate costs one
//     compare against the KP-th best, and an insertion (an unrolled
//     select network, KP slots) only when it beats it.
//   - The candidates pass through shared memory in 1024-point tiles as
//     float4 (x, y, z, |p|^2), |p|^2 once a point in sqnorm's order.
//   - Within a lane the candidates come in index order and insertion is
//     a strict <, so a tie keeps the lower index; the C lists then merge
//     by xor shuffles in lexicographic (distance, index) order, so ties
//     go to the lowest index whatever C.
// The lanes a query (C) come from the shapes alone:
// ops/kernels/knn.py::knn_plan.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;     // candidates a tile (16 KB of float4)
constexpr int kMaxK = 16;

struct Args {
  const float* xyz;      // (batch, n, 3): the candidates
  const float* queries;  // (batch, m, 3)
  int batch, n, m, k;
  float* dist;           // (batch, m, k)
  int* idx;              // (batch, m, k)
};

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// max((q2 + |p|^2) - 2 q.p, 0), in the plain version's operation order
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float q2, float4 c) {
  const float inner = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)), __fmul_rn(qz, c.z));
  return fmaxf(__fmaf_rn(-2.0f, inner, __fadd_rn(q2, c.w)), 0.0f);
}

// (d, i) before (e, j) in lexicographic order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Puts (dd, ii) into the sorted list (d, id) of KP, dropping the last;
// the caller knows it goes before the last.  Slot s takes slot s - 1's
// entry when (dd, ii) goes before that, else (dd, ii) when it goes
// before slot s's, else keeps its own; the slots are visited from the
// top, so each reads its neighbour before that one changes.
template <int KP>
__device__ __forceinline__ void insert(float (&d)[KP], int (&id)[KP],
                                       float dd, int ii) {
#pragma unroll
  for (int s = KP - 1; s > 0; --s) {
    const bool up = before(dd, ii, d[s - 1], id[s - 1]);
    const bool here = !up && before(dd, ii, d[s], id[s]);
    d[s] = up ? d[s - 1] : (here ? dd : d[s]);
    id[s] = up ? id[s - 1] : (here ? ii : id[s]);
  }
  if (before(dd, ii, d[0], id[0])) {
    d[0] = dd;
    id[0] = ii;
  }
}

// One CTA: 256 / C queries of cloud b, query q answered by lanes
// [q C, (q + 1) C) of the CTA.
template <int KP, int C>
__global__ void __launch_bounds__(kThreads) knn_kernel(const Args a) {
  __shared__ float4 cand[kTile];
  constexpr int kQueries = kThreads / C;
  const int tiles_q = (a.m + kQueries - 1) / kQueries;
  const int b = blockIdx.x / tiles_q;
  const int q = (blockIdx.x - b * tiles_q) * kQueries + threadIdx.x / C;
  const int c = threadIdx.x % C;
  const float* pts = a.xyz + static_cast<size_t>(b) * a.n * 3;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (q < a.m) {
    const float* p = a.queries + (static_cast<size_t>(b) * a.m + q) * 3;
    qx = __ldg(p + 0);
    qy = __ldg(p + 1);
    qz = __ldg(p + 2);
  }
  const float q2 = sqnorm(qx, qy, qz);
  float d[KP];
  int id[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    d[s] = CUDART_INF_F;
    id[s] = INT_MAX;
  }

  for (int t0 = 0; t0 < a.n; t0 += kTile) {
    const int tn = min(kTile, a.n - t0);
    __syncthreads();  // the previous tile has been read
    for (int k = threadIdx.x; k < tn; k += kThreads) {
      const float* p = pts + 3 * static_cast<size_t>(t0 + k);
      const float x = __ldg(p + 0), y = __ldg(p + 1), z = __ldg(p + 2);
      cand[k] = make_float4(x, y, z, sqnorm(x, y, z));
    }
    __syncthreads();
#pragma unroll 4
    for (int k = c; k < tn; k += C) {
      const float dd = sqdist(qx, qy, qz, q2, cand[k]);
      // within a lane the index rises: a tie with the last is no better
      if (dd < d[KP - 1]) insert<KP>(d, id, dd, t0 + k);
    }
  }

  // the C lanes of a query merge their lists; after the butterfly each
  // holds the query's best KP
#pragma unroll
  for (int off = 1; off < C; off <<= 1) {
    float od[KP];
    int oi[KP];
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      od[s] = __shfl_xor_sync(0xffffffffu, d[s], off);
      oi[s] = __shfl_xor_sync(0xffffffffu, id[s], off);
    }
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      if (before(od[s], oi[s], d[KP - 1], id[KP - 1])) {
        insert<KP>(d, id, od[s], oi[s]);
      }
    }
  }

  if (c == 0 && q < a.m) {
    const size_t o = (static_cast<size_t>(b) * a.m + q) * a.k;
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      if (s < a.k) {
        a.dist[o + s] = d[s];
        a.idx[o + s] = id[s];
      }
    }
  }
}

using KernelFn = void (*)(Args);

// (KP, C): KP in {1, 2, 4, 8, 16}, C in {1, 2, 4, 8, 16, 32}
#define KNN_C(kp)                                                        \
  &knn_kernel<kp, 1>, &knn_kernel<kp, 2>, &knn_kernel<kp, 4>,             \
      &knn_kernel<kp, 8>, &knn_kernel<kp, 16>, &knn_kernel<kp, 32>

KernelFn kernel_for(int kp_log2, int c_log2) {
  static const KernelFn table[] = {KNN_C(1), KNN_C(2), KNN_C(4), KNN_C(8),
                                   KNN_C(16)};
  return table[kp_log2 * 6 + c_log2];
}
#undef KNN_C

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

extern "C" {

// The k nearest of `xyz` (batch, n, 3) to each of `queries` (batch, m,
// 3), k <= 16 and k <= n, with `lanes` (a power of two up to 32) lanes
// a query.  Launches on `stream` and returns cudaGetLastError() (or the
// refusal's code).
int knn_launch(int lanes, const float* xyz, const float* queries, int batch,
               int n, int m, int k, float* dist, int* idx,
               cudaStream_t stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1 || k > kMaxK || k > n ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long queries_a_cta = kThreads / lanes;
  const long long blocks =
      static_cast<long long>(batch) * ((m + queries_a_cta - 1) / queries_a_cta);
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Args a{};
  a.xyz = xyz;
  a.queries = queries;
  a.batch = batch;
  a.n = n;
  a.m = m;
  a.k = k;
  a.dist = dist;
  a.idx = idx;
  const KernelFn fn = kernel_for(log2_of(k), log2_of(lanes));
  fn<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
