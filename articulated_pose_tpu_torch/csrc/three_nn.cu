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
// What bounds them on the card: N*M (query, candidate) pairs a cloud (1M
// at 2048 <- 512), each ~9 f32 operations and a compare against the
// third best, from candidates every query of the cloud shares; so
// instruction issue binds them, never device memory.  The TPU kernels built
// the whole (N, M) distance tile in VMEM and swept it three times with
// masked arg-mins (the stream variant tiled M through VMEM and merged a
// running best three per tile); here the tile never exists.  The first
// design, one thread per query over 512-candidate shared tiles, spent
// its time elsewhere: a 16-byte shared load served one distance test;
// two barriers every 512 candidates with no load in flight; and a grid
// of N / 256 CTAs a cloud, too few warps to hide the dependent chain of
// each test (32 of 132 SMs busy at 2048 <- 16384).  The design here:
//   - A thread holds G queries (a register tile), so one shared load of
//     a candidate serves G independent distance tests.
//   - C neighbouring lanes hold the same queries and split the
//     candidates: lane c takes candidates c, c + C, c + 2C, ... (a
//     warp's loads of one step are C consecutive float4s, conflict-free),
//     keeps its best three, and the C lists merge by xor shuffles at the
//     end.  K3 merges by (distance, index) in lexicographic order; within
//     a slice insertion is a strict < in index order; together they send
//     ties to the lowest index, whatever C.  The packed keys are unique,
//     so their merge is the same min/max network as the scan's.
//   - The candidates are staged in shared memory as float4 (x, y, z,
//     |p|^2), |p|^2 once a point in sqnorm's order: the whole set where
//     it fits (the FP stages' 16-1024 points), else 2048-point tiles in
//     two buffers, the next tile's points loaded into registers while
//     this one is scanned, one barrier a tile.
// What is left (PERF.md section 6): a warp runs a lane's insertion (the
// compares and selects of a sorted list of three) whenever any of its
// lanes needs one, which at M = 512 is most steps, so the insertion
// costs about as much as the distance.  Holding a chunk of candidates
// against each list's bound first, one compare a pair, was built and
// swept and lost at every M = 512 shape, so it went.
// The distance is (|q|^2 + |p|^2) - 2 q.p with q.p = (qx px + qy py) +
// qz pz, the last subtraction one fma(-2, inner, |q|^2 + |p|^2): 2 inner
// is exact, so it rounds as the separate multiply and subtract do.  The
// launch plan (G, C, staged) comes from the shapes alone:
// ops/kernels/three_nn.py::nn_plan.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                        // candidates a tile
constexpr int kTilePerThread = kTile / kThreads;   // its points a thread
constexpr int kKeyHigh = static_cast<int>(0xFFFF0000u);
constexpr int kSpareKey = INT_MAX;
// the dynamic shared memory a launch may take without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

// (G queries a thread, C lanes a query group) of each variant, in the
// order of ops/kernels/three_nn.py's VARIANTS
#define NN_VARIANTS(X)                                                    \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(1, 16) X(1, 32)                       \
  X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(2, 16) X(2, 32)                       \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(8, 32)

struct Args {
  const float* xyz1;   // (batch, n, 3): the queries
  const float* xyz2;   // (batch, m, 3): the candidates
  int batch, n, m;
  float* dist;         // (batch, n, 3)
  int* idx;            // (batch, n, 3)
  int staged;          // the whole candidate set in shared memory
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

// The packed kernel's sort key of candidate j at squared distance d
__device__ __forceinline__ int sort_key(float d, int j) {
  return (__float_as_int(d) & kKeyHigh) | j;
}

// One query's best three so far: (distance, index) ascending for K3, the
// keys ascending for the packed kernel.
template <bool kPacked>
struct Best {
  float d0, d1, d2;
  int i0, i1, i2;
  int k0, k1, k2;

  // the spare slots; inf comes from the kernel's body: nvcc's host pass
  // refuses CUDART_INF_F (a device intrinsic) in a class template
  __device__ __forceinline__ void clear(float inf) {
    d0 = d1 = d2 = inf;
    i0 = i1 = i2 = 0;
    k0 = k1 = k2 = kSpareKey;
  }

  // a candidate of the scan: its index is above every index held, so a
  // tie loses (strict <)
  __device__ __forceinline__ void scan(float d, int j) {
    if constexpr (kPacked) {
      insert_key(sort_key(d, j));
    } else if (d < d2) {
      put(d, j);
    }
  }

  // a member of another lane's list: (distance, index) in lexicographic
  // order, the keys (unique but for the spare) as they are
  __device__ __forceinline__ void merge(float d, int i, int k) {
    if constexpr (kPacked) {
      insert_key(k);
    } else if (d < d2 || (d == d2 && i < i2)) {
      if (d < d1 || (d == d1 && i < i1)) {
        d2 = d1;
        i2 = i1;
        if (d < d0 || (d == d0 && i < i0)) {
          d1 = d0;
          i1 = i0;
          d0 = d;
          i0 = i;
        } else {
          d1 = d;
          i1 = i;
        }
      } else {
        d2 = d;
        i2 = i;
      }
    }
  }

  __device__ __forceinline__ void put(float d, int j) {
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

  // sorted k0 <= k1 <= k2
  __device__ __forceinline__ void insert_key(int key) {
    k2 = max(k1, min(k2, key));
    k1 = max(k0, min(k1, key));
    k0 = min(k0, key);
  }
};

// Candidates [0, tn) of a staged tile, this lane's slice (c, c + C, ...),
// against the thread's G queries; the tile's first candidate is j0.
template <bool kPacked, int G, int C>
__device__ __forceinline__ void scan(const float4* cand, int tn, int j0,
                                     int c, const float (&qx)[G],
                                     const float (&qy)[G],
                                     const float (&qz)[G],
                                     const float (&q2)[G],
                                     Best<kPacked> (&best)[G]) {
#pragma unroll 2
  for (int k = c; k < tn; k += C) {
    const float4 p = cand[k];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      best[g].scan(sqdist(qx[g], qy[g], qz[g], q2[g], p), j0 + k);
    }
  }
}

// A tile's points, one register triple per point of this thread
__device__ __forceinline__ void load_tile(const float* pts, int m, int t0,
                                          float (&r)[kTilePerThread][3]) {
#pragma unroll
  for (int p = 0; p < kTilePerThread; ++p) {
    const int k = t0 + p * kThreads + threadIdx.x;
    if (k < m) {
      const size_t k3 = 3 * static_cast<size_t>(k);
      r[p][0] = __ldg(pts + k3 + 0);
      r[p][1] = __ldg(pts + k3 + 1);
      r[p][2] = __ldg(pts + k3 + 2);
    } else {
      r[p][0] = r[p][1] = r[p][2] = 0.0f;  // past the set: never scanned
    }
  }
}

__device__ __forceinline__ void store_tile(
    float4* cand, const float (&r)[kTilePerThread][3]) {
#pragma unroll
  for (int p = 0; p < kTilePerThread; ++p) {
    cand[p * kThreads + threadIdx.x] =
        make_float4(r[p][0], r[p][1], r[p][2],
                    sqnorm(r[p][0], r[p][1], r[p][2]));
  }
}

// One CTA: 256 / C query groups of G queries of cloud b; group q's g-th
// query is q0 + g (256 / C) + q, answered by lanes [q C, (q + 1) C).
// Shared memory (dynamic): the staged candidates, or two tiles.
template <bool kPacked, int G, int C>
__global__ void __launch_bounds__(kThreads) three_nn_kernel(const Args a) {
  extern __shared__ float4 cand[];
  constexpr int kGroups = kThreads / C;
  constexpr int kQueries = kGroups * G;
  const int tiles_n = (a.n + kQueries - 1) / kQueries;
  const int b = blockIdx.x / tiles_n;
  const int q0 = (blockIdx.x - b * tiles_n) * kQueries;
  const int c = threadIdx.x % C;
  const int group = threadIdx.x / C;
  const float* pts = a.xyz2 + static_cast<size_t>(b) * a.m * 3;

  float qx[G], qy[G], qz[G], q2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = q0 + g * kGroups + group;
    if (q < a.n) {
      const float* p = a.xyz1 + (static_cast<size_t>(b) * a.n + q) * 3;
      qx[g] = __ldg(p + 0);
      qy[g] = __ldg(p + 1);
      qz[g] = __ldg(p + 2);
    } else {
      qx[g] = qy[g] = qz[g] = 0.0f;
    }
    q2[g] = sqnorm(qx[g], qy[g], qz[g]);
  }
  Best<kPacked> best[G];
#pragma unroll
  for (int g = 0; g < G; ++g) best[g].clear(CUDART_INF_F);

  if (a.staged) {
#pragma unroll 4
    for (int k = threadIdx.x; k < a.m; k += kThreads) {
      const float* p = pts + 3 * static_cast<size_t>(k);
      const float x = __ldg(p + 0), y = __ldg(p + 1), z = __ldg(p + 2);
      cand[k] = make_float4(x, y, z, sqnorm(x, y, z));
    }
    __syncthreads();
    scan<kPacked, G, C>(cand, a.m, 0, c, qx, qy, qz, q2, best);
  } else {
    float r[kTilePerThread][3];
    load_tile(pts, a.m, 0, r);
    store_tile(cand, r);
    __syncthreads();
    for (int t0 = 0, buf = 0;; t0 += kTile, buf ^= 1) {
      const bool more = a.m - t0 > kTile;
      if (more) load_tile(pts, a.m, t0 + kTile, r);  // in flight meanwhile
      scan<kPacked, G, C>(cand + buf * kTile, min(kTile, a.m - t0), t0, c,
                          qx, qy, qz, q2, best);
      if (!more) break;
      // the other buffer was last read before the previous barrier
      store_tile(cand + (buf ^ 1) * kTile, r);
      __syncthreads();
    }
  }

  // the C lanes of a group merge their lists: after the butterfly every
  // one of them holds the group's best three
#pragma unroll
  for (int off = 1; off < C; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Best<kPacked>& s = best[g];
      if constexpr (kPacked) {
        const int k0 = __shfl_xor_sync(0xffffffffu, s.k0, off);
        const int k1 = __shfl_xor_sync(0xffffffffu, s.k1, off);
        const int k2 = __shfl_xor_sync(0xffffffffu, s.k2, off);
        s.merge(0.0f, 0, k0);
        s.merge(0.0f, 0, k1);
        s.merge(0.0f, 0, k2);
      } else {
        const float d0 = __shfl_xor_sync(0xffffffffu, s.d0, off);
        const float d1 = __shfl_xor_sync(0xffffffffu, s.d1, off);
        const float d2 = __shfl_xor_sync(0xffffffffu, s.d2, off);
        const int i0 = __shfl_xor_sync(0xffffffffu, s.i0, off);
        const int i1 = __shfl_xor_sync(0xffffffffu, s.i1, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, s.i2, off);
        s.merge(d0, i0, 0);
        s.merge(d1, i1, 0);
        s.merge(d2, i2, 0);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = q0 + g * kGroups + group;
    if (g % C != c || q >= a.n) continue;
    Best<kPacked>& s = best[g];
    if constexpr (kPacked) {
      s.d0 = __int_as_float(s.k0 & kKeyHigh);
      s.d1 = __int_as_float(s.k1 & kKeyHigh);
      s.d2 = __int_as_float(s.k2 & kKeyHigh);
      s.i0 = s.k0 & 0xFFFF;
      s.i1 = s.k1 & 0xFFFF;
      s.i2 = s.k2 & 0xFFFF;
    }
    const size_t o = (static_cast<size_t>(b) * a.n + q) * 3;
    a.dist[o + 0] = s.d0;
    a.dist[o + 1] = s.d1;
    a.dist[o + 2] = s.d2;
    a.idx[o + 0] = s.i0;
    a.idx[o + 1] = s.i1;
    a.idx[o + 2] = s.i2;
  }
}

using KernelFn = void (*)(Args);

#define NN_G(g, c) g,
#define NN_C(g, c) c,
constexpr int kVariantG[] = {NN_VARIANTS(NN_G)};
constexpr int kVariantC[] = {NN_VARIANTS(NN_C)};
#undef NN_G
#undef NN_C
constexpr int kVariants = sizeof(kVariantG) / sizeof(kVariantG[0]);

template <bool kPacked>
KernelFn kernel_for(int variant) {
#define NN_FN(g, c) &three_nn_kernel<kPacked, g, c>,
  static const KernelFn table[] = {NN_VARIANTS(NN_FN)};
#undef NN_FN
  return table[variant];
}

// One launch at (variant, staged); a plan the card refuses (too much
// shared memory, too many CTAs) returns its error.
int launch(bool packed, int variant, int staged, Args a,
           cudaStream_t stream) {
  if (variant < 0 || variant >= kVariants || a.batch < 1 || a.n < 1 ||
      a.m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long queries = (kThreads / kVariantC[variant]) *
                            static_cast<long long>(kVariantG[variant]);
  const long long blocks =
      static_cast<long long>(a.batch) * ((a.n + queries - 1) / queries);
  const long long bytes = 16LL * (staged ? a.m : 2 * kTile);
  if (bytes > (1LL << 30) || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  a.staged = staged;
  const KernelFn fn = packed ? kernel_for<true>(variant)
                             : kernel_for<false>(variant);
  if (static_cast<size_t>(bytes) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  fn<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(bytes),
       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* xyz1, const float* xyz2, int batch, int n, int m,
               float* dist, int* idx) {
  Args a{};
  a.xyz1 = xyz1;
  a.xyz2 = xyz2;
  a.batch = batch;
  a.n = n;
  a.m = m;
  a.dist = dist;
  a.idx = idx;
  return a;
}

}  // namespace

extern "C" {

// Each entry takes the plan first: variant (an index into NN_VARIANTS)
// and staged (1: the whole candidate set in shared memory).  Launches on
// `stream` and returns cudaGetLastError() (or the refusal's code).

int three_nn_launch(int variant, int staged, const float* xyz1,
                    const float* xyz2, int batch, int n, int m, float* dist,
                    int* idx, cudaStream_t stream) {
  return launch(false, variant, staged,
                make_args(xyz1, xyz2, batch, n, m, dist, idx), stream);
}

// As three_nn_launch, with the packed key; m <= 65536.
int three_nn_packed_launch(int variant, int staged, const float* xyz1,
                           const float* xyz2, int batch, int n, int m,
                           float* dist, int* idx, cudaStream_t stream) {
  if (m > 65536) return static_cast<int>(cudaErrorInvalidValue);
  return launch(true, variant, staged,
                make_args(xyz1, xyz2, batch, n, m, dist, idx), stream);
}

const char* three_nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
