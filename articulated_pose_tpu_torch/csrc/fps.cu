// Farthest point sampling, two-level (B, N, 3) -> N -> np1 -> np2 and
// single-level (B, N, 3) -> npoint.
//
// fps2_launch (K1) replaces the TPU kernel articulated_pose_tpu/ops/
// pallas/fps.py::farthest_point_sample2_pallas (body _fps2_kernel);
// fps_launch (B2) replaces farthest_point_sample_pallas (body
// _fps_kernel), which the backbone runs once per SA stage when its
// pyramid is not two-level.  Same semantics in both: the first pick is
// index 0, every later pick maximises the running minimum squared
// distance (dx*dx + dy*dy) + dz*dz to the picked set, ties go to the
// lowest index, and level 2 runs on the np1 picks, so idx2 holds LOCAL
// indices into the level-1 subset.  Both run the one recurrence below,
// fps_level: the single-level kernel is its first level alone.
//
// What bounds it on the card: the recurrence is serial in the picks
// (np1 + np2 block-wide argmax steps per cloud), so it is latency bound,
// not bandwidth bound: one block per cloud, each step a few loads and
// FLOPs per thread plus a two-stage shuffle reduction with two barriers.
// The design keeps as much of every step on chip as the cloud allows,
// in three variants that the wrapper picks by N:
//   kSmem       coordinates and min-distance state in shared memory
//               (16 B per point, 32 KB at N = 2048; up to ~14k points),
//               the level-1 picks captured there for level 2;
//   kSmemState  the 4 B/point state in shared memory (128 KB at
//               N = 32768; up to ~57k points), coordinates read from
//               L2 (a cloud of 32768 points is 384 KB, and the whole
//               batch stays L2-resident across the np1 steps);
//   kGlobal     state in a global scratch row per cloud as well, for
//               any N: each step then streams 16 B per point from L2.
// The TPU kernel sized its batch tile to N so its VMEM state fit; a
// block's shared memory is the card's counterpart and the variants are
// its sizing.  With one block per cloud, small batches leave most SMs
// idle; splitting a cloud over a cluster is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

enum Variant { kSmem = 0, kSmemState = 1, kGlobal = 2 };

// threads per block: the small variant keeps its measured 512; the
// large ones take 1024 for more loads in flight per step
template <int V>
__host__ __device__ constexpr int threads_of() {
  return V == kSmem ? 512 : 1024;
}

__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide argmax (lowest index on ties).  Every thread returns the
// winner.  red_v/red_i hold one entry per warp, *winner one int.
template <int kThreads>
__device__ int block_argmax(float v, int i, float* red_v, int* red_i,
                            int* winner) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                __shfl_down_sync(0xffffffffu, i, off));
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -1.0f;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) *winner = i;
  }
  __syncthreads();
  return *winner;
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                       float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Points as three planes (shared memory).
struct Planes {
  const float* x;
  const float* y;
  const float* z;
  __device__ float3 operator()(int k) const { return {x[k], y[k], z[k]}; }
};

// Points as (n, 3) rows in device memory.  Plain loads, not __ldg:
// level 2 reads the level-1 picks that this block wrote.
struct Rows {
  const float* p;
  __device__ float3 operator()(int k) const {
    return {p[3 * k + 0], p[3 * k + 1], p[3 * k + 2]};
  }
};

// One FPS level over n points, with mind[] (shared or device memory) as
// the running state.  Writes the picks' indices to idx_out and
// coordinates to xyz_out (device memory) and, when px is given, to
// shared memory for the next level.
template <int kThreads, typename Points>
__device__ void fps_level(Points pts, float* mind, int n, int npoint,
                          int* idx_out, float* xyz_out, float* px, float* py,
                          float* pz, float* red_v, int* red_i, int* winner) {
  for (int k = threadIdx.x; k < n; k += kThreads) mind[k] = 1e38f;
  __syncthreads();
  int last = 0;
  for (int j = 0; j < npoint; ++j) {
    const float3 l = pts(last);
    if (threadIdx.x == 0) {
      idx_out[j] = last;
      xyz_out[3 * j + 0] = l.x;
      xyz_out[3 * j + 1] = l.y;
      xyz_out[3 * j + 2] = l.z;
      if (px != nullptr) {
        px[j] = l.x;
        py[j] = l.y;
        pz[j] = l.z;
      }
    }
    if (j == npoint - 1) break;
    float best_v = -1.0f;
    int best_i = INT_MAX;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float3 p = pts(k);
      const float m = fminf(mind[k], sqdist(p.x, p.y, p.z, l.x, l.y, l.z));
      mind[k] = m;
      if (m > best_v) {  // k rises per thread: strict > keeps the lowest
        best_v = m;
        best_i = k;
      }
    }
    last = block_argmax<kThreads>(best_v, best_i, red_v, red_i, winner);
  }
  __syncthreads();
}

template <int V>
size_t smem_bytes(int n, int np1) {
  constexpr int kWarps = threads_of<V>() / 32;
  const size_t red = sizeof(float) * kWarps + sizeof(int) * (kWarps + 1);
  if (V == kSmem) {
    return sizeof(float) * (4 * static_cast<size_t>(n) + 3 * np1) + red;
  }
  if (V == kSmemState) return sizeof(float) * static_cast<size_t>(n) + red;
  return red;
}

// scratch: (batch, n) floats for kGlobal, unused otherwise.  xyz1 is not
// __restrict__: the large variants read it back in level 2.
template <int V>
__global__ void __launch_bounds__(threads_of<V>())
    fps2_kernel(const float* __restrict__ xyz, int n, int np1, int np2,
                int* __restrict__ idx1, float* xyz1,
                int* __restrict__ idx2, float* __restrict__ xyz2,
                float* __restrict__ scratch) {
  constexpr int kThreads = threads_of<V>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  int* i1 = idx1 + static_cast<size_t>(b) * np1;
  float* x1 = xyz1 + static_cast<size_t>(b) * np1 * 3;
  int* i2 = idx2 + static_cast<size_t>(b) * np2;
  float* x2 = xyz2 + static_cast<size_t>(b) * np2 * 3;

  if (V == kSmem) {
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    float* mind = sz + n;
    float* px = mind + n;
    float* py = px + np1;
    float* pz = py + np1;
    float* red_v = pz + np1;
    int* red_i = reinterpret_cast<int*>(red_v + kWarps);
    int* winner = red_i + kWarps;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      sx[k] = cloud[3 * k + 0];
      sy[k] = cloud[3 * k + 1];
      sz[k] = cloud[3 * k + 2];
    }
    __syncthreads();
    fps_level<kThreads>(Planes{sx, sy, sz}, mind, n, np1, i1, x1, px, py, pz,
                        red_v, red_i, winner);
    fps_level<kThreads>(Planes{px, py, pz}, mind, np1, np2, i2, x2, nullptr,
                        nullptr, nullptr, red_v, red_i, winner);
  } else {
    float* mind = V == kSmemState ? smem : scratch + static_cast<size_t>(b) * n;
    float* red_v = V == kSmemState ? smem + n : smem;
    int* red_i = reinterpret_cast<int*>(red_v + kWarps);
    int* winner = red_i + kWarps;
    fps_level<kThreads>(Rows{cloud}, mind, n, np1, i1, x1, nullptr, nullptr,
                        nullptr, red_v, red_i, winner);
    // level 2 reads the picks back from xyz1; the barrier that ends
    // level 1 makes thread 0's writes visible to the block
    fps_level<kThreads>(Rows{x1}, mind, np1, np2, i2, x2, nullptr, nullptr,
                        nullptr, red_v, red_i, winner);
  }
}

// One level alone: the picks of each cloud and their coordinates.  The
// kSmem layout is fps2_kernel's with no level-2 capture (np1 = 0).
template <int V>
__global__ void __launch_bounds__(threads_of<V>())
    fps_kernel(const float* __restrict__ xyz, int n, int npoint,
               int* __restrict__ idx, float* __restrict__ new_xyz,
               float* __restrict__ scratch) {
  constexpr int kThreads = threads_of<V>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  int* i1 = idx + static_cast<size_t>(b) * npoint;
  float* x1 = new_xyz + static_cast<size_t>(b) * npoint * 3;

  if (V == kSmem) {
    float* sx = smem;
    float* sy = sx + n;
    float* sz = sy + n;
    float* mind = sz + n;
    float* red_v = mind + n;
    int* red_i = reinterpret_cast<int*>(red_v + kWarps);
    int* winner = red_i + kWarps;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      sx[k] = cloud[3 * k + 0];
      sy[k] = cloud[3 * k + 1];
      sz[k] = cloud[3 * k + 2];
    }
    __syncthreads();
    fps_level<kThreads>(Planes{sx, sy, sz}, mind, n, npoint, i1, x1, nullptr,
                        nullptr, nullptr, red_v, red_i, winner);
  } else {
    float* mind = V == kSmemState ? smem : scratch + static_cast<size_t>(b) * n;
    float* red_v = V == kSmemState ? smem + n : smem;
    int* red_i = reinterpret_cast<int*>(red_v + kWarps);
    int* winner = red_i + kWarps;
    fps_level<kThreads>(Rows{cloud}, mind, n, npoint, i1, x1, nullptr,
                        nullptr, nullptr, red_v, red_i, winner);
  }
}

// Raise a kernel's dynamic shared memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int V>
int launch(const float* xyz, int batch, int n, int np1, int np2, int* idx1,
           float* xyz1, int* idx2, float* xyz2, float* scratch,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(n, np1);
  const cudaError_t err = allow_smem(fps2_kernel<V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps2_kernel<V><<<batch, threads_of<V>(), smem, stream>>>(
      xyz, n, np1, np2, idx1, xyz1, idx2, xyz2, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_single(const float* xyz, int batch, int n, int npoint, int* idx,
                  float* new_xyz, float* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(n, 0);
  const cudaError_t err = allow_smem(fps_kernel<V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<V><<<batch, threads_of<V>(), smem, stream>>>(
      xyz, n, npoint, idx, new_xyz, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of `variant` (0 kSmem, 1 kSmemState, 2 kGlobal).
size_t fps2_smem_bytes(int variant, int n, int np1) {
  switch (variant) {
    case kSmem:
      return smem_bytes<kSmem>(n, np1);
    case kSmemState:
      return smem_bytes<kSmemState>(n, np1);
    default:
      return smem_bytes<kGlobal>(n, np1);
  }
}

// Launches one block per cloud on `stream`; scratch is (batch, n) floats
// for variant 2 and may be null otherwise.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unknown variant.
int fps2_launch(int variant, const float* xyz, int batch, int n, int np1,
                int np2, int* idx1, float* xyz1, int* idx2, float* xyz2,
                float* scratch, cudaStream_t stream) {
  switch (variant) {
    case kSmem:
      return launch<kSmem>(xyz, batch, n, np1, np2, idx1, xyz1, idx2, xyz2,
                           scratch, stream);
    case kSmemState:
      return launch<kSmemState>(xyz, batch, n, np1, np2, idx1, xyz1, idx2,
                                xyz2, scratch, stream);
    case kGlobal:
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return launch<kGlobal>(xyz, batch, n, np1, np2, idx1, xyz1, idx2, xyz2,
                             scratch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The single level: one block per cloud on `stream`, the variant's
// shared memory being fps2_smem_bytes(variant, n, 0); scratch as for
// fps2_launch.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an unknown variant.
int fps_launch(int variant, const float* xyz, int batch, int n, int npoint,
               int* idx, float* new_xyz, float* scratch,
               cudaStream_t stream) {
  switch (variant) {
    case kSmem:
      return launch_single<kSmem>(xyz, batch, n, npoint, idx, new_xyz,
                                  scratch, stream);
    case kSmemState:
      return launch_single<kSmemState>(xyz, batch, n, npoint, idx, new_xyz,
                                       scratch, stream);
    case kGlobal:
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return launch_single<kGlobal>(xyz, batch, n, npoint, idx, new_xyz,
                                    scratch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fps2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
