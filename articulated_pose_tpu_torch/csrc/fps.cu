// Two-level farthest point sampling: (B, N, 3) -> N -> np1 -> np2.
//
// Replaces the TPU kernel articulated_pose_tpu/ops/pallas/fps.py::
// farthest_point_sample2_pallas (body _fps2_kernel).  Same semantics:
// the first pick is index 0, every later pick maximises the running
// minimum squared distance (dx*dx + dy*dy) + dz*dz to the picked set,
// ties go to the lowest index, and level 2 runs on the np1 picks, so
// idx2 holds LOCAL indices into the level-1 subset.
//
// What bounds it on the card: the recurrence is serial in the picks
// (np1 + np2 block-wide argmax steps per cloud), so it is latency bound,
// not bandwidth bound: one block per cloud, each step a few loads and
// FLOPs per thread plus a two-stage shuffle reduction with two barriers.
// The design keeps every step on chip: the cloud's coordinates and the
// min-distance array live in shared memory (16 B per point, 32 KB at
// N = 2048), the level-1 picks are captured there as they are made, and
// level 2 reuses them without a trip to device memory.  With one block
// per cloud, small batches leave most SMs idle; splitting a cloud over
// a cluster is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide argmax (lowest index on ties).  Every thread returns the
// winner.  red_v/red_i hold one entry per warp, *winner one int.
__device__ int block_argmax(float v, int i, float* red_v, int* red_i,
                            int* winner) {
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

// One FPS level over n points held in shared memory (sx, sy, sz), with
// mind[] as the running state.  Writes the picks' indices to idx_out
// and coordinates to xyz_out (device memory) and, when px is given, to
// shared memory for the next level.
__device__ void fps_level(const float* sx, const float* sy, const float* sz,
                          float* mind, int n, int npoint, int* idx_out,
                          float* xyz_out, float* px, float* py, float* pz,
                          float* red_v, int* red_i, int* winner) {
  for (int k = threadIdx.x; k < n; k += kThreads) mind[k] = 1e38f;
  __syncthreads();
  int last = 0;
  for (int j = 0; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    if (threadIdx.x == 0) {
      idx_out[j] = last;
      xyz_out[3 * j + 0] = lx;
      xyz_out[3 * j + 1] = ly;
      xyz_out[3 * j + 2] = lz;
      if (px != nullptr) {
        px[j] = lx;
        py[j] = ly;
        pz[j] = lz;
      }
    }
    if (j == npoint - 1) break;
    float best_v = -1.0f;
    int best_i = INT_MAX;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float m = fminf(mind[k], sqdist(sx[k], sy[k], sz[k], lx, ly, lz));
      mind[k] = m;
      if (m > best_v) {  // k rises per thread: strict > keeps the lowest
        best_v = m;
        best_i = k;
      }
    }
    last = block_argmax(best_v, best_i, red_v, red_i, winner);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    fps2_kernel(const float* __restrict__ xyz, int n, int np1, int np2,
                int* __restrict__ idx1, float* __restrict__ xyz1,
                int* __restrict__ idx2, float* __restrict__ xyz2) {
  extern __shared__ float smem[];
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

  const int b = blockIdx.x;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    sx[k] = cloud[3 * k + 0];
    sy[k] = cloud[3 * k + 1];
    sz[k] = cloud[3 * k + 2];
  }
  __syncthreads();
  fps_level(sx, sy, sz, mind, n, np1, idx1 + static_cast<size_t>(b) * np1,
            xyz1 + static_cast<size_t>(b) * np1 * 3, px, py, pz, red_v,
            red_i, winner);
  fps_level(px, py, pz, mind, np1, np2, idx2 + static_cast<size_t>(b) * np2,
            xyz2 + static_cast<size_t>(b) * np2 * 3, nullptr, nullptr,
            nullptr, red_v, red_i, winner);
}

}  // namespace

extern "C" {

size_t fps2_smem_bytes(int n, int np1) {
  return sizeof(float) * (4 * static_cast<size_t>(n) + 3 * np1 + kWarps) +
         sizeof(int) * (kWarps + 1);
}

// Launches one block per cloud on `stream`; returns cudaGetLastError().
int fps2_launch(const float* xyz, int batch, int n, int np1, int np2,
                int* idx1, float* xyz1, int* idx2, float* xyz2,
                cudaStream_t stream) {
  const size_t smem = fps2_smem_bytes(n, np1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps2_kernel<<<batch, kThreads, smem, stream>>>(xyz, n, np1, np2, idx1,
                                                 xyz1, idx2, xyz2);
  return static_cast<int>(cudaGetLastError());
}

const char* fps2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
