// Ball query: three entry points over one warp-per-query scan.
//
// 1. ball_query_group_launch (K2) replaces the TPU kernel
//    articulated_pose_tpu/ops/pallas/ball_query_butterfly.py::
//    query_ball_group_pallas, exact transposed body _ballq_butterfly_kernel_t:
//    grouped_xyz = point - query, cnt, optional idx.
// 2. ball_query_group_packed_launch replaces the same wrapper's packed=True
//    bodies (_ballq_butterfly_packed_kernel_t, the one the backbone runs,
//    with the prologue _quantize_pack_coords): hits, cnt and idx as in 1,
//    but the grouped coordinates are the cloud's quantised ones,
//    fma(q, ext * f32(1/1023), mn) - query with
//    q = clip(floor(fma(p - mn, 1023 / ext, 0.5)), 0, 1023) per component
//    over the cloud's bounding box, ext = max(mx - mn, 1e-6).
// 3. ball_query_idx_launch replaces articulated_pose_tpu/ops/pallas/
//    ball_query_stream.py::query_ball_point_stream (body _kernel): idx and
//    cnt only, for clouds of any size the int32 index covers.
//
// The rank-select kernels of articulated_pose_tpu/ops/pallas/ball_query.py
// compute the same functions: query_ball_point_pallas (_ballq_kernel) is
// entry 3 and query_ball_point_grouped_pallas (_ballq_grouped_kernel) is
// entry 1 with idx; the wrappers launch them under their own names.  The
// TPU ranked hits with triangular matmuls because it has no ballot/popc.
//
// Shared semantics: for each query, the FIRST nsample points in index
// order with d2 < r2 (strict), d2 in the expansion form
// (|q|^2 + |p|^2) - 2 q.p with q.p = (qx px + qy py) + qz pz; slots past
// the hit count hold the first hit; zero hits take point 0; cnt is capped
// at nsample.
//
// What bounds it on the card: each query scans its cloud in index order
// until nsample hits are in, so the work is the scanned prefix (about
// 12 B of point data and ~15 FLOPs per scanned point), served from L1/L2
// because every query of a cloud reads the same points.  The TPU kernels
// routed a whole (N, BM) hit plane through a butterfly network, or
// (stream) swept N in VMEM-sized tiles with triangular-matmul ranks,
// because a vector unit cannot stop early; on the card the
// order-preserving compaction is a warp primitive: one warp per query
// takes 32 points per step, a __ballot_sync of the hit test, __popc
// prefix ranks for the slots, and stops as soon as nsample hits are in.
// Nothing here grows with N except the scan, so the streaming tier needs
// no tiling.  The packed tier's 3 x 10-bit packing only shrank the TPU's
// butterfly planes; here a per-cloud prologue writes the dequantised
// coordinates once (B blocks, one pass over the cloud) and the scan
// copies them out in place of the exact ones.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kQuantThreads = 256;
constexpr float kLevels = 1023.0f;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// One warp per query.  Hits are tested on `xyz`; kGrouped writes
// coords[hit] - query into `grouped` (coords is xyz itself for the exact
// tier, the dequantised cloud for the packed one).  idx may be null only
// when kGrouped.
template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ coords,
                      const float* __restrict__ new_xyz, int batch, int n,
                      int m, int nsample, float r2,
                      float* __restrict__ grouped, int* __restrict__ cnt_out,
                      int* __restrict__ idx_out) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= batch * m) return;  // uniform per warp
  const int b = query / m;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float* src = coords + static_cast<size_t>(b) * n * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(query) + 0];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float q2 = sqnorm(qx, qy, qz);
  float* out = kGrouped ? grouped + static_cast<size_t>(query) * nsample * 3
                        : nullptr;
  int* idx = idx_out ? idx_out + static_cast<size_t>(query) * nsample
                     : nullptr;

  int cnt = 0;    // hits so far (warp-uniform)
  int first = 0;  // index of the first hit; point 0 when there is none
  // an unsigned counter, so that base + 32 cannot wrap for any int32 n;
  // the point offsets are widened where they are formed (3 * k passes
  // int32 above ~715M points)
  const unsigned un = static_cast<unsigned>(n);
  for (unsigned base = 0; base < un && cnt < nsample; base += 32) {
    const unsigned k = base + lane;
    const size_t k3 = 3 * static_cast<size_t>(k);
    bool hit = false;
    if (k < un) {
      const float px = __ldg(pts + k3 + 0);
      const float py = __ldg(pts + k3 + 1);
      const float pz = __ldg(pts + k3 + 2);
      const float inner = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, px), __fmul_rn(qy, py)), __fmul_rn(qz, pz));
      const float d2 = __fsub_rn(__fadd_rn(q2, sqnorm(px, py, pz)),
                                 __fmul_rn(2.0f, inner));
      hit = d2 < r2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (cnt == 0 && ballot != 0u) {
      first = static_cast<int>(base) + __ffs(ballot) - 1;
    }
    if (hit) {
      const int slot = cnt + __popc(ballot & ((1u << lane) - 1u));
      if (slot < nsample) {
        if (kGrouped) {
          out[3 * slot + 0] = __fsub_rn(__ldg(src + k3 + 0), qx);
          out[3 * slot + 1] = __fsub_rn(__ldg(src + k3 + 1), qy);
          out[3 * slot + 2] = __fsub_rn(__ldg(src + k3 + 2), qz);
        }
        if (idx) idx[slot] = static_cast<int>(k);
      }
    }
    cnt += __popc(ballot);
  }
  cnt = min(cnt, nsample);

  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (kGrouped) {
    const float* f = src + 3 * static_cast<size_t>(first);
    fx = __fsub_rn(__ldg(f + 0), qx);
    fy = __fsub_rn(__ldg(f + 1), qy);
    fz = __fsub_rn(__ldg(f + 2), qz);
  }
  for (int s = cnt + lane; s < nsample; s += 32) {
    if (kGrouped) {
      out[3 * s + 0] = fx;
      out[3 * s + 1] = fy;
      out[3 * s + 2] = fz;
    }
    if (idx) idx[s] = first;
  }
  if (lane == 0) cnt_out[query] = cnt;
}

// The packed tier's prologue: one block per cloud reduces the bounding
// box, then writes every point's dequantised coordinates to `deq`.
__global__ void __launch_bounds__(kQuantThreads)
    quantize_kernel(const float* __restrict__ xyz, int n,
                    float* __restrict__ deq) {
  __shared__ float red[2][3][kQuantThreads / 32];
  __shared__ float box[2][3];  // mn, ext per component
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* out = deq + static_cast<size_t>(blockIdx.x) * n * 3;
  float mn[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float mx[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int k = threadIdx.x; k < n; k += kQuantThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = pts[3 * k + c];
      mn[c] = fminf(mn[c], v);
      mx[c] = fmaxf(mx[c], v);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn[c] = fminf(mn[c], __shfl_down_sync(0xffffffffu, mn[c], off));
      mx[c] = fmaxf(mx[c], __shfl_down_sync(0xffffffffu, mx[c], off));
    }
    if (lane == 0) {
      red[0][c][warp] = mn[c];
      red[1][c][warp] = mx[c];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    float lo = red[0][c][0], hi = red[1][c][0];
    for (int w = 1; w < kQuantThreads / 32; ++w) {
      lo = fminf(lo, red[0][c][w]);
      hi = fmaxf(hi, red[1][c][w]);
    }
    box[0][c] = lo;
    box[1][c] = fmaxf(__fsub_rn(hi, lo), 1e-6f);
  }
  __syncthreads();
  float lo[3], scl[3], inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = box[0][c];
    scl[c] = __fdiv_rn(kLevels, box[1][c]);
    inv[c] = __fmul_rn(box[1][c], __fdiv_rn(1.0f, kLevels));
  }
  for (int k = threadIdx.x; k < n; k += kQuantThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float q = fminf(
          fmaxf(floorf(__fmaf_rn(__fsub_rn(pts[3 * k + c], lo[c]), scl[c],
                                 0.5f)),
                0.0f),
          kLevels);
      out[3 * k + c] = __fmaf_rn(q, inv[c], lo[c]);
    }
  }
}

int launch(bool grouped_out, const float* xyz, const float* coords,
           const float* new_xyz, int batch, int n, int m, int nsample,
           float r2, float* grouped, int* cnt, int* idx,
           cudaStream_t stream) {
  const int queries = batch * m;
  const int blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (grouped_out) {
    ball_query_kernel<true><<<blocks, kThreads, 0, stream>>>(
        xyz, coords, new_xyz, batch, n, m, nsample, r2, grouped, cnt, idx);
  } else {
    ball_query_kernel<false><<<blocks, kThreads, 0, stream>>>(
        xyz, coords, new_xyz, batch, n, m, nsample, r2, grouped, cnt, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx may be null (no index output).  Returns cudaGetLastError().
int ball_query_group_launch(const float* xyz, const float* new_xyz,
                            int batch, int n, int m, int nsample, float r2,
                            float* grouped, int* cnt, int* idx,
                            cudaStream_t stream) {
  return launch(true, xyz, xyz, new_xyz, batch, n, m, nsample, r2, grouped,
                cnt, idx, stream);
}

// deq is (batch, n, 3) scratch that receives the dequantised cloud; idx
// may be null.  Two launches on `stream`; returns cudaGetLastError().
int ball_query_group_packed_launch(const float* xyz, const float* new_xyz,
                                   int batch, int n, int m, int nsample,
                                   float r2, float* deq, float* grouped,
                                   int* cnt, int* idx, cudaStream_t stream) {
  quantize_kernel<<<batch, kQuantThreads, 0, stream>>>(xyz, n, deq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(true, xyz, deq, new_xyz, batch, n, m, nsample, r2, grouped,
                cnt, idx, stream);
}

// idx is required.  Returns cudaGetLastError().
int ball_query_idx_launch(const float* xyz, const float* new_xyz, int batch,
                          int n, int m, int nsample, float r2, int* cnt,
                          int* idx, cudaStream_t stream) {
  return launch(false, xyz, xyz, new_xyz, batch, n, m, nsample, r2, nullptr,
                cnt, idx, stream);
}

const char* ball_query_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
