// Fused ball query + centred grouping.
//
// Replaces the TPU kernel articulated_pose_tpu/ops/pallas/
// ball_query_butterfly.py::query_ball_group_pallas (exact transposed body
// _ballq_butterfly_kernel_t, the one the backbone runs).  Same semantics:
// for each query, the FIRST nsample points in index order with
// d2 < r2 (strict), d2 in the expansion form (|q|^2 + |p|^2) - 2 q.p;
// slots past the hit count hold the first hit; zero hits take point 0;
// grouped_xyz = point - query; cnt is capped at nsample; idx is written
// only when asked for (SA1 needs none, SA2 gathers features with it).
//
// What bounds it on the card: each query scans its cloud in index order
// until nsample hits are in, so the work is the scanned prefix (about
// 12 B of point data and ~15 FLOPs per scanned point), served from L1/L2
// because every query of a cloud reads the same points.  The TPU kernel
// routed a whole (N, BM) hit plane through a butterfly network because
// its vector unit cannot stop early; on the card the order-preserving
// compaction is a warp primitive: one warp per query takes 32 points per
// step, a __ballot_sync of the hit test, __popc prefix ranks for the
// slots, and stops as soon as nsample hits are in.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
    ball_query_group_kernel(const float* __restrict__ xyz,
                            const float* __restrict__ new_xyz, int batch,
                            int n, int m, int nsample, float r2,
                            float* __restrict__ grouped,
                            int* __restrict__ cnt_out,
                            int* __restrict__ idx_out) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= batch * m) return;  // uniform per warp
  const int b = query / m;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(query) + 0];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float q2 = sqnorm(qx, qy, qz);
  float* out = grouped + static_cast<size_t>(query) * nsample * 3;
  int* idx = idx_out ? idx_out + static_cast<size_t>(query) * nsample
                     : nullptr;

  int cnt = 0;    // hits so far (warp-uniform)
  int first = 0;  // index of the first hit; point 0 when there is none
  for (int base = 0; base < n && cnt < nsample; base += 32) {
    const int k = base + lane;
    bool hit = false;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (k < n) {
      px = __ldg(pts + 3 * k + 0);
      py = __ldg(pts + 3 * k + 1);
      pz = __ldg(pts + 3 * k + 2);
      const float inner = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, px), __fmul_rn(qy, py)), __fmul_rn(qz, pz));
      const float d2 = __fsub_rn(__fadd_rn(q2, sqnorm(px, py, pz)),
                                 __fmul_rn(2.0f, inner));
      hit = d2 < r2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (cnt == 0 && ballot != 0u) first = base + __ffs(ballot) - 1;
    if (hit) {
      const int slot = cnt + __popc(ballot & ((1u << lane) - 1u));
      if (slot < nsample) {
        out[3 * slot + 0] = __fsub_rn(px, qx);
        out[3 * slot + 1] = __fsub_rn(py, qy);
        out[3 * slot + 2] = __fsub_rn(pz, qz);
        if (idx) idx[slot] = k;
      }
    }
    cnt += __popc(ballot);
  }
  cnt = min(cnt, nsample);

  const float fx = __fsub_rn(__ldg(pts + 3 * first + 0), qx);
  const float fy = __fsub_rn(__ldg(pts + 3 * first + 1), qy);
  const float fz = __fsub_rn(__ldg(pts + 3 * first + 2), qz);
  for (int s = cnt + lane; s < nsample; s += 32) {
    out[3 * s + 0] = fx;
    out[3 * s + 1] = fy;
    out[3 * s + 2] = fz;
    if (idx) idx[s] = first;
  }
  if (lane == 0) cnt_out[query] = cnt;
}

}  // namespace

extern "C" {

// idx may be null (no index output).  Returns cudaGetLastError().
int ball_query_group_launch(const float* xyz, const float* new_xyz,
                            int batch, int n, int m, int nsample, float r2,
                            float* grouped, int* cnt, int* idx,
                            cudaStream_t stream) {
  const int queries = batch * m;
  const int blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_group_kernel<<<blocks, kThreads, 0, stream>>>(
      xyz, new_xyz, batch, n, m, nsample, r2, grouped, cnt, idx);
  return static_cast<int>(cudaGetLastError());
}

const char* ball_query_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
