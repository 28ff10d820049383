// Bucket-sampled ball query + centred grouping (B8).
//
// Replaces the TPU kernel articulated_pose_tpu/ops/pallas/
// ball_query_bucket.py::query_ball_group_bucket (body
// _ballq_bucket_kernel), the ball_query_impl="bucket" tier.  Semantics,
// with n_pad = ceil(N / 128) * 128 and W = n_pad / nsample a power of two
// (the wrapper checks both):
//   - slot j owns the points [j W, (j + 1) W) and holds the FIRST of them
//     with d2 < r2, d2 in the expansion form (|q|^2 + |p|^2) - 2 q.p with
//     q.p = (qx px + qy py) + qz pz; points at or past N never hit;
//   - cnt = min(hits over the whole cloud, nsample);
//   - every slot whose bucket has no hit repeats the first filled slot,
//     which is the cloud's first hit in index order;
//   - a selected point's grouped coordinates are (p - q) rounded to
//     nearest-even bf16 and returned as f32 (the TPU kernel carried them
//     through one bf16 matmul);
//   - with no hit at all, idx is 0 and the coordinates are p[0] - q in
//     f32, unrounded.
//
// What bounds it on the card: unlike the first-S tiers, every query must
// scan its whole cloud (cnt counts all hits, and every bucket needs its
// own first hit), so the work is N point tests per query: about 12 B of
// point data and ~15 FLOPs each, read from L1/L2 because all queries of
// a cloud read the same points.  The TPU kernel built the first hit of
// each bucket with a prefix-OR over the (BM, N) hit plane and extracted
// the slots with segment-sum matmuls on the MXU; on the card one warp
// per query scans the cloud 32 points at a time in index order, so a
// bucket's first hit is a __ballot_sync and a first-set-bit: for W >= 32
// a bucket spans whole steps and one warp-uniform flag says whether it is
// filled yet; for W < 32 a step holds 32 / W whole buckets and a lane is
// selected when no lower lane of its bucket hit.  The selected lane
// writes its slot; an empty bucket is written with the first hit as soon
// as both are known (at the bucket's last step, or, for the buckets
// before the first hit, when that hit is found), the buckets past N
// after the scan.  Every slot is written once, and no state grows with
// nsample.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void put(float* out, int* idx, int slot, int k,
                                    float gx, float gy, float gz) {
  out[3 * slot + 0] = gx;
  out[3 * slot + 1] = gy;
  out[3 * slot + 2] = gz;
  if (idx) idx[slot] = k;
}

// One warp per query.  w_log2 = log2(W); idx_out may be null.
__global__ void __launch_bounds__(kThreads)
    ball_query_bucket_kernel(const float* __restrict__ xyz,
                             const float* __restrict__ new_xyz, int batch,
                             int n, int m, int nsample, int w_log2, float r2,
                             float* __restrict__ grouped,
                             int* __restrict__ cnt_out,
                             int* __restrict__ idx_out) {
  const int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (query >= batch * m) return;  // uniform per warp
  const int b = query / m;
  const int w = 1 << w_log2;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const float qx = new_xyz[3 * static_cast<size_t>(query) + 0];
  const float qy = new_xyz[3 * static_cast<size_t>(query) + 1];
  const float qz = new_xyz[3 * static_cast<size_t>(query) + 2];
  const float q2 = sqnorm(qx, qy, qz);
  float* out = grouped + static_cast<size_t>(query) * nsample * 3;
  int* idx = idx_out ? idx_out + static_cast<size_t>(query) * nsample
                     : nullptr;
  // W < 32: the lanes of this lane's bucket within a step
  const unsigned seg =
      w < 32 ? ((1u << w) - 1u) << (lane & ~(w - 1)) : 0xffffffffu;

  int cnt = 0;         // hits so far (warp-uniform)
  int first = -1;      // the first hit, once found (warp-uniform)
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;  // its bf16 offset
  bool filled = false;  // W >= 32: the current bucket has its hit
  for (int base = 0; base < n; base += 32) {
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
    if (first < 0) {
      if (ballot == 0u) continue;  // no hit yet: nothing to write
      first = base + __ffs(ballot) - 1;
      fx = to_bf16(__fsub_rn(__ldg(pts + 3 * first + 0), qx));
      fy = to_bf16(__fsub_rn(__ldg(pts + 3 * first + 1), qy));
      fz = to_bf16(__fsub_rn(__ldg(pts + 3 * first + 2), qz));
      // the buckets wholly before this step are empty
      for (int s = lane; s < (base >> w_log2); s += 32) {
        put(out, idx, s, first, fx, fy, fz);
      }
    }
    cnt += __popc(ballot);
    const int slot = k >> w_log2;
    if (w >= 32) {
      if ((base & (w - 1)) == 0) filled = false;  // a bucket starts
      if (!filled && ballot != 0u) {
        if (lane == __ffs(ballot) - 1) {
          put(out, idx, slot, k, to_bf16(__fsub_rn(px, qx)),
              to_bf16(__fsub_rn(py, qy)), to_bf16(__fsub_rn(pz, qz)));
        }
        filled = true;
      }
      const bool last_step = ((base + 32) & (w - 1)) == 0 || base + 32 >= n;
      if (last_step && !filled && lane == 0) {
        put(out, idx, slot, first, fx, fy, fz);
      }
    } else if (k < n) {
      const unsigned below = ballot & seg & ((1u << lane) - 1u);
      if (hit && below == 0u) {
        put(out, idx, slot, k, to_bf16(__fsub_rn(px, qx)),
            to_bf16(__fsub_rn(py, qy)), to_bf16(__fsub_rn(pz, qz)));
      } else if ((lane & (w - 1)) == 0 && (ballot & seg) == 0u) {
        put(out, idx, slot, first, fx, fy, fz);  // an empty bucket
      }
    }
  }

  if (first < 0) {
    // no hit: point 0, centred in f32
    const float gx = __fsub_rn(__ldg(pts + 0), qx);
    const float gy = __fsub_rn(__ldg(pts + 1), qy);
    const float gz = __fsub_rn(__ldg(pts + 2), qz);
    for (int s = lane; s < nsample; s += 32) put(out, idx, s, 0, gx, gy, gz);
  } else {
    // the buckets past the cloud's last point
    for (int s = ((n - 1) >> w_log2) + 1 + lane; s < nsample; s += 32) {
      put(out, idx, s, first, fx, fy, fz);
    }
  }
  if (lane == 0) cnt_out[query] = min(cnt, nsample);
}

}  // namespace

extern "C" {

// W = 2^w_log2 points per slot; idx may be null (no index output).
// Returns cudaGetLastError().
int ball_query_bucket_launch(const float* xyz, const float* new_xyz,
                             int batch, int n, int m, int nsample, int w_log2,
                             float r2, float* grouped, int* cnt, int* idx,
                             cudaStream_t stream) {
  const int queries = batch * m;
  const int blocks = (queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_bucket_kernel<<<blocks, kThreads, 0, stream>>>(
      xyz, new_xyz, batch, n, m, nsample, w_log2, r2, grouped, cnt, idx);
  return static_cast<int>(cudaGetLastError());
}

const char* ball_query_bucket_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
