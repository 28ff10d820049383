// Ball query: four entry points over one scan.
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
// 4. ball_query_bucket_launch (B8) replaces articulated_pose_tpu/ops/
//    pallas/ball_query_bucket.py::query_ball_group_bucket (body
//    _ballq_bucket_kernel), the "bucket" tier: with n_pad = ceil(N / 128)
//    * 128 and W = n_pad / nsample a power of two, slot j holds the FIRST
//    hit among points [j W, (j + 1) W); an empty bucket repeats the
//    cloud's first hit; cnt = min(every hit, nsample); a selected offset
//    p - q is rounded to nearest-even bf16 and returned as f32 (the TPU
//    carried it through a bf16 matmul); with no hit at all every slot is
//    point 0, its offset unrounded.
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
// until nsample hits are in, ~9 FLOPs per scanned (query, point) pair,
// and writes its nsample slots (idx, and 12 B a slot of grouped rows,
// the largest byte count of the call at the bench shape).  The first
// design, one warp per query scanning device memory, spent its time
// elsewhere: every query re-read its cloud as three strided 4-byte loads
// a point and recomputed |p|^2; each 32-point step waited on its own
// loads, since the loop's exit depends on the step's ballot; every hit
// paid two population counts (a quarter-rate instruction) for its slot;
// the grouped rows left as scattered 4-byte stores; the packed tier's
// quantiser was a launch of its own.  The design here:
//   - A CTA of 8 warps answers 8 G queries of one cloud, and stages the
//     cloud in shared memory as float4 (x, y, z, |p|^2), |p|^2 once a
//     point in sqnorm's operation order, so a point is one 16-byte shared
//     load for all the CTA's queries.  A cloud that fits is staged whole;
//     a larger one (the plan says which) streams through a 2048-point
//     tile whose successor is loaded into registers while the tile is
//     scanned (the AoS points convert to float4 on the way in, which a
//     cp.async or TMA copy of the raw bytes could not do without a
//     second pass); the CTA stops after the tile in which every one of
//     its queries has nsample hits, block-uniformly.
//   - A warp holds G queries and each lane tests U points a step: G x U
//     independent distance tests a step, the next step's points loaded
//     before this step's counts decide whether it runs.
//   - A step's ballots are written as they are, the words of each query's
//     hit bitmap, and counted with one warp reduction a query; after the
//     scan (of the tile, when streamed) one pass over the bitmap ranks
//     the hits with a prefix sum of the words' bit counts and places the
//     first nsample in index order.  The first hit is the lowest set bit.
//   - Slots go to shared memory; a warp then writes a query's idx and
//     grouped rows, the rows as 16-byte stores.
//   - The packed tier reduces the bounding box from the staged cloud and
//     dequantises each written point in the epilogue, bit for bit as
//     quantize_kernel does; only where the cloud streams does quantize_
//     kernel still run first and write its (B, N, 3) plane.
// Several warps a query (splitting each step, exchanging counts through
// shared memory with a named barrier a step) were swept and lost at
// every path shape, the large cloud's included (PERF.md section 6).  The
// launch plan (variant (G, U), staged or streamed) comes from the shapes
// alone: ops/kernels/ball_query.py::bq_plan.
//
// The bucket tier is the same scan with a fourth epilogue.  Unlike the
// first-S tiers, every query must examine its whole cloud (cnt counts
// every hit, and each bucket needs its own first hit), so the scan never
// stops early, and the hit bitmap of the cloud is exactly what the
// epilogue needs: one lane a slot takes the lowest set bit of its
// bucket's bits (W >= 32: whole words; W < 32: a masked word), an empty
// bucket -1; a last pass gives the empty ones the lowest filled slot's
// point, which is the cloud's first hit.  Where the cloud streams, a
// tile's buckets are settled after the tile, and a bucket wider than a
// tile keeps the hit an earlier tile gave it (its slot is the flag).
// The first design (one warp per query over device memory, three strided
// loads and |p|^2 a pair, a step's ballot deciding the bucket's state
// before the next load, 12-byte scalar stores) ran at 18-30x its bound.
// The hit test is in_ball: its fma(-2, inner, q2 + p2) equals the TPU
// kernel's (q2 + p2) - 2 inner bit for bit, because 2 inner is exact.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;                       // points a streamed tile
constexpr int kTilePerThread = kTile / kThreads;  // its points a thread
constexpr int kQuantThreads = 256;
constexpr float kLevels = 1023.0f;
// the dynamic shared memory a launch may take without opting in
constexpr size_t kDefaultSmem = 47 * 1024;

// (G queries a warp, U points a lane a step) of each variant, in the
// order of ops/kernels/ball_query.py's VARIANTS
#define BQ_VARIANTS(X) X(1, 4) X(1, 8) X(4, 4) X(4, 8)

struct Args {
  const float* xyz;      // (batch, n, 3): the hit test
  const float* coords;   // (batch, n, 3): the rows a streamed launch copies
  const float* new_xyz;  // (batch, m, 3)
  int batch, n, m, nsample;
  float r2;
  float* grouped;        // (batch, m, nsample, 3), or null
  int* cnt;              // (batch, m)
  int* idx;              // (batch, m, nsample), or null
  int staged;            // the whole cloud in shared memory
  int packed;            // grouped rows dequantised from the staged cloud
  int tile_pts;          // points of the shared tile (padded)
  int w_log2;            // the bucket tier: log2 of its bucket width W
};

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float4 nan4() {
  // padding past the cloud: d2 is NaN, never below r2
  return make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
}

__device__ __forceinline__ float4 point4(float x, float y, float z) {
  return make_float4(x, y, z, sqnorm(x, y, z));
}

__device__ __forceinline__ bool in_ball(const float4 p, float qx, float qy,
                                        float qz, float q2, float r2) {
  const float inner = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
  // (q2 + p2) - 2 inner: 2 inner is exact, so one fused multiply-add
  // rounds the difference once, as the separate multiply and subtract do
  const float d2 = __fmaf_rn(-2.0f, inner, __fadd_rn(q2, p.w));
  return d2 < r2;
}

// The U ballot words of one query's step, one store by lane 0 (the
// chunk index is a multiple of U and a row a multiple of U words, so the
// store is aligned)
template <int U>
__device__ __forceinline__ void store_words(unsigned* p,
                                            const unsigned (&w)[U]) {
  if constexpr (U == 8) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
    static_assert(U == 4, "U is 4 or 8");
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The scan of `count` staged points (a multiple of the step, 32 U) for
// this warp's G queries.  Each 32-point chunk's ballot is the chunk's
// word of the query's hit bitmap (`bits`, G rows of `nwords`); cnt counts
// every hit (it may pass nsample).  The ranks are left to `extract`, so
// a step costs a ballot and a lane count a (query, point) pair and one
// warp reduction a query, and no population counts; the next step's
// points are loaded before this step's counts decide whether it runs.
// Stops once all G queries are full; returns the end of the scanned
// prefix.
template <int G, int U>
__device__ __forceinline__ int scan(const float4* cloud, int count, int lane,
                                    int nsample, float r2,
                                    const float (&qx)[G], const float (&qy)[G],
                                    const float (&qz)[G], const float (&q2)[G],
                                    int (&cnt)[G], unsigned* bits,
                                    int nwords) {
  constexpr int kStep = 32 * U;
  float4 p[U];
#pragma unroll
  for (int u = 0; u < U; ++u) p[u] = cloud[u * 32 + lane];
  int base = 0;
  for (; base < count; base += kStep) {
    bool full = true;
#pragma unroll
    for (int g = 0; g < G; ++g) full = full && cnt[g] >= nsample;
    if (full) break;
    unsigned bal[G][U];
    int total[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int hits = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool hit = in_ball(p[u], qx[g], qy[g], qz[g], q2[g], r2);
        bal[g][u] = __ballot_sync(0xffffffffu, hit);
        hits += hit;
      }
      total[g] = hits;
    }
    // the next step's points (the last step reloads its own)
    const int next = min(base + kStep, count - kStep);
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = cloud[next + u * 32 + lane];
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        store_words<U>(bits + g * nwords + base / 32, bal[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      cnt[g] += __reduce_add_sync(0xffffffffu, total[g]);
    }
  }
  return base;
}

// A query's slots from its hit bitmap: the set bits of words[0, nw) in
// order (bit j of word w is point base + 32 w + j), appended from slot
// `have` while fewer than nsample are in.  One warp: a prefix sum of the
// words' bit counts places each lane's bits.
__device__ __forceinline__ void extract(const unsigned* words, int nw,
                                        unsigned base, int have, int nsample,
                                        int* slots, int lane) {
  for (int w0 = 0; w0 < nw && have < nsample; w0 += 32) {
    const int w = w0 + lane;
    unsigned b = w < nw ? words[w] : 0u;
    const int c = __popc(b);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    int slot = have + incl - c;
    while (b != 0u && slot < nsample) {
      slots[slot++] = static_cast<int>(base + 32u * w + __ffs(b) - 1);
      b &= b - 1u;
    }
    have += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// The bucket tier's slots from one scanned stretch of the cloud: points
// [t0, t0 + span), whose hit bitmap is words[0, nw) (the points past
// 32 nw were not scanned and hold no hit).  Slot s owns the points
// [s W, (s + 1) W), W = 2^w_log2.  A bucket that starts in the stretch
// takes its first hit here, or -1 (empty so far); one that started in an
// earlier stretch (W > span) takes this stretch's first hit only while
// it is still empty.  One lane a slot.
__device__ __forceinline__ void settle(const unsigned* words, int nw,
                                       unsigned t0, int span, int w_log2,
                                       int nsample, int* slots, int lane) {
  const unsigned end = t0 + 32u * nw;
  const int s_end = min(nsample,
                        static_cast<int>(((t0 + span - 1) >> w_log2) + 1));
  for (int s = static_cast<int>(t0 >> w_log2) + lane; s < s_end; s += 32) {
    const unsigned b0 = static_cast<unsigned>(s) << w_log2;
    const unsigned lo = max(b0, t0) - t0;                   // local bits
    const unsigned hi = min(b0 + (1u << w_log2), end) - t0;
    int k = -1;
    for (unsigned w = lo >> 5; lo < hi && 32u * w < hi && k < 0; ++w) {
      unsigned bits = words[w];
      if (32u * w < lo) bits &= ~0u << (lo - 32u * w);
      if (hi - 32u * w < 32u) bits &= (1u << (hi - 32u * w)) - 1u;
      if (bits != 0u) k = static_cast<int>(t0 + 32u * w + __ffs(bits) - 1);
    }
    if (b0 >= t0) {
      slots[s] = k;                 // the bucket starts in this stretch
    } else if (k >= 0 && slots[s] < 0) {
      slots[s] = k;
    }
  }
}

// The bucket tier's last pass over a query's slots: an empty one (-1)
// takes the lowest filled slot's point, which is the cloud's first hit;
// with no hit at all every slot takes point 0.  Returns whether the
// query has a hit.  One warp.
__device__ __forceinline__ bool fill_empty(int* slots, int nsample,
                                           int lane) {
  int first = -1;
  for (int s0 = 0; s0 < nsample && first < 0; s0 += 32) {
    const int s = s0 + lane;
    const int k = s < nsample ? slots[s] : -1;
    const unsigned found = __ballot_sync(0xffffffffu, k >= 0);
    if (found != 0u) first = __shfl_sync(0xffffffffu, k, __ffs(found) - 1);
  }
  for (int s = lane; s < nsample; s += 32) {
    if (slots[s] < 0) slots[s] = max(first, 0);
  }
  return first >= 0;
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A streamed tile's points, one register triple per point of this thread
__device__ __forceinline__ void load_tile(const float* pts, unsigned un,
                                          unsigned t0,
                                          float (&r)[kTilePerThread][3]) {
#pragma unroll
  for (int p = 0; p < kTilePerThread; ++p) {
    const unsigned k = t0 + p * kThreads + threadIdx.x;
    if (k < un) {
      const size_t k3 = 3 * static_cast<size_t>(k);
      r[p][0] = __ldg(pts + k3 + 0);
      r[p][1] = __ldg(pts + k3 + 1);
      r[p][2] = __ldg(pts + k3 + 2);
    }
  }
}

// The packed tier's bounding box from the staged cloud: box[c] = mn,
// box[3 + c] = 1023 / ext, box[6 + c] = ext * f32(1/1023), as
// quantize_kernel computes them (min and max are exact in any order).
// Every thread calls it; box is ready after the caller's next barrier.
__device__ void reduce_box(const float4* cloud, int n, float* box) {
  __shared__ float red[2][3][kWarps];
  float mn[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float mx[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float4 p = cloud[k];
    mn[0] = fminf(mn[0], p.x);
    mn[1] = fminf(mn[1], p.y);
    mn[2] = fminf(mn[2], p.z);
    mx[0] = fmaxf(mx[0], p.x);
    mx[1] = fmaxf(mx[1], p.y);
    mx[2] = fmaxf(mx[2], p.z);
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
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, red[0][c][w]);
      hi = fmaxf(hi, red[1][c][w]);
    }
    const float ext = fmaxf(__fsub_rn(hi, lo), 1e-6f);
    box[c] = lo;
    box[3 + c] = __fdiv_rn(kLevels, ext);
    box[6 + c] = __fmul_rn(ext, __fdiv_rn(1.0f, kLevels));
  }
}

__device__ __forceinline__ float dequantise(float p, const float* box,
                                            int c) {
  const float lo = box[c];
  const float q = fminf(
      fmaxf(floorf(__fmaf_rn(__fsub_rn(p, lo), box[3 + c], 0.5f)), 0.0f),
      kLevels);
  return __fmaf_rn(q, box[6 + c], lo);
}

// One CTA: queries [m0, m0 + qc) of cloud b, qc = 8 G, G a warp.
// Shared memory (dynamic): the tile (float4 a point), the hit bitmaps
// (qc rows of tile / 32 words), the slots (qc rows of nsample), the
// queries (qc x 3), the packed tier's box (9) and, for the bucket tier,
// whether each query has a hit (qc).
template <bool kGrouped, bool kBucket, int G, int U>
__global__ void __launch_bounds__(kThreads) ball_query_kernel(const Args a) {
  static_assert(kGrouped || !kBucket, "the bucket tier is grouped");
  extern __shared__ float4 smem[];
  const int qc = kWarps * G;
  const int S = a.nsample;
  // a query is full at `stop` hits: never in the bucket tier, whose
  // count and buckets need the whole cloud
  const int stop = kBucket ? INT_MAX : S;
  const int nwords = a.tile_pts / 32;
  float4* cloud = smem;
  unsigned* sbits = reinterpret_cast<unsigned*>(cloud + a.tile_pts);
  int* sidx = reinterpret_cast<int*>(sbits + qc * nwords);
  float* sq = reinterpret_cast<float*>(sidx + qc * S);
  float* box = sq + 3 * qc;
  int* shit = reinterpret_cast<int*>(box + 9);

  const int tiles_m = (a.m + qc - 1) / qc;
  const int b = blockIdx.x / tiles_m;
  const int m0 = (blockIdx.x - b * tiles_m) * qc;
  const int qv = min(qc, a.m - m0);  // queries this CTA answers
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned un = static_cast<unsigned>(a.n);
  const float* pts = a.xyz + static_cast<size_t>(b) * a.n * 3;
  const size_t row0 = static_cast<size_t>(b) * a.m + m0;

  float qx[G], qy[G], qz[G], q2[G];
  int cnt[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ql = warp * G + g;
    if (ql < qv) {
      const float* q = a.new_xyz + 3 * (row0 + ql);
      qx[g] = __ldg(q + 0);
      qy[g] = __ldg(q + 1);
      qz[g] = __ldg(q + 2);
      q2[g] = sqnorm(qx[g], qy[g], qz[g]);
      cnt[g] = 0;
      if (lane == 0) {
        sq[3 * ql + 0] = qx[g];
        sq[3 * ql + 1] = qy[g];
        sq[3 * ql + 2] = qz[g];
      }
    } else {
      qx[g] = qy[g] = qz[g] = q2[g] = CUDART_NAN_F;
      cnt[g] = stop;  // no query here: full from the start
    }
  }

  unsigned* my_bits = sbits + warp * G * nwords;
  int* my_idx = sidx + warp * G * S;
  if (a.staged) {
#pragma unroll 4
    for (int k = threadIdx.x; k < a.tile_pts; k += kThreads) {
      if (static_cast<unsigned>(k) < un) {
        const float* p = pts + 3 * static_cast<size_t>(k);
        cloud[k] = point4(__ldg(p + 0), __ldg(p + 1), __ldg(p + 2));
      } else {
        cloud[k] = nan4();
      }
    }
    __syncthreads();
    const int end = scan<G, U>(cloud, a.tile_pts, lane, stop, a.r2, qx, qy,
                               qz, q2, cnt, my_bits, nwords);
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (kBucket) {
        settle(my_bits + g * nwords, end / 32, 0u, a.tile_pts, a.w_log2, S,
               my_idx + g * S, lane);
      } else {
        extract(my_bits + g * nwords, end / 32, 0u, 0, S, my_idx + g * S,
                lane);
      }
    }
  } else {
    constexpr int kStep = 32 * U;
    float r[kTilePerThread][3];
    load_tile(pts, un, 0u, r);
    for (unsigned t0 = 0;; t0 += kTile) {
#pragma unroll
      for (int p = 0; p < kTilePerThread; ++p) {
        const unsigned k = t0 + p * kThreads + threadIdx.x;
        cloud[p * kThreads + threadIdx.x] =
            k < un ? point4(r[p][0], r[p][1], r[p][2]) : nan4();
      }
      __syncthreads();
      const unsigned left = un - t0;  // > 0
      const bool more = left > static_cast<unsigned>(kTile);
      if (more) load_tile(pts, un, t0 + kTile, r);  // in flight meanwhile
      const int count =
          more ? kTile : static_cast<int>((left + kStep - 1) / kStep * kStep);
      int have[G];
#pragma unroll
      for (int g = 0; g < G; ++g) have[g] = cnt[g];
      const int end = scan<G, U>(cloud, count, lane, stop, a.r2, qx, qy, qz,
                                 q2, cnt, my_bits, nwords);
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (kBucket) {
          settle(my_bits + g * nwords, end / 32, t0, kTile, a.w_log2, S,
                 my_idx + g * S, lane);
        } else {
          extract(my_bits + g * nwords, end / 32, t0, have[g], S,
                  my_idx + g * S, lane);
        }
      }
      bool full = true;
#pragma unroll
      for (int g = 0; g < G; ++g) full = full && cnt[g] >= stop;
      // also keeps the next tile's stores off this tile and its bitmaps
      const int all_full = __syncthreads_and(full);
      if (all_full || !more) break;
    }
  }
  __syncthreads();

  // slots past the count (the bucket tier: empty buckets) take the first
  // hit (point 0 without one)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ql = warp * G + g;
    if (ql < qv) {
      const int c = min(cnt[g], S);
      int* slots = sidx + ql * S;
      if constexpr (kBucket) {
        const bool hit = fill_empty(slots, S, lane);
        if (lane == 0) shit[ql] = hit;
      } else {
        const int first = c > 0 ? slots[0] : 0;
        for (int s = c + lane; s < S; s += 32) slots[s] = first;
      }
      if (lane == 0) a.cnt[row0 + ql] = c;
    }
  }
  if (kGrouped && a.packed) reduce_box(cloud, a.n, box);
  __syncthreads();

  if (a.idx) {
    int* out = a.idx + row0 * S;
    for (int e = threadIdx.x; e < qv * S; e += kThreads) out[e] = sidx[e];
  }
  if (kGrouped) {
    // one warp a query's row of S x 3 floats, 16-byte stores where every
    // row starts 16-byte aligned
    const float* cloud_f = reinterpret_cast<const float*>(cloud);
    const float* src = a.coords + static_cast<size_t>(b) * a.n * 3;
    const int row = 3 * S;
    const bool vec =
        (reinterpret_cast<uintptr_t>(a.grouped) & 15u) == 0 && row % 4 == 0;
    for (int ql = warp; ql < qv; ql += kWarps) {
      const int* slots = sidx + ql * S;
      const float* q = sq + 3 * ql;
      auto value = [&](int e) -> float {
        const int s = e / 3;
        const int c = e - 3 * s;
        const int k = slots[s];
        float p;
        if (a.staged) {
          p = cloud_f[4 * k + c];
          if (a.packed) p = dequantise(p, box, c);
        } else {
          p = __ldg(src + 3 * static_cast<size_t>(k) + c);
        }
        const float d = __fsub_rn(p, q[c]);
        // the bucket tier rounds a selected point's offset to bf16
        return kBucket && shit[ql] ? to_bf16(d) : d;
      };
      float* out = a.grouped + (row0 + ql) * row;
      if (vec) {
        float4* out4 = reinterpret_cast<float4*>(out);
        for (int v = lane; v < row / 4; v += 32) {
          out4[v] = make_float4(value(4 * v), value(4 * v + 1),
                                value(4 * v + 2), value(4 * v + 3));
        }
      } else {
        for (int e = lane; e < row; e += 32) out[e] = value(e);
      }
    }
  }
}

// The packed tier's prologue where the cloud streams: one block per cloud
// reduces the bounding box, then writes every point's dequantised
// coordinates to `deq`.
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
      const float v = pts[3 * static_cast<size_t>(k) + c];
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
      const size_t e = 3 * static_cast<size_t>(k) + c;
      const float q = fminf(
          fmaxf(floorf(__fmaf_rn(__fsub_rn(pts[e], lo[c]), scl[c], 0.5f)),
                0.0f),
          kLevels);
      out[e] = __fmaf_rn(q, inv[c], lo[c]);
    }
  }
}

using KernelFn = void (*)(Args);

#define BQ_G(g, u) g,
#define BQ_U(g, u) u,
constexpr int kVariantG[] = {BQ_VARIANTS(BQ_G)};
constexpr int kVariantU[] = {BQ_VARIANTS(BQ_U)};
#undef BQ_G
#undef BQ_U
constexpr int kVariants = sizeof(kVariantG) / sizeof(kVariantG[0]);

template <bool kGrouped, bool kBucket>
KernelFn kernel_for(int variant) {
#define BQ_FN(g, u) &ball_query_kernel<kGrouped, kBucket, g, u>,
  static const KernelFn table[] = {BQ_VARIANTS(BQ_FN)};
#undef BQ_FN
  return table[variant];
}

enum Tier { kIdxTier, kGroupTier, kBucketTier };

// One launch of the scan at (variant, staged); a plan the card
// refuses (too much shared memory, too many CTAs) returns its error.
int launch(Tier tier, int variant, int staged, int packed, Args a,
           cudaStream_t stream) {
  if (variant < 0 || variant >= kVariants ||
      a.batch < 1 ||
      a.n < 1 || a.m < 1 || a.nsample < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = kVariantG[variant];
  const int U = kVariantU[variant];
  const long long qc = kWarps * G;
  const long long step = 32LL * U;
  const long long tile_pts = staged ? (a.n + step - 1) / step * step : kTile;
  const long long bytes = 16 * tile_pts + 4 * (qc * (tile_pts / 32)) +
                          4 * (qc * a.nsample) + 4 * (3 * qc) + 4 * 9 +
                          (tier == kBucketTier ? 4 * qc : 0);
  const long long blocks = static_cast<long long>(a.batch) *
                           ((a.m + qc - 1) / qc);
  if (bytes > (1LL << 30) || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  a.staged = staged;
  a.packed = packed;
  a.tile_pts = static_cast<int>(tile_pts);
  const KernelFn fn = tier == kBucketTier  ? kernel_for<true, true>(variant)
                      : tier == kGroupTier ? kernel_for<true, false>(variant)
                                           : kernel_for<false, false>(variant);
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

Args make_args(const float* xyz, const float* coords, const float* new_xyz,
               int batch, int n, int m, int nsample, float r2, float* grouped,
               int* cnt, int* idx) {
  Args a{};
  a.xyz = xyz;
  a.coords = coords;
  a.new_xyz = new_xyz;
  a.batch = batch;
  a.n = n;
  a.m = m;
  a.nsample = nsample;
  a.r2 = r2;
  a.grouped = grouped;
  a.cnt = cnt;
  a.idx = idx;
  return a;
}

}  // namespace

extern "C" {

// Each entry takes the plan first: variant (an index into BQ_VARIANTS),
// and staged (1: the whole cloud in shared memory).  Launches on
// `stream` and returns cudaGetLastError() (or the refusal's code).

// idx may be null (no index output).
int ball_query_group_launch(int variant, int staged,
                            const float* xyz, const float* new_xyz, int batch,
                            int n, int m, int nsample, float r2,
                            float* grouped, int* cnt, int* idx,
                            cudaStream_t stream) {
  return launch(kGroupTier, variant, staged, 0,
                make_args(xyz, xyz, new_xyz, batch, n, m, nsample, r2,
                          grouped, cnt, idx),
                stream);
}

// The bucket tier, W = 2^w_log2 points a slot; the caller keeps
// nsample * W = ceil(n / 128) * 128.  idx may be null.
int ball_query_bucket_launch(int variant, int staged, const float* xyz,
                             const float* new_xyz, int batch, int n, int m,
                             int nsample, int w_log2, float r2,
                             float* grouped, int* cnt, int* idx,
                             cudaStream_t stream) {
  if (w_log2 < 0 || w_log2 > 30 ||
      (static_cast<long long>(nsample) << w_log2) < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(xyz, xyz, new_xyz, batch, n, m, nsample, r2, grouped,
                     cnt, idx);
  a.w_log2 = w_log2;
  return launch(kBucketTier, variant, staged, 0, a, stream);
}

// A staged launch dequantises in the scan's epilogue (deq unused, may be
// null); a streamed one first runs quantize_kernel into deq, a
// (batch, n, 3) scratch plane, then copies rows from it.  idx may be null.
int ball_query_group_packed_launch(int variant, int staged,
                                   const float* xyz, const float* new_xyz,
                                   int batch, int n, int m, int nsample,
                                   float r2, float* deq, float* grouped,
                                   int* cnt, int* idx, cudaStream_t stream) {
  const float* coords = xyz;
  if (!staged) {
    if (deq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    quantize_kernel<<<batch, kQuantThreads, 0, stream>>>(xyz, n, deq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    coords = deq;
  }
  return launch(kGroupTier, variant, staged, staged,
                make_args(xyz, coords, new_xyz, batch, n, m, nsample, r2,
                          grouped, cnt, idx),
                stream);
}

// idx is required.
int ball_query_idx_launch(int variant, int staged, const float* xyz,
                          const float* new_xyz, int batch, int n, int m,
                          int nsample, float r2, int* cnt, int* idx,
                          cudaStream_t stream) {
  if (idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kIdxTier, variant, staged, 0,
                make_args(xyz, xyz, new_xyz, batch, n, m, nsample, r2,
                          nullptr, cnt, idx),
                stream);
}

const char* ball_query_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
