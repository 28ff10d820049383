// The joint stage of the pose fit in one launch: the `joint_fit` entry.
//
// It replaces no TPU kernel.  fit_frame_batch (pose/pipeline.py) solves
// each joint of a frame as a constrained RANSAC over two parts, the base
// part 0 and the moving part j + 1: H minimal-sample hypotheses by
// alternating Kabsch (lm.py::joint_transformation_estimate_alt), their
// inlier counts over both parts' score prefix
// (ransac.py::hypothesis_inlier_counts), the best one's inlier sets, and
// a damped Gauss-Newton refit on them (lm.py::joint_transformation_estimate).
// As plain PyTorch that is ~5,700 small launches a joint.  Here one CTA
// solves one (frame, joint) problem, and one launch covers every joint
// of a batch, revolute or prismatic (a bit a joint).
//
// The votes read what the plain path reads.  The inlier tests, the
// scores' argmax, the "3 inliers, else the mask" rule and the refit's
// cost test turn rounding into another pose (a Gauss-Newton step still
// ~1e-4 long after lm_iters is kept or dropped by a cost that rounds
// otherwise), so the kernel computes every value of the plain path in
// its order and rounding on the card, as torch launches it at the plain
// call's batch (one joint of B frames a call):
//   - elementwise ops one by one (__f*_rn, -fmad=false);
//   - a sum over a tensor's last, contiguous dim: torch's lanes (min(2^k,
//     32)), four accumulators a lane, float4 loads from 128 values with
//     the row's unaligned head first, the warps' split of long rows, the
//     shuffle tree with the offset halving (Reduce.cuh; `tsum`,
//     `warp_fast_sum`);
//   - a sum over rows: one output a thread, four accumulators, the rows
//     split across warps where they are many (`rsum`, `rows_sums`);
//   - cuBLAS products: a gemm's dot over k is an fma chain from the first
//     product (`gemm_dot`, the K = rows cross-covariances, the 3x3
//     products); a batched 3x3 by 3-vector product takes one of a few
//     orders by its batch count (`dot3`);
//   - the 6x6 solve as MAGMA's batched LU and the triangular solves
//     (`solve6`).
// These orders were read on the card's torch (2.11, CUDA 12.8) against
// torch's own results bit for bit; another torch or cuBLAS may take
// others (ops/kernels/joint_fit.py keeps the product tables, and
// `joint_fit_dot3` lets `chip_smoke.py --joint-orders` re-read them).
//
// Work a problem: H hypotheses (a thread each, 8 Horn solves of 12
// squarings), 2 x H x S (hypothesis, point) score pairs of 16 fmas (a
// thread a point, the counts by ballot), the best's residual over the
// buffers, the refit's 16 pairwise-scale sums and cross-covariances over
// its rows, and lm_iters Gauss-Newton steps of three reductions each.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // hypotheses held in shared memory at once
constexpr int kFit = 26;     // R0 (9), s0, t0 (3), R1 (9), s1, t1 (3)
constexpr int kRow = 17;     // a hypothesis's score row: 16 terms, |t|^2

struct Args {
  const float* src;    // (batch, parts, cap, 3), valid rows first
  const float* tgt;    // (batch, parts, cap, 3)
  const float* mask;   // (batch, parts, cap)
  const float* axes;   // (batch, joints, 3)
  const float* draws;  // (batch, joints, 2, hyps, 3)
  int batch, parts, cap, hyps, score_points, refit_points, lm_iters;
  unsigned prismatic;  // bit j: joint j is prismatic
  float inlier_th;     // float32(inlier_th)
  float inlier_th2;    // float32(inlier_th * inlier_th)
  // dot3's orders of the plain path's tiny products: A v at its batch of
  // B * hyps (hypotheses) and of B (refit), A^T v at B (refit)
  int order_hyp, order_mv, order_mvt;
  float* work;         // (batch, joints, 12 refit_points + 4): the refit's
                       // elementwise values, summed as torch sums them
  float* fit;          // (batch, joints, 26)
  int* best;           // (batch, joints)
  float* scores;       // (batch, joints, hyps)
  uint8_t* inliers;    // (batch, joints, 2, cap): the refit's weights
  float* hyp;          // (batch, joints, hyps, 26), or null
};

// ---- torch's rounding ----------------------------------------------------

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
// torch.clamp_min and torch.maximum keep a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a >= b ? a : b));
}

__host__ __device__ constexpr int last_pow2(int n) {
  return n < 2 ? 1 : 2 * last_pow2(n / 2);
}

// a sum over the last, contiguous dim of a tensor
template <int N>
__device__ __forceinline__ float tsum(const float (&a)[N]) {
  constexpr int kLanes = last_pow2(N) < 32 ? last_pow2(N) : 32;
  float lane[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int m = 0; l + m * kLanes < N; ++m) {
      acc[m & 3] = add(acc[m & 3], a[l + m * kLanes]);
    }
    lane[l] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) lane[l] = add(lane[l], lane[l + off]);
  }
  return lane[0];
}

// a sum over rows
template <int N>
__device__ __forceinline__ float rsum(const float (&a)[N]) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < N; ++m) acc[m & 3] = add(acc[m & 3], a[m]);
  return add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
  const float v[3] = {a, b, c};
  return tsum<3>(v);
}

__device__ __forceinline__ float sqnorm3(const float* v) {
  return sum3(mul(v[0], v[0]), mul(v[1], v[1]), mul(v[2], v[2]));
}

// a batched 3x3 by 3-vector product's entry, sum_k a[k] b[k], in the
// order cuBLAS takes at the plain call's batch count (0: fma chain;
// 1: fma(a1, b1, a0 b0) + a2 b2; 2: fma(a2, b2, a0 b0) + a1 b1; 3 and 4:
// products added in order 0 1 2 or 0 2 1; ops/kernels/joint_fit.py::
// dot_orders)
__device__ __forceinline__ float dot3(const float* a, const float* b,
                                      int order) {
  const float p0 = mul(a[0], b[0]);
  switch (order) {
    case 0: return fma_rn(a[2], b[2], fma_rn(a[1], b[1], p0));
    case 1: return add(fma_rn(a[1], b[1], p0), mul(a[2], b[2]));
    case 2: return add(fma_rn(a[2], b[2], p0), mul(a[1], b[1]));
    case 3: return add(add(p0, mul(a[1], b[1])), mul(a[2], b[2]));
    default: return add(add(p0, mul(a[2], b[2])), mul(a[1], b[1]));
  }
}

// a cuBLAS gemm's dot over k: an fma chain from the first product
template <int N>
__device__ __forceinline__ float gemm_dot(const float* a, const float* b) {
  float acc = mul(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) acc = fma_rn(a[k], b[k], acc);
  return acc;
}

// ---- one hypothesis, as joint_hypotheses computes it ---------------------

// |p - q| as umeyama._norm
__device__ __forceinline__ float pair_norm(const float* p, const float* q) {
  const float d[3] = {sub(p[0], q[0]), sub(p[1], q[1]), sub(p[2], q[2])};
  return sqrt_rn(clamp_min(sqnorm3(d), 0.0f));
}

// pairwise_scale_both of 3 unit-weight points (its all-pairs branch)
__device__ void scales3(const float (&s)[3][3], const float (&t)[3][3],
                        float& scale, float& scale_inv) {
  float aa[9], bb[9], ab[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a = pair_norm(s[i], s[j]);
      const float b = pair_norm(t[i], t[j]);
      aa[3 * i + j] = mul(a, a);
      bb[3 * i + j] = mul(b, b);
      ab[3 * i + j] = mul(a, b);
    }
  }
  const float A = tsum<9>(aa), B = tsum<9>(bb), C = tsum<9>(ab);
  scale = dvd(C, add(A, 1e-6f));
  scale_inv = dvd(C, add(B, 1e-6f));
}

// Horn's rotation of a cross-covariance (umeyama._horn_rotation)
__device__ void fro_div(float (&B)[16], float lo) {
  float sq[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) sq[k] = mul(B[k], B[k]);
  float f = sqrt_rn(tsum<16>(sq));
  if (lo > 0.0f) f = clamp_min(f, lo);
#pragma unroll
  for (int k = 0; k < 16; ++k) B[k] = dvd(B[k], f);
}

__device__ void horn(const float (&M)[3][3], float (&R)[3][3]) {
  const float Sxx = M[0][0], Syx = M[0][1], Szx = M[0][2];
  const float Sxy = M[1][0], Syy = M[1][1], Szy = M[1][2];
  const float Sxz = M[2][0], Syz = M[2][1], Szz = M[2][2];
  float B[16] = {add(add(Sxx, Syy), Szz), sub(Syz, Szy), sub(Szx, Sxz),
                 sub(Sxy, Syx),
                 sub(Syz, Szy), sub(sub(Sxx, Syy), Szz), add(Sxy, Syx),
                 add(Szx, Sxz),
                 sub(Szx, Sxz), add(Sxy, Syx), sub(add(-Sxx, Syy), Szz),
                 add(Syz, Szy),
                 sub(Sxy, Syx), add(Szx, Sxz), add(Syz, Szy),
                 add(sub(-Sxx, Syy), Szz)};
  float sq[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) sq[k] = mul(B[k], B[k]);
  const float shift = add(sqrt_rn(tsum<16>(sq)), 1e-6f);
  // N + shift * eye(4): the off-diagonal entries add shift * 0
#pragma unroll
  for (int k = 0; k < 16; ++k) B[k] = add(B[k], (k % 5 == 0) ? shift : 0.0f);
  fro_div(B, 0.0f);
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    float B2[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o = mul(B[4 * i], B[j]);
#pragma unroll
        for (int k = 1; k < 4; ++k) o = add(o, mul(B[4 * i + k], B[4 * k + j]));
        B2[4 * i + j] = o;
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) B[k] = B2[k];
    fro_div(B, 1e-9f);
  }
  float cn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float col[4] = {mul(B[c], B[c]), mul(B[4 + c], B[4 + c]),
                          mul(B[8 + c], B[8 + c]), mul(B[12 + c], B[12 + c])};
    cn[c] = rsum<4>(col);
  }
  const int best01 = cn[0] >= cn[1] ? 0 : 1;
  const int best23 = cn[2] >= cn[3] ? 2 : 3;
  const int col = tmax(cn[0], cn[1]) >= tmax(cn[2], cn[3]) ? best01 : best23;
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = col == 0 ? B[4 * i] : col == 1 ? B[4 * i + 1]
         : col == 2 ? B[4 * i + 2] : B[4 * i + 3];
  }
  const float qq[4] = {mul(q[0], q[0]), mul(q[1], q[1]), mul(q[2], q[2]),
                       mul(q[3], q[3])};
  const float qn = clamp_min(sqrt_rn(tsum<4>(qq)), 1e-9f);
  const float a = dvd(q[0], qn), b = dvd(q[1], qn), c = dvd(q[2], qn),
              d = dvd(q[3], qn);
  const float aa = mul(a, a), bb = mul(b, b), cc = mul(c, c), dd = mul(d, d);
  R[0][0] = sub(sub(add(aa, bb), cc), dd);
  R[0][1] = mul(2.0f, sub(mul(b, c), mul(a, d)));
  R[0][2] = mul(2.0f, add(mul(b, d), mul(a, c)));
  R[1][0] = mul(2.0f, add(mul(b, c), mul(a, d)));
  R[1][1] = sub(add(sub(aa, bb), cc), dd);
  R[1][2] = mul(2.0f, sub(mul(c, d), mul(a, b)));
  R[2][0] = mul(2.0f, sub(mul(b, d), mul(a, c)));
  R[2][1] = mul(2.0f, add(mul(c, d), mul(a, b)));
  R[2][2] = add(sub(sub(aa, bb), cc), dd);
}

// umeyama.kabsch_rotation of N <= 8 weighted points (_cross_cov unrolled)
template <int N>
__device__ void kabsch_small(const float (&src)[N][3], const float (&tgt)[N][3],
                             const float (&w)[N], float (&R)[3][3]) {
  const float wsum = clamp_min(tsum<N>(w), 1e-9f);
  float ms[3], mt[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float xs[N], xt[N];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      xs[p] = mul(src[p][c], w[p]);
      xt[p] = mul(tgt[p][c], w[p]);
    }
    ms[c] = dvd(rsum<N>(xs), wsum);
    mt[c] = dvd(rsum<N>(xt), wsum);
  }
  float sc[N][3], tc[N][3];
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sc[p][c] = mul(sub(src[p][c], ms[c]), w[p]);
      tc[p][c] = sub(tgt[p][c], mt[c]);
    }
  }
  float M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float m = mul(tc[0][i], sc[0][j]);
#pragma unroll
      for (int p = 1; p < N; ++p) m = add(m, mul(tc[p][i], sc[p][j]));
      M[i][j] = m;
    }
  }
  horn(M, R);
}

// the refit of part 0 or 1 with the joint axis rotated by the other's
// rotation appended as a fourth correspondence of weight 3 (the smaller
// weight sum of the two samples): alternating_joint_rotations' aug_fit
__device__ void aug_fit(const float (&x)[3][3], const float (&y)[3][3],
                        const float* axis, const float (&Rother)[3][3],
                        int order, float (&R)[3][3]) {
  float xs[4][3], ys[4][3];
  const float w[4] = {1.0f, 1.0f, 1.0f, 3.0f};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xs[p][c] = x[p][c];
      ys[p][c] = y[p][c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xs[3][c] = axis[c];
    ys[3][c] = dot3(axis, Rother[c], order);  // (a @ R^T)[c]
  }
  kabsch_small<4>(xs, ys, w, R);
}

// mean of three rows: _wmean1 with unit weights
__device__ __forceinline__ float mean3(float a, float b, float c) {
  const float v[3] = {a, b, c};
  return dvd(rsum<3>(v), 3.0f);
}

// The fit of one hypothesis from its samples: S*, T* (3 points each) ->
// fit (R0 s0 t0 R1 s1 t1).
__device__ void hypothesis(const float (&S0)[3][3], const float (&T0)[3][3],
                           const float (&S1)[3][3], const float (&T1)[3][3],
                           const float* axis, bool prismatic, int order,
                           float (&fit)[kFit]) {
  float s0, s0i, s1, s1i;
  scales3(S0, T0, s0, s0i);
  scales3(S1, T1, s1, s1i);
  // _prepare's centred buffers (unit weights)
  float x0[3][3], y0[3][3], x1[3][3], y1[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ty0[3] = {mul(T0[0][c], s0i), mul(T0[1][c], s0i),
                          mul(T0[2][c], s0i)};
    const float ty1[3] = {mul(T1[0][c], s1i), mul(T1[1][c], s1i),
                          mul(T1[2][c], s1i)};
    const float mx0 = mean3(S0[0][c], S0[1][c], S0[2][c]);
    const float my0 = mean3(ty0[0], ty0[1], ty0[2]);
    const float mx1 = mean3(S1[0][c], S1[1][c], S1[2][c]);
    const float my1 = mean3(ty1[0], ty1[1], ty1[2]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      x0[p][c] = sub(S0[p][c], mx0);
      y0[p][c] = sub(ty0[p], my0);
      x1[p][c] = sub(S1[p][c], mx1);
      y1[p][c] = sub(ty1[p], my1);
    }
  }
  float R0[3][3], R1[3][3];
  if (prismatic) {
    // one Kabsch over the union
    float xs[6][3], ys[6][3];
    const float w[6] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xs[p][c] = x0[p][c];
        ys[p][c] = y0[p][c];
        xs[p + 3][c] = x1[p][c];
        ys[p + 3][c] = y1[p][c];
      }
    }
    kabsch_small<6>(xs, ys, w, R0);
#pragma unroll
    for (int i = 0; i < 9; ++i) R1[i / 3][i % 3] = R0[i / 3][i % 3];
  } else {
    const float w[3] = {1.0f, 1.0f, 1.0f};
    kabsch_small<3>(x0, y0, w, R0);
    kabsch_small<3>(x1, y1, w, R1);
#pragma unroll 1
    for (int sweep = 0; sweep < 3; ++sweep) {
      aug_fit(x0, y0, axis, R1, order, R0);
      aug_fit(x1, y1, axis, R0, order, R1);
    }
  }
  // _translations on the raw samples
  float ms0[3], mt0[3], ms1[3], mt1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ms0[c] = mean3(S0[0][c], S0[1][c], S0[2][c]);
    mt0[c] = mean3(T0[0][c], T0[1][c], T0[2][c]);
    ms1[c] = mean3(S1[0][c], S1[1][c], S1[2][c]);
    mt1[c] = mean3(T1[0][c], T1[1][c], T1[2][c]);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    fit[i] = R0[i / 3][i % 3];
    fit[13 + i] = R1[i / 3][i % 3];
  }
  fit[9] = s0;
  fit[22] = s1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fit[10 + c] = sub(mt0[c], mul(s0, dot3(R0[c], ms0, order)));
    fit[23 + c] = sub(mt1[c], mul(s1, dot3(R1[c], ms1, order)));
  }
}

// hypothesis_inlier_counts' row of one part's (R, s, t): s R (9), s R^T t,
// t, s^2, then |t|^2
__device__ void score_row(const float* R, float s, const float* t,
                          float* row) {
#pragma unroll
  for (int i = 0; i < 9; ++i) row[i] = mul(s, R[i]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float v[3] = {mul(R[j], t[0]), mul(R[3 + j], t[1]),
                        mul(R[6 + j], t[2])};
    row[9 + j] = mul(s, rsum<3>(v));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) row[12 + j] = t[j];
  row[15] = mul(s, s);
  row[16] = sqnorm3(t);
}

// ---- the refit (lm.py), in torch's order too -------------------------------
//
// The refit's cost test (`cost(p_new) < base`) is a vote as well: where the
// Gauss-Newton steps are still ~1e-4 after lm_iters, a cost that rounds
// otherwise keeps or drops a step of that size.  So the refit repeats the
// plain path's reductions as torch launches them at the plain call's batch
// (one joint of B frames a call), not only its elementwise rounding.

// torch's block of a reduction over dim0 x dim1 (Reduce.cuh,
// set_block_dimension, at 512 threads)
__device__ void block_dims(int dim0, int dim1, int& bw, int& bh) {
  const int d0 = dim0 < 512 ? last_pow2(dim0) : 512;
  const int d1 = dim1 < 512 ? last_pow2(dim1) : 512;
  bw = min(d0, 32);
  bh = min(d1, 512 / bw);
  bw = min(d0, 512 / bh);
}

// torch's sum of one row f(0), ..., f(n - 1) of a contiguous (nout, n)
// tensor whose row starts `off` elements past a 16-byte boundary: from
// n = 128 the loads are float4 (the row's unaligned head first); each of
// torch's lanes (up to 512 at a small nout) takes values (or float4s) l,
// l + lanes, ... into four accumulators, and where each would take many
// values the block's warps split the row as well; then the lanes' tree
// (shared memory, then shuffles) and the warps' tree.  Run by a whole
// warp, a lane standing for lanes l, l + 32, ...; every lane returns the
// sum.  (torch splits a row across blocks from 256 values a thread, at
// two frames or fewer of an all-pairs scale: that sum comes out in this
// order all the same.)
template <class F>
__device__ float warp_fast_sum(int n, int off, int nout, F f) {
  const int lane = threadIdx.x & 31;
  const bool vec = n >= 128;
  int bw, bh;
  block_dims(vec ? n / 4 : n, nout, bw, bh);
  int step = bw;
  const bool ysplit = (n + step - 1) / step >= min(bh * 16, 256);
  const int ymult = ysplit ? bw : 0;
  const int nys = ysplit ? bh : 1;  // at most 16: a split row is float4s
  if (ysplit) step *= bh;
  const int nv = (bw + 31) / 32;    // torch's lanes a lane stands for
  float ys[16];
  for (int y = 0; y < nys; ++y) {
    float v[16];
    for (int k = 0; k < nv; ++k) {
      const int L = lane + 32 * k;
      v[k] = 0.0f;
      if (L >= bw) continue;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (vec) {
        const int shift = off & 3;
        int base = 0, end = n;
        if (shift > 0) {
          if (L >= shift && L < 4 && y == 0) acc[0] = add(acc[0], f(L - shift));
          base = 4 - shift;
          end = n - base;
        }
        for (int idx = L + y * ymult; idx * 4 + 3 < end; idx += step) {
          for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], f(base + 4 * idx + i));
        }
        const int tail = end - end % 4 + L;
        if (y == 0 && tail < end) acc[0] = add(acc[0], f(base + tail));
      } else {
        int m = 0;
        for (int idx = L + y * ymult; idx < n; idx += step, ++m) {
          acc[m & 3] = add(acc[m & 3], f(idx));
        }
      }
      v[k] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
    }
    for (int o = bw / 2; o >= 32; o >>= 1) {
      for (int k = 0; k < o / 32; ++k) v[k] = add(v[k], v[k + o / 32]);
    }
    for (int o = min(bw, 32) / 2; o > 0; o >>= 1) {
      v[0] = add(v[0], __shfl_down_sync(0xffffffffu, v[0], o));
    }
    ys[y] = v[0];
  }
  for (int o = nys / 2; o > 0; o >>= 1) {
    for (int l = 0; l < o; ++l) ys[l] = add(ys[l], ys[l + o]);
  }
  return __shfl_sync(0xffffffffu, ys[0], 0);
}

// torch's sums over the rows of S (batch, rows, 3) tensors, the row p of
// sum s being f(s, p, v): one output of nout = 3 batch a thread, its rows
// split across the block's warps where they are many (step bh), four
// accumulators a thread, then the warps' tree.  Run by the block; `part`
// holds S * 3 * 256 floats; out[3 s + c] gets sum s's component c.
template <class F>
__device__ void rows_sums(int S, int rows, int nout, F f, float* part,
                          float* out) {
  int bw, bh;
  block_dims(nout, rows, bw, bh);
  const bool ysplit = rows >= min(bh * 16, 256);
  const int step = ysplit ? bh : 1, nys = ysplit ? bh : 1;
  for (int task = threadIdx.x; task < S * 3 * nys; task += kThreads) {
    const int s = task / (3 * nys), c = (task / nys) % 3, y = task % nys;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = 0;
    for (int r = y; r < rows; r += step, ++m) {
      float v[3];
      f(s, r, v);
      acc[m & 3] = add(acc[m & 3], v[c]);
    }
    part[task] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  __syncthreads();
  if (threadIdx.x < S * 3) {
    float* ys = part + threadIdx.x * nys;
    for (int o = nys / 2; o > 0; o >>= 1) {
      for (int l = 0; l < o; ++l) ys[l] = add(ys[l], ys[l + o]);
    }
    out[threadIdx.x] = ys[0];
  }
  __syncthreads();
}

// 3x3 products of the refit (cuBLAS's fma chain): A B and A^T B
__device__ void mm3(const float (&A)[3][3], const float (&B)[3][3],
                    float (&C)[3][3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      C[i][j] = fma_rn(A[i][2], B[2][j],
                       fma_rn(A[i][1], B[1][j], mul(A[i][0], B[0][j])));
    }
  }
}

__device__ void mtm3(const float (&A)[3][3], const float (&B)[3][3],
                     float (&C)[3][3]) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      C[i][j] = fma_rn(A[2][i], B[2][j],
                       fma_rn(A[1][i], B[1][j], mul(A[0][i], B[0][j])));
    }
  }
}

// A v and A^T v at the products' orders
__device__ void mv3(const float (&A)[3][3], const float* v, int order,
                    float* o) {
  for (int i = 0; i < 3; ++i) o[i] = dot3(A[i], v, order);
}

__device__ void mtv3(const float (&A)[3][3], const float* v, int order,
                     float* o) {
  for (int i = 0; i < 3; ++i) {
    const float col[3] = {A[0][i], A[1][i], A[2][i]};
    o[i] = dot3(col, v, order);
  }
}

// lm._skew (a zeros_like for the diagonal)
__device__ void skew(const float* v, float (&K)[3][3]) {
  K[0][0] = 0.0f;  K[0][1] = -v[2]; K[0][2] = v[1];
  K[1][0] = v[2];  K[1][1] = 0.0f;  K[1][2] = -v[0];
  K[2][0] = -v[1]; K[2][1] = v[0];  K[2][2] = 0.0f;
}

// lm._theta_axis: theta = sqrt(|v|^2 + 1e-12), the unit axis
__device__ float theta_axis(const float* v, float* k) {
  const float th = sqrt_rn(add(sqnorm3(v), 1e-12f));
  for (int c = 0; c < 3; ++c) k[c] = dvd(v[c], th);
  return th;
}

// I + sin(th) K + (1 - cos(th)) K K  (rotvec_to_matrix), and
// I - (1 - cos)/th K + (th - sin)/th K K  (_right_jacobian)
__device__ void rodrigues_matrix(const float* v, bool jacobian,
                                 float (&R)[3][3]) {
  float k[3], K[3][3], KK[3][3];
  const float th = theta_axis(v, k);
  skew(k, K);
  mm3(K, K, KK);
  const float s = sinf(th), c = cosf(th);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      R[i][j] = jacobian
          ? add(sub(e, mul(dvd(sub(1.0f, c), th), K[i][j])),
                mul(dvd(sub(th, s), th), KK[i][j]))
          : add(add(e, mul(s, K[i][j])), mul(sub(1.0f, c), KK[i][j]));
    }
  }
}

// lm.matrix_to_rotvec
__device__ void matrix_to_rotvec(const float (&R)[3][3], float* v) {
  const float tr = add(add(R[0][0], R[1][1]), R[2][2]);
  float c = mul(sub(tr, 1.0f), 0.5f);
  c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
  const float th = acosf(c);
  const float raw[3] = {sub(R[2][1], R[1][2]), sub(R[0][2], R[2][0]),
                        sub(R[1][0], R[0][1])};
  const float s2 = mul(2.0f, sqrt_rn(clamp_min(sub(1.0f, mul(c, c)), 1e-12f)));
  float diag[3];
  int dom = 0;
  for (int i = 0; i < 3; ++i) {
    diag[i] = sqrt_rn(clamp_min(mul(add(R[i][i], 1.0f), 0.5f), 0.0f));
    if (diag[i] > diag[dom]) dom = i;
  }
  float alt[3];
  for (int i = 0; i < 3; ++i) {
    const float r = add(raw[i], 1e-30f);
    const float sg = r > 0.0f ? 1.0f : (r < 0.0f ? -1.0f : r);
    alt[i] = i == dom ? diag[i] : mul(diag[i], sg);
  }
  const float n = clamp_min(sqrt_rn(sqnorm3(alt)), 1e-12f);
  const bool use_alt = th > 3.140592653589793f;  // pi - 1e-3
  for (int i = 0; i < 3; ++i) {
    v[i] = mul(use_alt ? dvd(alt[i], n) : dvd(raw[i], s2), th);
  }
}

// lm.rotvec_rotate of p by (unit axis k, cos c, sin s)
__device__ void rotate(const float* p, const float* k, float c, float s,
                       float* o) {
  const float dot = sum3(mul(p[0], k[0]), mul(p[1], k[1]), mul(p[2], k[2]));
  const float cr[3] = {sub(mul(k[1], p[2]), mul(k[2], p[1])),
                       sub(mul(k[2], p[0]), mul(k[0], p[2])),
                       sub(mul(k[0], p[1]), mul(k[1], p[0]))};
  const float cd = mul(sub(1.0f, c), dot);
  for (int i = 0; i < 3; ++i) {
    o[i] = add(add(mul(c, p[i]), mul(s, cr[i])), mul(cd, k[i]));
  }
}

// torch.linalg.solve_ex of a 6x6 system as the card runs it (MAGMA's
// batched LU: partial pivoting, the column scaled by the pivot's
// reciprocal, fma updates; then the two triangular solves, the upper one
// column by column with a division).  Unchecked: a singular system gives
// inf or NaN, which the cost test rejects.
__device__ void solve6(float (&A)[6][6], float (&b)[6]) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > fabsf(A[piv][c])) piv = r;
    }
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        const float t = A[c][k];
        A[c][k] = A[piv][k];
        A[piv][k] = t;
      }
      const float t = b[c];
      b[c] = b[piv];
      b[piv] = t;
    }
    const float rcp = dvd(1.0f, A[c][c]);
    for (int r = c + 1; r < 6; ++r) A[r][c] = mul(A[r][c], rcp);
    for (int r = c + 1; r < 6; ++r) {
      for (int k = c + 1; k < 6; ++k) {
        A[r][k] = fma_rn(-A[r][c], A[c][k], A[r][k]);
      }
    }
  }
  for (int i = 1; i < 6; ++i) {
    for (int k = 0; k < i; ++k) b[i] = fma_rn(-A[i][k], b[k], b[i]);
  }
  for (int k = 5; k >= 0; --k) {
    b[k] = dvd(b[k], A[k][k]);
    for (int i = 0; i < k; ++i) b[i] = fma_rn(-A[i][k], b[k], b[i]);
  }
}

// Sums v over the block into out (every thread reads out after the call);
// for counts and other sums that come out exact in any order.
template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// One part of the refit: its rows, inlier weights and what _prepare makes
// of them.
struct RefitPart {
  const float* src;
  const float* tgt;
  const uint8_t* w;
  float wsum, scale, scale_inv;
  float mu[3];   // _wmean1 of the sources
  float mut[3];  // _wmean1 of the targets
  float muy[3];  // _wmean1 of the scaled targets
  float kms[3];  // kabsch_rotation's means (clamp 1e-9)
  float kmt[3];

  __device__ float wt(int p) const { return w[p] ? 1.0f : 0.0f; }
  // the centred, masked buffers of row p: x = (src - mu) w,
  // y = (tgt scale_inv - muy) w
  __device__ void x(int p, float* o) const {
    const float m = wt(p);
    for (int c = 0; c < 3; ++c) o[c] = mul(sub(src[3 * p + c], mu[c]), m);
  }
  __device__ void y(int p, float* o) const {
    const float m = wt(p);
    for (int c = 0; c < 3; ++c) {
      o[c] = mul(sub(mul(tgt[3 * p + c], scale_inv), muy[c]), m);
    }
  }
};

// The hypotheses' state, then the refit's: one problem's shared memory.
struct Shared {
  union {
    struct {
      float rows[kChunk][2 * kRow];
      float fits[kChunk][kFit];
    } h;
    float part[6 * 3 * 256];  // rows_sums' partial sums
  } u;
  int counts[2][kChunk];
  float best_fit[kFit];
  float red[kWarps * 8];
  float out[64];
  RefitPart rp[2];
  float Rm[2][3][3];   // the current rotations
  float trial[2][5];   // the trial's (unit axis, cos, sin)
  float rj_trial[3];
  float best_score;
  int best;
  int cnt[2];
  float msum[2];
};

__device__ void load3(const float* p, float* v) {
  v[0] = __ldg(p);
  v[1] = __ldg(p + 1);
  v[2] = __ldg(p + 2);
}

__global__ void __launch_bounds__(kThreads)
joint_fit_kernel(const Args a) {
  __shared__ Shared sh;
  const int joints = a.parts - 1;
  const int problem = blockIdx.x;
  const int b = problem / joints, j = problem - b * joints;
  const bool prismatic = (a.prismatic >> j) & 1u;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t part0 = static_cast<size_t>(b) * a.parts;
  const size_t part1 = part0 + j + 1;
  const float* src[2] = {a.src + part0 * a.cap * 3, a.src + part1 * a.cap * 3};
  const float* tgt[2] = {a.tgt + part0 * a.cap * 3, a.tgt + part1 * a.cap * 3};
  const float* msk[2] = {a.mask + part0 * a.cap, a.mask + part1 * a.cap};
  float axis[3];
  load3(a.axes + static_cast<size_t>(problem) * 3, axis);
  const int H = a.hyps, S = a.score_points, cap = a.cap;
  const int cap32 = (cap + 31) & ~31;
  const int S32 = (S + 31) & ~31;

  // the parts' point counts (all rows) and mask sums (score prefix)
  {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = tid; p < cap; p += kThreads) {
      const float m0 = msk[0][p], m1 = msk[1][p];
      v[0] += m0 > 0.0f ? 1.0f : 0.0f;
      v[1] += m1 > 0.0f ? 1.0f : 0.0f;
      if (p < S) {
        v[2] += m0;
        v[3] += m1;
      }
    }
    block_sum<4>(v, sh.red, sh.out);
    if (tid == 0) {
      sh.cnt[0] = static_cast<int>(sh.out[0]);
      sh.cnt[1] = static_cast<int>(sh.out[1]);
      sh.msum[0] = sh.out[2];
      sh.msum[1] = sh.out[3];
      sh.best = 0;
      sh.best_score = -CUDART_INF_F;
    }
    __syncthreads();
  }

  // ---- hypotheses and their scores, kChunk at a time ----
  for (int h0 = 0; h0 < H; h0 += kChunk) {
    const int nh = min(kChunk, H - h0);
    if (tid < nh) {
      const int h = h0 + tid;
      float Sm[2][3][3], Tm[2][3][3];
      for (int part = 0; part < 2; ++part) {
        const float* u = a.draws +
            ((static_cast<size_t>(problem) * 2 + part) * H + h) * 3;
        const int cnt = max(sh.cnt[part], 1);
        for (int k = 0; k < 3; ++k) {
          const int i = min(__float2int_rz(mul(__ldg(u + k),
                                               static_cast<float>(cnt))),
                            cnt - 1);
          load3(src[part] + 3 * i, Sm[part][k]);
          load3(tgt[part] + 3 * i, Tm[part][k]);
        }
      }
      float fit[kFit];
      hypothesis(Sm[0], Tm[0], Sm[1], Tm[1], axis, prismatic, a.order_hyp,
                 fit);
      for (int k = 0; k < kFit; ++k) sh.u.h.fits[tid][k] = fit[k];
      score_row(fit, fit[9], fit + 10, sh.u.h.rows[tid]);
      score_row(fit + 13, fit[22], fit + 23, sh.u.h.rows[tid] + kRow);
      if (a.hyp != nullptr) {
        float* o = a.hyp + (static_cast<size_t>(problem) * H + h) * kFit;
        for (int k = 0; k < kFit; ++k) o[k] = fit[k];
      }
    }
    for (int k = tid; k < 2 * kChunk; k += kThreads) {
      sh.counts[k / kChunk][k % kChunk] = 0;
    }
    __syncthreads();

    // inlier counts: a thread a point, a ballot a hypothesis
    for (int part = 0; part < 2; ++part) {
      for (int p = tid; p < S32; p += kThreads) {
        float bm[16], col = 0.0f;
        bool valid = false;
        if (p < S) {
          float s[3], t[3];
          load3(src[part] + 3 * p, s);
          load3(tgt[part] + 3 * p, t);
          valid = msk[part][p] > 0.0f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int k = 0; k < 3; ++k) bm[3 * i + k] = mul(-2.0f, mul(t[i], s[k]));
            bm[9 + i] = mul(2.0f, s[i]);
            bm[12 + i] = mul(-2.0f, t[i]);
          }
          bm[15] = sqnorm3(s);
          col = sqnorm3(t);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) bm[k] = 0.0f;
        }
        for (int hh = 0; hh < nh; ++hh) {
          const float* A = sh.u.h.rows[hh] + part * kRow;
          const float res2 = add(add(gemm_dot<16>(A, bm), A[16]), col);
          const unsigned bal = __ballot_sync(0xffffffffu,
                                             valid && res2 < a.inlier_th2);
          if (lane == 0 && bal) atomicAdd(&sh.counts[part][hh], __popc(bal));
        }
      }
    }
    __syncthreads();

    // scores, and the first maximum
    if (tid < nh) {
      const float f0 = dvd(static_cast<float>(sh.counts[0][tid]),
                           clamp_min(sh.msum[0], 1.0f));
      const float f1 = dvd(static_cast<float>(sh.counts[1][tid]),
                           clamp_min(sh.msum[1], 1.0f));
      const float score = dvd(add(f0, f1), 2.0f);
      sh.u.h.rows[tid][0] = score;  // the rows are read no more
      a.scores[static_cast<size_t>(problem) * H + h0 + tid] = score;
    }
    __syncthreads();
    if (tid == 0) {
      int bi = -1;
      float bs = sh.best_score;
      for (int hh = 0; hh < nh; ++hh) {
        if (sh.u.h.rows[hh][0] > bs) {
          bs = sh.u.h.rows[hh][0];
          bi = hh;
        }
      }
      if (bi >= 0) {
        sh.best_score = bs;
        sh.best = h0 + bi;
        for (int k = 0; k < kFit; ++k) sh.best_fit[k] = sh.u.h.fits[bi][k];
      }
    }
    __syncthreads();
  }
  if (tid == 0) a.best[problem] = sh.best;

  // ---- the best hypothesis's inlier sets over all rows ----
  uint8_t* inl = a.inliers + static_cast<size_t>(problem) * 2 * cap;
  for (int part = 0; part < 2; ++part) {
    const float* R = sh.best_fit + 13 * part;
    const float s = R[9];
    const float* t = R + 10;
    float nin = 0.0f;
    for (int p = tid; p < cap32; p += kThreads) {
      bool in = false;
      if (p < cap) {
        float x[3], y[3];
        load3(src[part] + 3 * p, x);
        load3(tgt[part] + 3 * p, y);
        float d[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          // (source @ R^T)[c]
          d[c] = sub(y[c], add(mul(s, gemm_dot<3>(x, R + 3 * c)), t[c]));
        }
        const float res = sqrt_rn(sqnorm3(d));
        in = res < a.inlier_th && msk[part][p] > 0.0f;
        inl[part * cap + p] = in ? 1 : 0;
      }
      nin += __popc(__ballot_sync(0xffffffffu, in)) * (lane == 0 ? 1.0f : 0.0f);
    }
    float v[1] = {nin};
    block_sum<1>(v, sh.red, sh.out);
    if (sh.out[0] < 3.0f) {  // too few: the part's mask
      for (int p = tid; p < cap; p += kThreads) {
        inl[part * cap + p] = msk[part][p] > 0.0f ? 1 : 0;
      }
    }
    __syncthreads();
  }

  // ---- the refit on the first refit_points rows, in torch's order ----
  const int Pr = a.refit_points, B = a.batch;
  float* work = a.work + static_cast<size_t>(problem) * (12 * Pr + 4);
  if (tid < 2) {
    RefitPart& q = sh.rp[tid];
    q.src = src[tid];
    q.tgt = tgt[tid];
    q.w = inl + tid * cap;
  }
  {
    float v[2] = {0.0f, 0.0f};
    for (int p = tid; p < Pr; p += kThreads) {
      v[0] += inl[p] ? 1.0f : 0.0f;
      v[1] += inl[cap + p] ? 1.0f : 0.0f;
    }
    block_sum<2>(v, sh.red, sh.out);  // counts: exact
    if (tid < 2) sh.rp[tid].wsum = sh.out[tid];
    __syncthreads();
  }
  const RefitPart* rp = sh.rp;
  // umeyama.pairwise_scale_both: (A, B, C) of each part, a warp a sum
  const int warp = tid >> 5;
  auto pair_term = [&](int q, int which, int p, int r) {
    const RefitPart& Q = rp[q];
    const float ww = mul(Q.wt(p), Q.wt(r));
    if (which == 0) {
      const float d = pair_norm(Q.src + 3 * p, Q.src + 3 * r);
      return mul(mul(ww, d), d);
    }
    const float e = pair_norm(Q.tgt + 3 * p, Q.tgt + 3 * r);
    if (which == 1) return mul(mul(ww, e), e);
    return mul(mul(ww, pair_norm(Q.src + 3 * p, Q.src + 3 * r)), e);
  };
  if (Pr <= 256) {  // all pairs
    if (warp < 6) {
      const int q = warp / 3, which = warp % 3;
      const int n = Pr * Pr;
      const float s = warp_fast_sum(
          n, static_cast<int>((static_cast<long long>(b) * n) & 3), B,
          [&](int i) { return pair_term(q, which, i / Pr, i % Pr); });
      if (lane == 0) sh.out[warp] = s;
    }
    __syncthreads();
  } else {  // 16 cyclic strides spread over [1, Pr)
    for (int i = 1; i <= 16; ++i) {
      const int k = max(1, (i * Pr) / 33);
      for (int e = tid; e < 2 * Pr; e += kThreads) {
        const int q = e / Pr, p = e - q * Pr, r = p - k < 0 ? p - k + Pr : p - k;
        const RefitPart& Q = rp[q];
        const float ww = mul(Q.wt(p), Q.wt(r));
        const float d = pair_norm(Q.src + 3 * p, Q.src + 3 * r);
        const float f = pair_norm(Q.tgt + 3 * p, Q.tgt + 3 * r);
        float* v = work + 3 * q * Pr + p;
        v[0] = mul(mul(ww, d), d);
        v[Pr] = mul(mul(ww, f), f);
        v[2 * Pr] = mul(mul(ww, d), f);
      }
      __syncthreads();
      if (warp < 6) {
        const float* v = work + warp * Pr;
        const float s = warp_fast_sum(
            Pr, static_cast<int>((static_cast<long long>(b) * Pr) & 3), B,
            [&](int p) { return v[p]; });
        if (lane == 0) sh.out[warp] = i == 1 ? s : add(sh.out[warp], s);
      }
      __syncthreads();
    }
  }
  if (tid < 2) {
    RefitPart& Q = sh.rp[tid];
    const float* o = sh.out + 3 * tid;
    Q.scale = dvd(o[2], add(o[0], 1e-6f));
    Q.scale_inv = dvd(o[2], add(o[1], 1e-6f));
  }
  __syncthreads();
  // the weighted sums of the sources, targets and scaled targets
  rows_sums(6, Pr, 3 * B, [&](int s, int p, float* v) {
    const RefitPart& Q = rp[s / 3];
    const float m = Q.wt(p);
    for (int c = 0; c < 3; ++c) {
      const float x = s % 3 == 0 ? Q.src[3 * p + c] : s % 3 == 1
          ? Q.tgt[3 * p + c] : mul(Q.tgt[3 * p + c], Q.scale_inv);
      v[c] = mul(x, m);
    }
  }, sh.u.part, sh.out);
  if (tid < 2) {
    RefitPart& Q = sh.rp[tid];
    const float* o = sh.out + 9 * tid;
    const float d1 = clamp_min(Q.wsum, 1.0f), d9 = clamp_min(Q.wsum, 1e-9f);
    for (int c = 0; c < 3; ++c) {
      Q.mu[c] = dvd(o[c], d1);
      Q.mut[c] = dvd(o[3 + c], d1);
      Q.muy[c] = dvd(o[6 + c], d1);
      Q.kms[c] = dvd(o[c], d9);
      Q.kmt[c] = dvd(o[3 + c], d9);
    }
  }
  __syncthreads();
  // Kabsch's cross-covariances tc^T sc and the LM's moments
  // (x m^2)^T x, cuBLAS's fma chains over the rows
  if (tid < 36) {
    const int q = tid / 18, kind = (tid / 9) % 2, i = (tid % 9) / 3,
              k = tid % 3;
    const RefitPart& Q = rp[q];
    float acc = 0.0f;
    for (int p = 0; p < Pr; ++p) {
      const float m = Q.wt(p);
      float l, r;
      if (kind == 0) {
        l = sub(Q.tgt[3 * p + i], Q.kmt[i]);
        r = mul(sub(Q.src[3 * p + k], Q.kms[k]), m);
      } else {
        l = mul(mul(sub(Q.src[3 * p + i], Q.mu[i]), m), mul(m, m));
        r = mul(sub(Q.src[3 * p + k], Q.mu[k]), m);
      }
      // _cross_cov sums at most 8 rows unrolled, with separate adds
      acc = p == 0 ? mul(l, r)
          : (kind == 0 && Pr <= 8) ? add(acc, mul(l, r)) : fma_rn(l, r, acc);
    }
    sh.out[tid] = acc;
  }
  __syncthreads();
  // thread 0 runs the steps' small algebra (lm.lm_refine_joint)
  float p6[6], lam = 1e-3f, M0[3][3], M1[3][3], Ka[3][3], mult = 0.0f,
        sqm = 0.0f, base = 0.0f;
  if (tid == 0) {
    for (int q = 0; q < 2; ++q) {
      float M[3][3], R[3][3];
      for (int i = 0; i < 9; ++i) M[i / 3][i % 3] = sh.out[18 * q + i];
      horn(M, R);
      matrix_to_rotvec(R, p6 + 3 * q);
    }
    mult = fminf(rp[0].wsum, rp[1].wsum);  // counts
    sqm = sqrt_rn(mult);
    const float aa = sqnorm3(axis);
    for (int q = 0; q < 2; ++q) {
      const float* xx = sh.out + 18 * q + 9;
      const float tr = sum3(xx[0], xx[4], xx[8]);
      float (&M)[3][3] = q == 0 ? M0 : M1;
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 3; ++k) {
          const float e = i == k ? 1.0f : 0.0f;
          const float Ma = mul(mult, sub(mul(aa, e), mul(axis[i], axis[k])));
          M[i][k] = add(sub(mul(tr, e), xx[3 * i + k]),
                        mul(prismatic ? 0.0f : 1.0f, Ma));
        }
      }
    }
    skew(axis, Ka);
  }
  for (int it = 0; it < a.lm_iters; ++it) {
    if (tid == 0) {
      for (int q = 0; q < 2; ++q) rodrigues_matrix(p6 + 3 * q, false, sh.Rm[q]);
    }
    __syncthreads();
    // e = y - x R^T, c = sum cross(x, e R) m^2 (rows), and the cost's
    // sum e^2 m^2
    auto residual = [&](int q, int p, float* e, float* x) {
      float y[3];
      rp[q].x(p, x);
      rp[q].y(p, y);
      const float(&R)[3][3] = sh.Rm[q];
      for (int c = 0; c < 3; ++c) {
        e[c] = sub(y[c], fma_rn(x[2], R[c][2],
                                fma_rn(x[1], R[c][1], mul(x[0], R[c][0]))));
      }
    };
    for (int n = tid; n < 2 * Pr; n += kThreads) {
      const int q = n / Pr, p = n - q * Pr;
      float e[3], x[3], eR[3];
      residual(q, p, e, x);
      const float(&R)[3][3] = sh.Rm[q];
      for (int c = 0; c < 3; ++c) {
        eR[c] = fma_rn(e[2], R[2][c], fma_rn(e[1], R[1][c], mul(e[0], R[0][c])));
      }
      const float m = rp[q].wt(p), m2 = mul(m, m);
      float* v = work + 3 * n;
      v[0] = mul(sub(mul(x[1], eR[2]), mul(x[2], eR[1])), m2);
      v[1] = mul(sub(mul(x[2], eR[0]), mul(x[0], eR[2])), m2);
      v[2] = mul(sub(mul(x[0], eR[1]), mul(x[1], eR[0])), m2);
      for (int c = 0; c < 3; ++c) v[6 * Pr + c] = mul(mul(e[c], e[c]), m2);
    }
    __syncthreads();
    rows_sums(2, Pr, 3 * B, [&](int q, int p, float* v) {
      for (int c = 0; c < 3; ++c) v[c] = work[3 * (q * Pr + p) + c];
    }, sh.u.part, sh.out);
    if (warp < 2) {
      const float* v = work + 6 * Pr + 3 * warp * Pr;
      const float s = warp_fast_sum(
          3 * Pr, static_cast<int>((static_cast<long long>(b) * 3 * Pr) & 3), B,
          [&](int i) { return v[i]; });
      if (lane == 0) sh.out[6 + warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float J0[3][3], J1[3][3], T[3][3], H00[3][3], H11[3][3], H01[3][3];
      float g[6], rj[3], t0[3], t1[3], r0a[3], r1a[3];
      const float(&R0)[3][3] = sh.Rm[0];
      const float(&R1)[3][3] = sh.Rm[1];
      rodrigues_matrix(p6, true, J0);
      rodrigues_matrix(p6 + 3, true, J1);
      mtm3(J0, M0, T);
      mm3(T, J0, H00);
      mtm3(J1, M1, T);
      mm3(T, J1, H11);
      mtv3(J0, sh.out, a.order_mvt, t0);
      mtv3(J1, sh.out + 3, a.order_mvt, t1);
      if (prismatic) {
        for (int i = 0; i < 3; ++i) {
          for (int k = 0; k < 3; ++k) {
            const float e = i == k ? 1.0f : 0.0f;
            H00[i][k] = add(H00[i][k], mul(mult, e));
            H11[i][k] = add(H11[i][k], mul(mult, e));
            H01[i][k] = mul(-mult, e);
          }
          rj[i] = mul(sub(p6[i], p6[3 + i]), sqm);
        }
        for (int i = 0; i < 3; ++i) {
          g[i] = add(-t0[i], mul(sqm, rj[i]));
          g[3 + i] = sub(-t1[i], mul(sqm, rj[i]));
        }
      } else {
        float nR[3][3], D0[3][3], D1[3][3], X[3][3], d0[3], d1[3];
        for (int i = 0; i < 9; ++i) nR[i / 3][i % 3] = -R0[i / 3][i % 3];
        mm3(nR, Ka, T);
        mm3(T, J0, D0);
        for (int i = 0; i < 9; ++i) nR[i / 3][i % 3] = -R1[i / 3][i % 3];
        mm3(nR, Ka, T);
        mm3(T, J1, D1);
        mtm3(D0, D1, X);
        for (int i = 0; i < 9; ++i) H01[i / 3][i % 3] = mul(-mult, X[i / 3][i % 3]);
        mv3(R0, axis, a.order_mv, r0a);
        mv3(R1, axis, a.order_mv, r1a);
        for (int i = 0; i < 3; ++i) rj[i] = mul(sub(r0a[i], r1a[i]), sqm);
        mtv3(D0, rj, a.order_mvt, d0);
        mtv3(D1, rj, a.order_mvt, d1);
        for (int i = 0; i < 3; ++i) {
          g[i] = add(-t0[i], mul(sqm, d0[i]));
          g[3 + i] = sub(-t1[i], mul(sqm, d1[i]));
        }
      }
      float Hd[6][6], dp[6];
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 3; ++k) {
          Hd[i][k] = H00[i][k];
          Hd[i][3 + k] = H01[i][k];
          Hd[3 + i][k] = H01[k][i];
          Hd[3 + i][3 + k] = H11[i][k];
        }
      }
      for (int i = 0; i < 6; ++i) {
        for (int k = 0; k < 6; ++k) {
          Hd[i][k] = add(Hd[i][k], mul(lam, i == k ? 1.0f : 0.0f));
        }
        dp[i] = -g[i];
      }
      solve6(Hd, dp);
      base = add(add(sh.out[6], sh.out[7]),
                 sum3(mul(rj[0], rj[0]), mul(rj[1], rj[1]), mul(rj[2], rj[2])));
      for (int i = 0; i < 6; ++i) dp[i] = add(p6[i], dp[i]);  // p_new
      for (int q = 0; q < 2; ++q) {
        float* t = sh.trial[q];
        const float th = theta_axis(dp + 3 * q, t);
        t[3] = cosf(th);
        t[4] = sinf(th);
      }
      if (prismatic) {
        for (int i = 0; i < 3; ++i) sh.rj_trial[i] = mul(sub(dp[i], dp[3 + i]), sqm);
      } else {
        rotate(axis, sh.trial[0], sh.trial[0][3], sh.trial[0][4], r0a);
        rotate(axis, sh.trial[1], sh.trial[1][3], sh.trial[1][4], r1a);
        for (int i = 0; i < 3; ++i) sh.rj_trial[i] = mul(sub(r0a[i], r1a[i]), sqm);
      }
      for (int i = 0; i < 6; ++i) sh.out[8 + i] = dp[i];
    }
    __syncthreads();
    // the trial's cost: the sum of r^2 over r = [r0, r1, rj], each part's
    // r = (y - rotvec_rotate(x, v_new)) m
    for (int n = tid; n < 2 * Pr; n += kThreads) {
      const int q = n / Pr, p = n - q * Pr;
      float x[3], y[3], o[3];
      rp[q].x(p, x);
      rp[q].y(p, y);
      const float* t = sh.trial[q];
      rotate(x, t, t[3], t[4], o);
      const float m = rp[q].wt(p);
      for (int c = 0; c < 3; ++c) {
        const float r = mul(sub(y[c], o[c]), m);
        work[3 * n + c] = mul(r, r);
      }
    }
    if (tid < 3) work[6 * Pr + tid] = mul(sh.rj_trial[tid], sh.rj_trial[tid]);
    __syncthreads();
    if (warp == 0) {
      const int n = 6 * Pr + 3;
      const float cost = warp_fast_sum(
          n, static_cast<int>((static_cast<long long>(b) * n) & 3), B,
          [&](int i) { return work[i]; });
      if (tid == 0) {
        const bool better = cost < base;
        if (better) {
          for (int i = 0; i < 6; ++i) p6[i] = sh.out[8 + i];
        }
        lam = better ? mul(lam, 0.33f) : mul(lam, 3.0f);
        lam = lam < 1e-8f ? 1e-8f : (lam > 1e6f ? 1e6f : lam);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    float* o = a.fit + static_cast<size_t>(problem) * kFit;
    for (int q = 0; q < 2; ++q) {
      float R[3][3], Rm[3];
      rodrigues_matrix(p6 + 3 * q, false, R);
      mv3(R, rp[q].mu, a.order_mv, Rm);
      float* f = o + 13 * q;
      for (int i = 0; i < 9; ++i) f[i] = R[i / 3][i % 3];
      f[9] = rp[q].scale;
      for (int c = 0; c < 3; ++c) f[10 + c] = sub(rp[q].mut[c], mul(rp[q].scale, Rm[c]));
    }
  }
}

// A v or A^T v over a batch, each entry by dot3 in `order`: the tiny
// products alone, for reading their orders against torch's
__global__ void dot3_kernel(const float* A, const float* v, float* out,
                            int n, int order, int transposed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float M[3][3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) M[r][c] = A[9 * i + 3 * r + c];
  }
  float o[3];
  if (transposed) {
    mtv3(M, v + 3 * i, order, o);
  } else {
    mv3(M, v + 3 * i, order, o);
  }
  for (int c = 0; c < 3; ++c) out[3 * i + c] = o[c];
}

}  // namespace

extern "C" {

// One launch for every joint of a batch: batch * (parts - 1) CTAs; the
// dot3 orders come from ops/kernels/joint_fit.py::dot_orders.
// Launches on `stream` and returns cudaGetLastError() (or the refusal's
// code).
int joint_fit_launch(const float* src, const float* tgt, const float* mask,
                     const float* axes, const float* draws, int batch,
                     int parts, int cap, int hyps, int score_points,
                     int refit_points, int lm_iters, unsigned prismatic,
                     float inlier_th, float inlier_th2, int order_hyp,
                     int order_mv, int order_mvt, float* work, float* fit,
                     int* best,
                     float* scores, uint8_t* inliers, float* hyp,
                     cudaStream_t stream) {
  if (batch < 1 || parts < 2 || parts > 33 || cap < 1 || hyps < 1 ||
      score_points < 1 || score_points > cap || refit_points < 1 ||
      refit_points > cap || lm_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(batch) * (parts - 1);
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Args a{};
  a.src = src;
  a.tgt = tgt;
  a.mask = mask;
  a.axes = axes;
  a.draws = draws;
  a.batch = batch;
  a.parts = parts;
  a.cap = cap;
  a.hyps = hyps;
  a.score_points = score_points;
  a.refit_points = refit_points;
  a.lm_iters = lm_iters;
  a.prismatic = prismatic;
  a.inlier_th = inlier_th;
  a.inlier_th2 = inlier_th2;
  a.order_hyp = order_hyp;
  a.order_mv = order_mv;
  a.order_mvt = order_mvt;
  a.work = work;
  a.fit = fit;
  a.best = best;
  a.scores = scores;
  a.inliers = inliers;
  a.hyp = hyp;
  joint_fit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dot3_kernel over n (A, v) pairs, (n, 3, 3) and (n, 3) -> (n, 3).
int joint_fit_dot3(const float* A, const float* v, float* out, int n,
                   int order, int transposed, cudaStream_t stream) {
  if (n < 1 || order < 0 || order > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dot3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      A, v, out, n, order, transposed);
  return static_cast<int>(cudaGetLastError());
}

const char* joint_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
