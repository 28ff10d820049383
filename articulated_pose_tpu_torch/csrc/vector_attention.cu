// The Point Transformer's vector attention after its q, k, v Linears:
// the `vector_attention` entry.
//
// It replaces no TPU kernel: the JAX package has no Point Transformer.
// models/point_transformer.py::PointTransformerLayer.plain writes every
// step of the layer to device memory as a (B, n, k, .) tensor (the
// gathers, theta, k_j - q_i + delta, gamma's norms and products, the
// softmax, the weighted terms): 444.5 MB a cloud at N = 8192 over its
// 18 layers.  Here one CTA takes a tile of queries of one level, all k
// neighbours of each, and writes only y (B, n, C) float32.
//
// For each query i and neighbour j (N(i) from the level's k-NN):
//   rel = p_j - p_i (f32); h = ReLU(BN(Linear(3,3)(rel)));
//   delta_ij = Linear(3,C)(h);
//   a = ReLU(BN_gamma((k_j - q_i) + delta));
//   u = ReLU(BN(Linear(C,G)(a))); l = Linear(G,G)(u), G = C / share;
//   rho = softmax over j of l (f32);
//   y_i[c] = sum_j rho_ij[c mod G] * (v_j[c] + delta_ij[c]).
// The rounding is the plain layer's: every value the plain path holds in
// the compute type T (bf16 or f32) is rounded to T here at the same
// point (rel as the Linear's input, each Linear's output, each batch
// norm's output, k_j - q_i, + delta, v_j + delta), batch norm is
// (x - mean) * (rsqrt(var + eps) * weight) + bias in f32 with each step
// rounded on its own, products and sums accumulate in f32, the softmax
// is torch's (max, exp(x - max), their sum, exp / sum).  Only the order
// of the f32 sums inside a product and over j differs.  Weights are read
// as the module's f32 parameters and rounded to T as `.to(T)` does.
//
// What bounds it on the card: per (query, neighbour) row, ~45 f32
// instructions a channel of elementwise work (delta is formed twice, for a
// and for v + delta) and gamma's C x G product (4.56 G multiply-adds a
// call at the published widths); its compulsory bytes are q, k, v read
// once and y written once (~225 MB a call).  The plain path is bound by
// the ~7 GB of (n, k, .) tensors it moves.
// Design:
//   - A CTA of 256 threads holds R = 16384 / C (query, neighbour) rows,
//     KP row slots a query (k <= KP, KP 8 or 16).  Phase 0 computes each
//     row's neighbour index and its theta hidden h (3 values).  Phase A
//     gathers k_j (8 channels a thread, 16-byte loads), forms delta and a
//     and stores a, rounded to T, in shared memory (rows padded by 16
//     bytes, so 8 rows of a quarter warp read distinct banks).
//   - Phase B: gamma's Linear(C, G).  In bf16 with G >= 8 on the tensor
//     cores (mma.sync m16n8k16, bf16 products summed in f32 as cuBLAS's
//     bf16 product sums them): each warp takes two 16-row x 8-output tiles,
//     A read from the rows in shared memory, W held as bf16 [g][c] in
//     chunks of 256 channels.  In f32 (the plain product is full f32, not
//     TF32) and at G = 2, 4 on the CUDA cores, 8 outputs a thread, W held
//     in f32 as [c][g] in chunks of at most 32 KB.
//   - Phase C: Linear(G, G); D: the softmax over each query's k rows, per
//     output; E: y, 4 channels a thread, v_j gathered and delta formed
//     again from h (the same code, so the same value), the terms summed
//     over j in f32.
//   - The per-channel and per-output vectors (delta's weights, the batch
//     norms' scales) are formed once a CTA in shared memory.
// `vector_attention_bn_scale` exposes the batch-norm scale, so a test can
// hold it equal to torch's rsqrt(var + eps) * weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsTimesC = 16384;  // a CTA's rows x C
constexpr int kW3Floats = 8192;     // gamma's weight chunk, f32 (32 KB)
constexpr int kParams = 20;
constexpr size_t kDefaultSmem = 48 * 1024;

// The module's f32 parameters, in this order (ops/kernels/
// vector_attention.py::PARAMS names them).
enum Param {
  kPosW, kPosB, kPosMean, kPosVar, kPosScale, kPosShift,  // theta's first
  kPosOutW, kPosOutB,                                      // Linear(3, C)
  kBnMean, kBnVar, kBnScale, kBnShift,                     // BN_gamma (C)
  kW1, kB1, kBn1Mean, kBn1Var, kBn1Scale, kBn1Shift,       // Linear(C, G)
  kW2, kB2                                                 // Linear(G, G)
};

struct Args {
  const float* p;      // (queries, 3): the level's points, batch-major
  const void* q;       // (queries, C) T
  const void* key;     // (queries, C) T
  const void* v;       // (queries, C) T
  const int* nbr;      // (queries, k): indices within the query's cloud
  int queries;         // batch * n
  int n, k;
  const float* prm[kParams];
  float eps[3];        // theta's, gamma's first and its second batch norm
  float* y;            // (queries, C) f32
};

__device__ __forceinline__ float bn_scale(float var, float weight,
                                          float eps) {
  return __fmul_rn(rsqrtf(__fadd_rn(var, eps)), weight);
}

// (x - mean) * scale + shift, each step rounded
__device__ __forceinline__ float bn(float x, float mean, float scale,
                                    float shift) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), shift);
}

// torch's relu: a NaN stays, else max(x, 0)
__device__ __forceinline__ float relu(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// d += a b on the tensor cores: a 16 x 16 bf16 (row-major fragments), b
// 16 x 8 bf16 (column-major), d 16 x 8 f32 (PTX mma.sync m16n8k16; lane
// l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) + {0, 1} of d)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void load8(const float* s, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  static __device__ __forceinline__ void load4(const float* s, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
  static __device__ __forceinline__ void store8(float* d, const float* v) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// bf16 element 2i is the low half of word i
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void load8(const __nv_bfloat16* s,
                                               float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    o[0] = lo_bf16(u.x); o[1] = hi_bf16(u.x);
    o[2] = lo_bf16(u.y); o[3] = hi_bf16(u.y);
    o[4] = lo_bf16(u.z); o[5] = hi_bf16(u.z);
    o[6] = lo_bf16(u.w); o[7] = hi_bf16(u.w);
  }
  static __device__ __forceinline__ void load4(const __nv_bfloat16* s,
                                               float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(s);
    o[0] = lo_bf16(u.x); o[1] = hi_bf16(u.x);
    o[2] = lo_bf16(u.y); o[3] = hi_bf16(u.y);
  }
  // v holds values already rounded to bf16: their top halves are exact
  static __device__ __forceinline__ void store8(__nv_bfloat16* d,
                                                const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (__float_as_uint(v[2 * i]) >> 16) |
             (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Shared memory of one CTA, in floats from its start but for As (T):
// As (R x AS of T; Ls, R x US f32, takes its place after gamma's first
// product), W3 (CW x G), W4 (G x G), Us (R x US), seven per-channel
// vectors (C each), five per-output vectors (G each), theta's first
// layer (24), H (R x 3), the rows' neighbour (R ints).
template <typename T, int C, int KP>
struct Layout {
  static constexpr int G = C / 8;
  static constexpr int R = kRowsTimesC / C;   // rows a CTA
  static constexpr int Q = R / KP;            // queries a CTA
  static constexpr int AS = C + 16 / static_cast<int>(sizeof(T));
  static constexpr int GT = G < 8 ? G : 8;    // outputs a thread
  static constexpr int TPR = G / GT;          // threads a row
  static constexpr int RT = 8 / GT;           // rows a thread
  static constexpr int RS = kThreads / TPR;   // between a thread's rows
  static constexpr int CW = C < kW3Floats / G ? C : kW3Floats / G;
  static constexpr int US = G + 1;
  // bf16 with G >= 8: gamma's first product on the tensor cores, W1 held
  // as bf16 [g][c] in chunks of CM channels (rows padded by 16 bytes)
  static constexpr bool kMma = sizeof(T) == 2 && G >= 8;
  static constexpr int CM = C < 256 ? C : 256;
  static constexpr int CMS = CM + 8;
  static constexpr size_t kA = static_cast<size_t>(R) * AS * sizeof(T);
  static constexpr size_t kW3 = kA;
  static constexpr size_t kW4 =
      kW3 + (kMma ? 2ull * G * CMS : 4ull * CW * G);
  static constexpr size_t kU = kW4 + 4ull * G * G;
  static constexpr size_t kChan = kU + 4ull * R * US;
  static constexpr size_t kOut = kChan + 4ull * 7 * C;
  static constexpr size_t kPos = kOut + 4ull * 5 * G;
  static constexpr size_t kH = kPos + 4ull * 24;
  static constexpr size_t kSrc = kH + 4ull * 3 * R;
  static constexpr size_t kBytes = kSrc + 4ull * R;
  static_assert(C % 16 == 0 && G % GT == 0 && RT * GT == 8, "widths");
  static_assert(RT * RS == R && Q * KP == R && R * C % (8 * kThreads) == 0,
                "tiles");
  static_assert(4ull * R * US <= kA, "Ls fits in As");
  static_assert(!kMma || (R % 16 == 0 && (R / 16) * (G / 8) % (kThreads / 32)
                          == 0 && C % 16 == 0), "mma tiles");
  static_assert(kW3 % 16 == 0 && kChan % 16 == 0, "alignment");
};

template <typename T, int C>
__device__ __forceinline__ float delta(const float* chan, int c, float h0,
                                       float h1, float h2) {
  const float acc = __fmaf_rn(
      h2, chan[2 * C + c], __fmaf_rn(h1, chan[C + c], __fmul_rn(h0, chan[c])));
  return Io<T>::round(__fadd_rn(acc, chan[3 * C + c]));
}

template <typename T, int C, int KP>
__global__ void __launch_bounds__(kThreads)
    vector_attention_kernel(const Args a) {
  using L = Layout<T, C, KP>;
  constexpr int G = L::G, R = L::R, Q = L::Q, AS = L::AS, GT = L::GT,
                TPR = L::TPR, RT = L::RT, RS = L::RS, CW = L::CW,
                US = L::US;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  float* Ls = reinterpret_cast<float*>(smem);
  float* W3s = reinterpret_cast<float*>(smem + L::kW3);
  float* W4s = reinterpret_cast<float*>(smem + L::kW4);
  float* Us = reinterpret_cast<float*>(smem + L::kU);
  float* chan = reinterpret_cast<float*>(smem + L::kChan);
  float* outv = reinterpret_cast<float*>(smem + L::kOut);
  float* pos = reinterpret_cast<float*>(smem + L::kPos);
  float* Hs = reinterpret_cast<float*>(smem + L::kH);
  int* Src = reinterpret_cast<int*>(smem + L::kSrc);

  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.key);
  const T* vg = static_cast<const T*>(a.v);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * Q;

  // ---- the CTA's vectors and weights, rounded to T where the plain path
  // rounds them
  for (int c = tid; c < C; c += kThreads) {
    chan[c] = Io<T>::round(a.prm[kPosOutW][3 * c]);
    chan[C + c] = Io<T>::round(a.prm[kPosOutW][3 * c + 1]);
    chan[2 * C + c] = Io<T>::round(a.prm[kPosOutW][3 * c + 2]);
    chan[3 * C + c] = Io<T>::round(a.prm[kPosOutB][c]);
    chan[4 * C + c] = a.prm[kBnMean][c];
    chan[5 * C + c] =
        bn_scale(a.prm[kBnVar][c], a.prm[kBnScale][c], a.eps[1]);
    chan[6 * C + c] = a.prm[kBnShift][c];
  }
  for (int g = tid; g < G; g += kThreads) {
    outv[g] = Io<T>::round(a.prm[kB1][g]);
    outv[G + g] = a.prm[kBn1Mean][g];
    outv[2 * G + g] =
        bn_scale(a.prm[kBn1Var][g], a.prm[kBn1Scale][g], a.eps[2]);
    outv[3 * G + g] = a.prm[kBn1Shift][g];
    outv[4 * G + g] = Io<T>::round(a.prm[kB2][g]);
  }
  // W4s[g'][g] = W2[g][g'], written in order (the reads are L2 hits)
#pragma unroll
  for (int j = 0; j < (G * G + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * G) W4s[i] = Io<T>::round(a.prm[kW2][(i % G) * G + i / G]);
  }
  if (tid < 9) {
    pos[tid] = Io<T>::round(a.prm[kPosW][tid]);        // [out][in]
  } else if (tid < 12) {
    const int t = tid - 9;
    pos[9 + t] = Io<T>::round(a.prm[kPosB][t]);
    pos[12 + t] = a.prm[kPosMean][t];
    pos[15 + t] = bn_scale(a.prm[kPosVar][t], a.prm[kPosScale][t], a.eps[0]);
    pos[18 + t] = a.prm[kPosShift][t];
  }
  __syncthreads();

  // ---- phase 0: each row's neighbour and theta's hidden h
  for (int r = tid; r < R; r += kThreads) {
    const int gq = q0 + r / KP, jj = r % KP;
    int src = -1;
    float h[3] = {0.0f, 0.0f, 0.0f};
    if (gq < a.queries && jj < a.k) {
      src = (gq / a.n) * a.n + a.nbr[static_cast<size_t>(gq) * a.k + jj];
      const float* pj = a.p + 3 * static_cast<size_t>(src);
      const float* pi = a.p + 3 * static_cast<size_t>(gq);
      const float r0 = Io<T>::round(__fsub_rn(pj[0], pi[0]));
      const float r1 = Io<T>::round(__fsub_rn(pj[1], pi[1]));
      const float r2 = Io<T>::round(__fsub_rn(pj[2], pi[2]));
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float acc = __fmaf_rn(
            r2, pos[3 * t + 2],
            __fmaf_rn(r1, pos[3 * t + 1], __fmul_rn(r0, pos[3 * t])));
        const float x = Io<T>::round(__fadd_rn(acc, pos[9 + t]));
        h[t] = relu(
            Io<T>::round(bn(x, pos[12 + t], pos[15 + t], pos[18 + t])));
      }
    }
    Src[r] = src;
    Hs[3 * r] = h[0];
    Hs[3 * r + 1] = h[1];
    Hs[3 * r + 2] = h[2];
  }
  __syncthreads();

  // ---- phase A: a = ReLU(BN_gamma((k_j - q_i) + delta)) into As, 8
  // channels an item (R C / 8 = 2048 items, 8 a thread)
#pragma unroll 4
  for (int j = 0; j < R * (C / 8) / kThreads; ++j) {
    const int it = tid + j * kThreads;
    const int r = it / (C / 8), c0 = (it % (C / 8)) * 8;
    const int src = Src[r];
    float out[8];
    if (src < 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.0f;
    } else {
      const int gq = q0 + r / KP;
      float kk[8], qq[8];
      Io<T>::load8(kg + static_cast<size_t>(src) * C + c0, kk);
      Io<T>::load8(qg + static_cast<size_t>(gq) * C + c0, qq);
      const float h0 = Hs[3 * r], h1 = Hs[3 * r + 1], h2 = Hs[3 * r + 2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        const float d = delta<T, C>(chan, c, h0, h1, h2);
        float x = Io<T>::round(__fsub_rn(kk[i], qq[i]));
        x = Io<T>::round(__fadd_rn(x, d));
        x = Io<T>::round(
            bn(x, chan[4 * C + c], chan[5 * C + c], chan[6 * C + c]));
        out[i] = relu(x);
      }
    }
    Io<T>::store8(As + r * AS + c0, out);
  }

  // ---- phase B: u = ReLU(BN(Linear(C, G)(a))) into Us
  const int gsub = tid % TPR, rg = tid / TPR;   // phase C's (and B's f32)
  float acc[RT][GT];
  if constexpr (L::kMma) {
    // (R / 16) x (G / 8) tiles of 16 rows x 8 outputs, TW a warp
    constexpr int NT = G / 8, TW = (R / 16) * NT / (kThreads / 32);
    constexpr int CMS = L::CMS;
    const uint16_t* A16 = reinterpret_cast<const uint16_t*>(As);
    uint16_t* W3b = reinterpret_cast<uint16_t*>(smem + L::kW3);
    const int warp = tid >> 5, gid = (tid & 31) >> 2, tig = tid & 3;
    float d[TW][4];
#pragma unroll
    for (int t = 0; t < TW; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[t][i] = 0.0f;
    }
    for (int cb = 0; cb < C; cb += L::CM) {
      __syncthreads();
      // W3b[g][c] = W1[g][cb + c] in bf16
      for (int i = tid; i < G * (L::CM / 4); i += kThreads) {
        const int g = i / (L::CM / 4), c4 = (i % (L::CM / 4)) * 4;
        const float4 w = *reinterpret_cast<const float4*>(
            a.prm[kW1] + static_cast<size_t>(g) * C + cb + c4);
        const float v4[4] = {Io<T>::round(w.x), Io<T>::round(w.y),
                             Io<T>::round(w.z), Io<T>::round(w.w)};
        *reinterpret_cast<uint2*>(W3b + g * CMS + c4) = make_uint2(
            (__float_as_uint(v4[0]) >> 16) |
                (__float_as_uint(v4[1]) & 0xffff0000u),
            (__float_as_uint(v4[2]) >> 16) |
                (__float_as_uint(v4[3]) & 0xffff0000u));
      }
      __syncthreads();
#pragma unroll 2
      for (int k0 = 0; k0 < L::CM; k0 += 16) {
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          const int tile = warp * TW + t;
          const int r0 = (tile / NT) * 16 + gid, n = (tile % NT) * 8 + gid;
          const int ca = cb + k0 + 2 * tig;
          const uint32_t fa[4] = {
              *reinterpret_cast<const uint32_t*>(A16 + r0 * AS + ca),
              *reinterpret_cast<const uint32_t*>(A16 + (r0 + 8) * AS + ca),
              *reinterpret_cast<const uint32_t*>(A16 + r0 * AS + ca + 8),
              *reinterpret_cast<const uint32_t*>(A16 + (r0 + 8) * AS + ca +
                                                 8)};
          const int cw = n * CMS + k0 + 2 * tig;
          const uint32_t fb[2] = {
              *reinterpret_cast<const uint32_t*>(W3b + cw),
              *reinterpret_cast<const uint32_t*>(W3b + cw + 8)};
          mma_16816(d[t], fa, fb);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      const int tile = warp * TW + t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tile / NT) * 16 + gid + (i >= 2 ? 8 : 0);
        const int o = (tile % NT) * 8 + 2 * tig + (i & 1);
        const float x = Io<T>::round(__fadd_rn(d[t][i], outv[o]));
        Us[r * US + o] = relu(Io<T>::round(
            bn(x, outv[G + o], outv[2 * G + o], outv[3 * G + o])));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[i][g] = 0.0f;
    }
    for (int cb = 0; cb < C; cb += CW) {
      __syncthreads();
      // W3s[c][g] = W1[g][cb + c]
#pragma unroll
      for (int j = 0; j < (G * (CW / 4) + kThreads - 1) / kThreads; ++j) {
        const int i = tid + j * kThreads;
        if (i >= G * (CW / 4)) break;
        const int g = i % G, c4 = (i / G) * 4;
        const float4 w = *reinterpret_cast<const float4*>(
            a.prm[kW1] + static_cast<size_t>(g) * C + cb + c4);
        W3s[(c4 + 0) * G + g] = Io<T>::round(w.x);
        W3s[(c4 + 1) * G + g] = Io<T>::round(w.y);
        W3s[(c4 + 2) * G + g] = Io<T>::round(w.z);
        W3s[(c4 + 3) * G + g] = Io<T>::round(w.w);
      }
      __syncthreads();
      for (int c0 = 0; c0 < CW; c0 += 8) {
        float av[RT][8];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          Io<T>::load8(As + (rg + i * RS) * AS + cb + c0, av[i]);
        }
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const float* wrow = W3s + (c0 + cc) * G + gsub * GT;
          float w[GT];
#pragma unroll
          for (int g = 0; g < GT; ++g) w[g] = wrow[g];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              acc[i][g] = __fmaf_rn(av[i][cc], w[g], acc[i][g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const int o = gsub * GT + g;
        const float x = Io<T>::round(__fadd_rn(acc[i][g], outv[o]));
        Us[(rg + i * RS) * US + o] = relu(Io<T>::round(
            bn(x, outv[G + o], outv[2 * G + o], outv[3 * G + o])));
      }
    }
  }
  __syncthreads();

  // ---- phase C: the logits Linear(G, G)(u) into Ls (As's place)
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[i][g] = 0.0f;
  }
  for (int g2 = 0; g2 < G; ++g2) {
    const float* wrow = W4s + g2 * G + gsub * GT;
    float w[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) w[g] = wrow[g];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float u = Us[(rg + i * RS) * US + g2];
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[i][g] = __fmaf_rn(u, w[g], acc[i][g]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const int o = gsub * GT + g;
      Ls[(rg + i * RS) * US + o] =
          Io<T>::round(__fadd_rn(acc[i][g], outv[4 * G + o]));
    }
  }
  __syncthreads();

  // ---- phase D: rho, the softmax over each query's k rows, in place
  for (int it = tid; it < Q * G; it += kThreads) {
    const int qi = it / G, g = it % G;
    if (q0 + qi >= a.queries) continue;
    float* l = Ls + qi * KP * US + g;
    float m = l[0];
    for (int j = 1; j < a.k; ++j) m = fmaxf(m, l[j * US]);
    float s = 0.0f;
    for (int j = 0; j < a.k; ++j) {
      const float e = expf(__fsub_rn(l[j * US], m));
      l[j * US] = e;
      s = __fadd_rn(s, e);
    }
    for (int j = 0; j < a.k; ++j) l[j * US] = __fdiv_rn(l[j * US], s);
  }
  __syncthreads();

  // ---- phase E: y_i[c] = sum_j rho_ij[c mod G] (v_j[c] + delta_ij[c])
  for (int it = tid; it < Q * (C / 4); it += kThreads) {
    const int qi = it / (C / 4), c0 = (it % (C / 4)) * 4;
    const int gq = q0 + qi;
    if (gq >= a.queries) continue;
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < a.k; ++j) {
      const int r = qi * KP + j;
      float vv[4];
      Io<T>::load4(vg + static_cast<size_t>(Src[r]) * C + c0, vv);
      const float h0 = Hs[3 * r], h1 = Hs[3 * r + 1], h2 = Hs[3 * r + 2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + i;
        const float val = Io<T>::round(
            __fadd_rn(vv[i], delta<T, C>(chan, c, h0, h1, h2)));
        y[i] = __fadd_rn(y[i], __fmul_rn(val, Ls[r * US + (c & (G - 1))]));
      }
    }
    *reinterpret_cast<float4*>(a.y + static_cast<size_t>(gq) * C + c0) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

__global__ void bn_scale_kernel(const float* var, const float* weight,
                                float eps, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = bn_scale(var[i], weight[i], eps);
}

using KernelFn = void (*)(const Args);

struct Plan {
  KernelFn fn;
  size_t bytes;
  int queries_a_cta;
};

template <typename T, int C, int KP>
Plan plan_of() {
  using L = Layout<T, C, KP>;
  return Plan{&vector_attention_kernel<T, C, KP>, L::kBytes, L::Q};
}

template <typename T, int KP>
Plan plan_for_width(int C) {
  switch (C) {
    case 16: return plan_of<T, 16, KP>();
    case 32: return plan_of<T, 32, KP>();
    case 64: return plan_of<T, 64, KP>();
    case 128: return plan_of<T, 128, KP>();
    case 256: return plan_of<T, 256, KP>();
    case 512: return plan_of<T, 512, KP>();
    default: return Plan{nullptr, 0, 0};
  }
}

}  // namespace

extern "C" {

// y (batch * n, C) f32 of the layer for q, key, v (batch * n, C) of
// bf16 (bf16 = 1) or f32, the points p (batch * n, 3), the neighbours
// nbr (batch * n, k) and the module's 20 f32 parameter vectors `prm`
// (host array of device pointers) with the three norms' eps.  C in
// {16, 32, 64, 128, 256, 512}, G = C / 8, k <= 16.  Launches on `stream`
// and returns cudaGetLastError() (or the refusal's code).
int vector_attention_launch(int bf16, int C, int batch, int n, int k,
                            const float* p, const void* q, const void* key,
                            const void* v, const int* nbr,
                            const float* const* prm, const float* eps,
                            float* y, cudaStream_t stream) {
  if (batch < 1 || n < 1 || k < 1 || k > 16 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = bf16 ? (k <= 8 ? plan_for_width<__nv_bfloat16, 8>(C)
                                   : plan_for_width<__nv_bfloat16, 16>(C))
                         : (k <= 8 ? plan_for_width<float, 8>(C)
                                   : plan_for_width<float, 16>(C));
  if (plan.fn == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long queries = static_cast<long long>(batch) * n;
  const long long blocks =
      (queries + plan.queries_a_cta - 1) / plan.queries_a_cta;
  if (queries > 0x7fffffffLL || queries * 16 * 512 > (1LL << 62) ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Args a{};
  a.p = p;
  a.q = q;
  a.key = key;
  a.v = v;
  a.nbr = nbr;
  a.queries = static_cast<int>(queries);
  a.n = n;
  a.k = k;
  for (int i = 0; i < kParams; ++i) a.prm[i] = prm[i];
  for (int i = 0; i < 3; ++i) a.eps[i] = eps[i];
  a.y = y;
  if (plan.bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(plan.fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  plan.fn<<<static_cast<unsigned>(blocks), kThreads, plan.bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = rsqrt(var[i] + eps) * weight[i] as the kernel forms a batch
// norm's scale.
int vector_attention_bn_scale(const float* var, const float* weight,
                              float eps, int n, float* out,
                              cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  bn_scale_kernel<<<(n + 255) / 256, 256, 0, stream>>>(var, weight, eps, n,
                                                       out);
  return static_cast<int>(cudaGetLastError());
}

const char* vector_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
