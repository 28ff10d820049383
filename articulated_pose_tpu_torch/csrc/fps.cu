// Farthest point sampling, two-level (B, N, 3) -> N -> np1 -> np2 and
// single-level (B, N, 3) -> npoint, in one kernel (np2 = 0: one level).
//
// The launch with np2 > 0 (K1, `fps2`) replaces the TPU kernel
// articulated_pose_tpu/ops/pallas/fps.py::farthest_point_sample2_pallas
// (body _fps2_kernel); with np2 = 0 (B2, `fps`) it replaces
// farthest_point_sample_pallas (body _fps_kernel).  Semantics: the first
// pick is index 0, every later pick maximises the running minimum
// squared distance (dx*dx + dy*dy) + dz*dz to the picked set (round to
// nearest, no contraction), ties go to the lowest index, and level 2
// runs on the np1 picks, so idx2 holds LOCAL indices.  A level may pick
// more points than it has (npoint > N, np2 > np1), as the TPU kernels
// do: the picks past the last distinct point are index 0.
//
// What bounds it on the card: the recurrence is serial in the picks, so
// a cloud's time is npoint times one step, far above the bytes and
// FLOPs it needs.  A step is (a) the distance update and argmax of the
// points a thread holds, ~14 instructions a point, and (b) the argmax
// across lanes, warps and CTAs, a chain of dependent latencies (redux,
// ballot + ffs, a shared-memory record and a barrier, and in a cluster
// a DSMEM push and an mbarrier wait).  The winner's coordinates start
// the next step.  The design:
//
// 1. The cloud stays on chip, in registers: each thread keeps P points
//    (coordinates and running minima) at compile-time slots, a
//    contiguous run of the cloud (thread t of a CTA holds points
//    begin + t * P ..); an empty slot's minimum is -1, so the scan has
//    no bound to test, and a thread's argmax over its slots is a tree.
//    A variant is (warps W, P).  One warp needs no barrier at all; four
//    warps, one a scheduler, step faster than eight or sixteen (their
//    barrier and record tree are shorter) and run a CTA's scan as
//    fast.  A streamed variant, for any N, keeps the minima in a
//    device-memory row and reads the coordinates from L2.
// 2. One barrier per pick, no dependent reload.  A warp reduces with
//    redux.sync: the max of the distances' bits (a non-negative float
//    orders as its bits), then, since a lane's run precedes the next
//    lane's, the lowest lane holding that max (ballot + ffs) holds the
//    lowest index.  That lane writes the warp's record (dist, index,
//    x, y, z) to a shared-memory slot double-buffered by the step's
//    parity; one barrier; then every thread reads the W dists in W / 4
//    vector loads and takes the lowest warp holding the largest by a
//    register tree (warps hold rising runs too), and the winner's point
//    from its record: no second barrier, broadcast or reload.  The
//    streamed variant's points interleave, so its lanes and records
//    break ties with a redux.sync min over the indices.  The picks
//    leave through the writer warp's registers, 32 at a time (Kept).
// 3. A large cloud is split over a thread-block cluster of C CTAs
//    (C in 1, 2, 4, 8, 16; above 8 non-portable).  Each CTA owns a
//    contiguous slice of N and reduces it to one record as above; lane r
//    of warp 0 pushes that record into CTA r's slot for this CTA
//    (st.async into distributed shared memory, completing bytes on CTA
//    r's mbarrier of this parity); every CTA waits on its own mbarrier
//    for the C records, then reduces them (lane r takes record r),
//    ties by global index, never by rank.  The wait is one-way:
//    a CTA waits for its peers' records, not for a cluster barrier's
//    round trip, which alone read slower on an H100 than the whole
//    exchange.  Every CTA learns every pick's coordinates, so level 2 of
//    fps2 runs in CTA 0 alone from the picks it wrote (on as few warps
//    as hold them) while the other CTAs exit.
//
// Timed on an H100 and left out: a 64-bit key (dist, ~index) per thread
// combined by a shared-memory atomicMax, then a lookup of the winner in
// a shared copy of the cloud (about twice the step of the records
// above); the writer thread storing each pick to device memory as it
// came (the next barrier waits for the store; Kept below stores 32
// picks at a time instead).
//
// Which variant and cluster a shape takes is decided once, in the
// wrapper (ops/kernels/fps.py::fps_plan), from a sweep on the card
// (articulated_pose_tpu_torch/fps_sweep.py).  The TPU kernel sized its
// batch tile to N so its VMEM state fit; here the register file of a
// CTA, or of a cluster, is that state's home.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFar = 0x7e967699;      // the bits of 1e38f, the initial minimum
constexpr int kMaxCluster = 16;
constexpr int kRecordBytes = 20;      // a CTA's record: 16 + 4 bytes

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                       float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The input cloud: read-only for the whole launch.
struct Input {
  const float* __restrict__ p;
  __device__ float3 operator()(int k) const {
    return make_float3(__ldg(p + 3 * k), __ldg(p + 3 * k + 1),
                       __ldg(p + 3 * k + 2));
  }
};

// The level-1 picks, which this CTA wrote: plain loads.
struct Written {
  const float* p;
  __device__ float3 operator()(int k) const {
    return make_float3(p[3 * k], p[3 * k + 1], p[3 * k + 2]);
  }
};

// A candidate: its running minimum's bits (-1: none), index, point.
struct Pick {
  int dist, idx;
  float x, y, z;
};

__device__ __forceinline__ Pick none() {
  return {-1, INT_MAX, 0.0f, 0.0f, 0.0f};
}

// The lane holding the warp's best candidate: the largest dist, then
// the lowest index.  kOrdered: the lanes' indices rise with the lane, so
// the lowest lane holding the largest dist holds the lowest index.
template <bool kOrdered>
__device__ __forceinline__ int best_lane(int dist, int idx) {
  const int top = __reduce_max_sync(kFull, dist);
  unsigned hold = __ballot_sync(kFull, dist == top);
  if (!kOrdered) {
    const int low = __reduce_min_sync(kFull, dist == top ? idx : INT_MAX);
    hold = __ballot_sync(kFull, dist == top && idx == low);
  }
  return __ffs(hold) - 1;
}

__device__ __forceinline__ Pick from_lane(const Pick& c, int lane) {
  return {__shfl_sync(kFull, c.dist, lane), __shfl_sync(kFull, c.idx, lane),
          __shfl_sync(kFull, c.x, lane), __shfl_sync(kFull, c.y, lane),
          __shfl_sync(kFull, c.z, lane)};
}

// Up to P points a thread, in registers: the `threads` threads split
// begin .. end into rising runs as even as can be (thread t's run
// first .. first + cnt - 1 in slots 0 .. cnt - 1).  An empty slot's
// minimum is -1, below every distance: the scan updates every slot,
// with no bound to test, and never picks an empty one.
template <int P>
struct RegSet {
  static constexpr bool kOrdered = true;
  float x[P], y[P], z[P];
  int m[P];
  int first;

  template <typename Load>
  __device__ void load(const Load& ld, int begin, int end, int threads) {
    const int t = threadIdx.x;
    const int each = (end - begin) / threads;
    const int extra = (end - begin) % threads;
    const int cnt = each + (t < extra ? 1 : 0);
    first = begin + t * each + min(t, extra);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float3 p = make_float3(0.0f, 0.0f, 0.0f);
      if (i < cnt) p = ld(first + i);
      x[i] = p.x;
      y[i] = p.y;
      z[i] = p.z;
      m[i] = i < cnt ? kFar : -1;
    }
  }

  // Update the minima against the last pick; the thread's best point, by
  // a tree over the slots in which the later slot wins only when strictly
  // greater, so a tie keeps the lowest index (log2 P compares deep, not P).
  __device__ Pick scan(const float3& l) {
    Pick c[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      m[i] = min(m[i], __float_as_int(sqdist(x[i], y[i], z[i], l.x, l.y,
                                             l.z)));
      c[i] = {m[i], i, x[i], y[i], z[i]};
    }
#pragma unroll
    for (int s = 1; s < P; s *= 2) {
#pragma unroll
      for (int i = 0; i + s < P; i += 2 * s) {
        if (c[i + s].dist > c[i].dist) c[i] = c[i + s];
      }
    }
    c[0].idx += first;
    return c[0];
  }
};

// Any number of points a thread, interleaved (point k on thread
// k % threads, for coalesced reads): minima in a device-memory row
// indexed by point, coordinates read each step.
template <typename Load>
struct StreamSet {
  static constexpr bool kOrdered = false;
  Load ld;
  int* mind;
  int begin, end, threads;

  __device__ void init() {
    for (int k = begin + threadIdx.x; k < end; k += threads) mind[k] = kFar;
  }

  __device__ Pick scan(const float3& l) {
    Pick best = none();
    for (int k = begin + threadIdx.x; k < end; k += threads) {
      const float3 p = ld(k);
      const int m = min(mind[k], __float_as_int(sqdist(p.x, p.y, p.z, l.x,
                                                       l.y, l.z)));
      mind[k] = m;
      if (m > best.dist) best = {m, k, p.x, p.y, p.z};
    }
    return best;
  }
};

// A step's records, double-buffered by the step's parity: one a warp,
// and, in a cluster, one a CTA (written by the peers with st.async).
template <int W>
struct Slots {
  float4 wxyz[2][W];
  int4 crec[2][kMaxCluster];          // a CTA's dist, index, x, y (bits)
  alignas(16) int wdist[2][W];        // read as int4 when W % 4 == 0
  int widx[2][W];
  float cz[2][kMaxCluster];           // and its z
  unsigned long long mbar[2];
};

// The best of the W warp records of parity p, in every thread.  Warps
// hold rising runs, so the lowest warp holding the largest dist holds
// the lowest index: a tree in which the later warp wins only when
// strictly greater.  The dists come in W / 4 vector loads, the winner's
// point in one more: no reduction across lanes after the barrier.
template <int W>
__device__ __forceinline__ Pick from_records(const Slots<W>& s, int p) {
  int d[W], k[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int w = 0; w < W; w += 4) {
      const int4 v = *reinterpret_cast<const int4*>(&s.wdist[p][w]);
      d[w] = v.x;
      d[w + 1] = v.y;
      d[w + 2] = v.z;
      d[w + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) d[w] = s.wdist[p][w];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) k[w] = w;
#pragma unroll
  for (int step = 1; step < W; step *= 2) {
#pragma unroll
    for (int w = 0; w + step < W; w += 2 * step) {
      if (d[w + step] > d[w]) {
        d[w] = d[w + step];
        k[w] = k[w + step];
      }
    }
  }
  const float4 v = s.wxyz[p][k[0]];
  return {d[0], s.widx[p][k[0]], v.x, v.y, v.z};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void expect_bytes(unsigned long long* bar,
                                             int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `parity` has completed.  A record that never
// arrives traps (a launch error) after ~1 s instead of hanging the card.
__device__ __forceinline__ void wait_parity(unsigned long long* bar,
                                            int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}

// Where lane r of warp 0 pushes this CTA's record: its slots in CTA r
// for parity 0 (parity 1's lie one array row further).
struct Peer {
  uint32_t rec, z, bar;
};

// How the warps (and CTAs) of a level meet at each step.
template <int W>
struct Team {
  Slots<W>* s;
  int warps;   // active warps; records of the others stay none()
  int bar;     // named barrier of the warps (warps > 1)
  int ctas;    // 1, or the cluster's size
  Peer peer;   // lane r < ctas of warp 0: CTA r's slot for this CTA
};

// Step j's pick from each thread's best candidate `mine`.
template <int W, bool kOrdered>
__device__ __forceinline__ Pick meet(const Team<W>& t, int j,
                                     const Pick& mine) {
  const int lane = threadIdx.x & 31;
  const int p = j & 1;
  Slots<W>& s = *t.s;
  const int src = best_lane<kOrdered>(mine.dist, mine.idx);
  Pick best;
  if (t.warps == 1) {
    best = from_lane(mine, src);
  } else {
    const int warp = threadIdx.x >> 5;
    if (lane == src) {
      s.wdist[p][warp] = mine.dist;
      s.widx[p][warp] = mine.idx;
      s.wxyz[p][warp] = make_float4(mine.x, mine.y, mine.z, 0.0f);
    }
    named_barrier(t.bar, t.warps * 32);
    if constexpr (kOrdered) {
      best = from_records(s, p);
    } else {
      // interleaved points: lane w takes record w, ties by index
      Pick r = none();
      if (lane < W) {
        const float4 v = s.wxyz[p][lane];
        r = {s.wdist[p][lane], s.widx[p][lane], v.x, v.y, v.z};
      }
      best = from_lane(r, best_lane<false>(r.dist, r.idx));
    }
  }
  if (t.ctas == 1) return best;

  // the cluster: push this CTA's best to every CTA, wait for theirs
  if (threadIdx.x < t.ctas) {
    const uint32_t rec = t.peer.rec + p * uint32_t(sizeof(s.crec[0]));
    const uint32_t z = t.peer.z + p * uint32_t(sizeof(s.cz[0]));
    const uint32_t bar = t.peer.bar + p * uint32_t(sizeof(s.mbar[0]));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(rec),
        "r"(best.dist), "r"(best.idx), "r"(__float_as_int(best.x)),
        "r"(__float_as_int(best.y)), "r"(bar)
        : "memory");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1,"
        " [%2];" ::"r"(z),
        "r"(__float_as_int(best.z)), "r"(bar)
        : "memory");
  }
  if (threadIdx.x == 0) expect_bytes(&s.mbar[p], t.ctas * kRecordBytes);
  // mbar[p] serves steps p, p + 2, ... from j = 1: this is its use
  // (j - 1) / 2, whose phase has that parity
  wait_parity(&s.mbar[p], ((j - 1) >> 1) & 1);
  // lane r takes CTA r's record; ties by global index, never by rank (a
  // 16-wide register tree over the records, as for the warps' above,
  // was slower at both clustered path shapes on the card)
  Pick c = none();
  if (lane < t.ctas) {
    const int4 v = s.crec[p][lane];
    c = {v.x, v.y, __int_as_float(v.z), __int_as_float(v.w), s.cz[p][lane]};
  }
  return from_lane(c, best_lane<false>(c.dist, c.idx));
}

// A level's picks on their way out: lane j % 32 of the writer warp keeps
// pick j, and the warp stores them 32 at a time.  A store to device
// memory at every step would hold up the next barrier until it is
// performed (the header above).
struct Kept {
  int* idx_out;
  float* xyz_out;
  bool writer;   // the warp that stores; every warp keeps
  int idx;
  float x, y, z;

  __device__ void keep(int j, int last, int i, const float3& p) {
    const int lane = threadIdx.x & 31;
    if (lane == (j & 31)) {
      idx = i;
      x = p.x;
      y = p.y;
      z = p.z;
    }
    if (writer && ((j & 31) == 31 || j == last) && lane <= (j & 31)) {
      const int k = (j & ~31) + lane;
      idx_out[k] = idx;
      xyz_out[3 * k + 0] = x;
      xyz_out[3 * k + 1] = y;
      xyz_out[3 * k + 2] = z;
    }
  }
};

// One FPS level: npoint picks over the level's n points, the first
// being point 0.  The writer warp stores the picks.  npoint may exceed
// n: a pick whose running minimum is above 0 is a point neither picked
// nor a copy of a picked one, so once pick n - 1 has updated the minima
// every one of them is 0, and each later pick is point 0, the lowest
// index holding the largest minimum, as the plain version's argmax takes
// it.  Those picks are written without a step; every CTA of a cluster
// steps the same min(npoint, n) - 1 times, so none waits for a record
// that is never pushed.  The steps themselves are as for npoint <= n.
template <int W, typename Set, typename Load>
__device__ void run_level(Set& set, const Load& ld, int n, int npoint,
                          int* idx_out, float* xyz_out, bool writer,
                          const Team<W>& team) {
  float3 l = ld(0);
  Kept kept{idx_out, xyz_out, writer, 0, 0.0f, 0.0f, 0.0f};
  kept.keep(0, npoint - 1, 0, l);
  const int steps = min(npoint, n);
  for (int j = 1; j < steps; ++j) {
    const Pick p = meet<W, Set::kOrdered>(team, j, set.scan(l));
    l = make_float3(p.x, p.y, p.z);
    kept.keep(j, npoint - 1, p.idx, l);
  }
  if (steps < npoint) {
    const float3 first = ld(0);
    for (int j = steps; j < npoint; ++j) kept.keep(j, npoint - 1, 0, first);
  }
}

// W warps a CTA; P points a thread in level 1 (0: streamed), P2 in
// level 2.  Grid: batch * cluster CTAs, cluster CTAs a cloud (CTA
// blockIdx.x % cluster is the cluster's rank).  scratch: (batch,
// n + np1) ints when a level streams, else unused.
template <int W, int P, int P2>
__global__ void __launch_bounds__(W * 32)
    fps_kernel(const float* __restrict__ xyz, int n, int np1, int np2,
               int cluster, int* __restrict__ idx1, float* xyz1,
               int* __restrict__ idx2, float* __restrict__ xyz2,
               int* __restrict__ scratch) {
  constexpr int kThreads = W * 32;
  __shared__ Slots<W> slots;
  const int rank = static_cast<int>(blockIdx.x) % cluster;
  const int b = blockIdx.x / cluster;
  const int warp = threadIdx.x >> 5;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  int* i1 = idx1 + static_cast<size_t>(b) * np1;
  float* x1 = xyz1 + static_cast<size_t>(b) * np1 * 3;
  int* row = scratch == nullptr
                 ? nullptr
                 : scratch + static_cast<size_t>(b) * (n + np1);
  const int slice = (n + cluster - 1) / cluster;
  const int begin = min(n, rank * slice);
  const int end = min(n, begin + slice);

  Team<W> team{&slots, W, 0, cluster, {}};
  if (cluster > 1) {
    if (threadIdx.x == 0) {
      for (int q = 0; q < 2; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(&slots.mbar[q]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (threadIdx.x < cluster) {
      team.peer = {peer_addr(&slots.crec[0][rank], threadIdx.x),
                   peer_addr(&slots.cz[0][rank], threadIdx.x),
                   peer_addr(&slots.mbar[0], threadIdx.x)};
    }
    // every CTA has started and initialised its mbarriers before any
    // record is pushed to it
    cluster_sync();
  }
  const bool writer = rank == 0 && warp == 0;
  if constexpr (P == 0) {
    StreamSet<Input> set{Input{cloud}, row, begin, end, kThreads};
    set.init();
    run_level(set, Input{cloud}, n, np1, i1, x1, writer, team);
  } else {
    RegSet<P> set;
    set.load(Input{cloud}, begin, end, kThreads);
    run_level(set, Input{cloud}, n, np1, i1, x1, writer, team);
  }
  // every record pushed to this CTA has arrived (it waited for each
  // step's), so a CTA other than 0 may exit
  if (np2 == 0 || rank != 0) return;

  // level 2 in CTA 0 alone: after this barrier no warp reads level 1's
  // records, and warp 0's picks are visible to the CTA
  __syncthreads();
  int* i2 = idx2 + static_cast<size_t>(b) * np2;
  float* x2 = xyz2 + static_cast<size_t>(b) * np2 * 3;
  const bool regs = np1 <= kThreads * P2;
  const int warps = regs ? min(W, (np1 + 32 * P2 - 1) / (32 * P2)) : W;
  if (threadIdx.x == 0) {
    // the idle warps' records lose every step (the first step's barrier
    // orders these stores before any read)
    for (int q = 0; q < 2; ++q) {
      for (int w = warps; w < W; ++w) {
        slots.wdist[q][w] = -1;
        slots.widx[q][w] = INT_MAX;
      }
    }
  }
  if (warp >= warps) return;
  const Team<W> team2{&slots, warps, 1, 1, {}};
  if (regs) {
    RegSet<P2> set;
    set.load(Written{x1}, 0, np1, warps * 32);
    run_level(set, Written{x1}, np1, np2, i2, x2, warp == 0, team2);
  } else {
    StreamSet<Written> set{Written{x1}, row + n, 0, np1, kThreads};
    set.init();
    run_level(set, Written{x1}, np1, np2, i2, x2, warp == 0, team2);
  }
}

template <int W, int P, int P2>
int launch(int cluster, const float* xyz, int batch, int n, int np1, int np2,
           int* idx1, float* xyz1, int* idx2, float* xyz2, int* scratch,
           cudaStream_t stream) {
  if (P > 0 && (n + cluster - 1) / cluster > W * 32 * P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool streams = P == 0 || (np2 > 0 && np1 > W * 32 * P2);
  if (streams && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fps_kernel<W, P, P2>;
  if (cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return static_cast<int>(err);
    }
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xyz, n, np1, np2,
                                             cluster, idx1, xyz1, idx2, xyz2,
                                             scratch);
  // read (and clear) the launch's error even when the call itself failed
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The variants, in ops/kernels/fps.py::VARIANTS' order:
//   X(id, warps W, level-1 points a thread P (0: streamed),
//     level-2 points a thread P2)
#define FPS_VARIANTS(X) \
  X(0, 1, 4, 4)         \
  X(1, 1, 16, 16)       \
  X(2, 4, 8, 8)         \
  X(3, 4, 16, 16)       \
  X(4, 32, 0, 4)

extern "C" {

// Launches `batch * cluster` CTAs on `stream`, `cluster` a cloud (1, 2,
// 4, 8 or 16); np2 = 0 runs level 1 alone (idx2, xyz2 unused).  scratch:
// (batch, n + np1) ints when a level streams.  Returns the launch's
// error (cudaGetLastError()), or cudaErrorInvalidValue for an unknown
// variant or cluster, a cloud the variant does not hold, or a missing
// scratch.
int fps_launch(int variant, int cluster, const float* xyz, int batch, int n,
               int np1, int np2, int* idx1, float* xyz1, int* idx2,
               float* xyz2, int* scratch, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (variant) {
#define FPS_CASE(id, W, P, P2)                                              \
  case id:                                                                  \
    return launch<W, P, P2>(cluster, xyz, batch, n, np1, np2, idx1, xyz1,   \
                            idx2, xyz2, scratch, stream);
    FPS_VARIANTS(FPS_CASE)
#undef FPS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
