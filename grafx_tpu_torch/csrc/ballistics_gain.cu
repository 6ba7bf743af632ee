// Fused ballistics-smoother + quadratic-knee gain, forward, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded through ctypes (grafx_tpu_torch/ops/_cuda.py).
//
// Replaces six Pallas TPU kernels of grafx_tpu/ops/ballistics_tpu.py:
//   * grafx_gain_fwd           <- _fwd_gain_only_kernel      (ballistics_tpu.py:587)
//   * grafx_gain_pair_fwd      <- _fwd_gain_pair_only_kernel (ballistics_tpu.py:826)
//   * grafx_gain_fwd_res       <- _fwd_gain_kernel           (ballistics_tpu.py:449)
//   * grafx_gain_pair_fwd_res  <- _fwd_gain_pair_kernel      (ballistics_tpu.py:747)
//   * grafx_ballistics_fwd     <- _kernel                    (ballistics_tpu.py:35),
//                                 and with d set <- _fwd_d_kernel (ballistics_tpu.py:73)
// and the natural-layout experiment of benchmarks/ballistics_layout_ab.py
// (_kernel_nat, :36), which computes the same function as _kernel; and
// holds one kernel of the port's own, with no Pallas counterpart:
//   * grafx_chain_fwd          the dynamics chain (ops/ballistics.py:
//                              ballistics_chain_core), for grafx_tpu's
//                              composed path (grafx_tpu/render/fuse.py:423,
//                              grafx_tpu/processors/dynamics.py:95), where
//                              each walk of a gain-smoothed run is its own
//                              ballistics_core call.
// The *_res versions also write the residuals the adjoints
// (ballistics_grad.cu) need: d[n] = x[n] - y[n-1] of each walk and, for
// the gains, its final state y[L-1].  grafx_ballistics_fwd is the walk
// alone, from a per-row initial state: the envelope smoother a streamed
// compressor calls once per block, carrying y[L-1] into the next call.
// Given d, grafx_ballistics_fwd also writes the residual: the forward
// of the plain smoother under gradient (a FactorizedCompressor walks its
// 1024-sample frames with it: rows of 128 frame means).
//
// What is computed (per row, sequentially over time):
//   y[n]  = (u[n] > y[n-1]) ? (1-at) y[n-1] + at u[n] : (1-rt) y[n-1] + rt u[n]
//   gain  = exp(cf * f(log(y + 1e-5) - th)),  f = quadratic knee (_knee_f)
// and for the pair, a second walk over the gated energy ga^2 u whose gain
// multiplies the first.  An absent member has cf = 0, so its gain is
// exactly 1.
//
// Design and what bounds it.  The walk cannot be split over time (the
// attack/release choice depends on the state), so one thread walks one
// row from its first sample to its last, and the time of every kernel
// here is that serial chain: walk_step (ballistics.cuh), the step of
// every walk, so #1/#3, #2/#5 and #7/#8 agree bit for bit (two FMAs
// beside a compare, then a bitwise select), times the row's samples.
// The design keeps the walking thread on that chain and nothing else:
//   * One row a block.  A block moves its row T samples at a time
//     (walk_samples in ops/ballistics.py: 1024, or the row's length
//     rounded up to 32 where that is less) through a ring of S stages in
//     dynamic shared memory, one buffer of T + 4 floats per array a stage
//     (the walker's last float4 read of a stage lands in the 4).  The
//     console's 68, 8 or 17 rows each get an SM of their own.  Where the
//     rows outnumber the SMs, the ring shrinks (ring_stages) so that up to
//     kMaxShare blocks fit an SM together: a walker's chain is latency,
//     not issue, so walkers that share an SM run side by side.
//   * Bulk copies.  A row's T samples are contiguous in (N, L): they
//     arrive by ONE Hopper bulk copy (cp.async.bulk ... mbarrier::
//     complete_tx) on the stage's mbarrier and leave by one bulk store per
//     output array (cp.async.bulk.global.shared::cta.bulk_group), where
//     the row is 16-byte aligned; an unaligned row or a ragged tail
//     (L % 4 != 0) moves by 4-byte cp.async spread over a warp (completing
//     on the same mbarrier) and plain stores.  The old 32 x 32 tiles took
//     64-96 four-byte copies a lane.
//   * Warp roles.  The walker (one thread) only walks: it reads four
//     samples as a float4 (the next four already in flight) and writes y
//     as one.  A copy warp issues the copies and stores and, for the
//     residual, computes d[n] = u[n] - y[n-1] from the stage in shared
//     memory with all 32 lanes, so d costs the walker nothing.  The walker
//     issuing its own copies (measured beside it, PERF.md) was slower.
//   * A stage's buffer is refilled for stage k - 1 + S right after stage
//     k's stores are issued (waiting only for stage k - 1's stores to have
//     read it), so up to S - 2 stages are in flight while one is walked.
//     The mbarrier phases carry the in-place case (y == x): stage k is
//     stored after it landed, and every later load reads samples no store
//     has touched.
//   * The single gain (#2, #5) is walk_kernel and then knee_kernel, the
//     log / exp knee as an elementwise pass over all SMs (8 B a sample).
//   * The pair (#1, #3) is ONE kernel, pair_kernel: warp 0 walks member a
//     over stage k + 1 while warp 1 walks member b over stage k; four knee
//     warps compute, between them, stage k's ga and ec = ga^2 u into
//     shared memory (the order of ballistics_tpu.py:792-796), then after
//     b's walk gb and the gain ga * gb (:810-812), and with residuals d_a
//     and d_b; the first knee warp also moves the row.  Member b never
//     waits for all of member a, and ga never goes through device memory.
//     The pair then costs about one walk, where two walks with the knees
//     between them in separate passes cost two (PERF.md).
//   * The chain is pair_kernel grown to a run's every walk, up to four
//     (a gate's energy and gain, then a compressor's energy, over the
//     gated energy, and gain): chain_kernel.  Walker warp r walks
//     recursion r a stage behind walker r - 1; eight knee warps compute,
//     between the walks, each stage's knee, the gain walk's input (the
//     log gain, or its exp), a member's gain (selected to exactly 1 where
//     it is absent), the product and the next member's energy, all in
//     shared memory.  Its time is one walk's plus R - 1 stages of pipeline
//     fill: at 68 x 2^17 four walks take about what one does (PERF.md).
//     The ring must hold R + 1 stages: the knee warps refill a stage's
//     slot only once walk R - 1 is done with the stage before it.
// Each kernel's time on the H100 beside its bound is in PERF.md section 6
// (chip_smoke.py): at 2^17 samples every one sits on the walker's chain,
// far above its bytes' bound, which no serial walk can reach.

#include <algorithm>
#include <cstdint>

#include "ballistics.cuh"

namespace {

using namespace grafx;

constexpr int kMaxStages = 8;
constexpr int kMinStages = 3;  // a ring of 2 would refill only the stage being walked
constexpr int kMaxSamples = 1024;
constexpr int kRingBytes = 200 * 1024;  // of the 227 KB a block may hold
constexpr int kMaxShare = 4;  // blocks a ring is sized to share an SM, where rows outnumber SMs
constexpr int kLoadArrivals = 33;  // a stage's load: the bulk copy's lane, then each lane's cp.async
constexpr int kKneeThreads = 256;
constexpr int kKneeWarps = 4;  // pair_kernel's knee warps (the first also moves the row)
constexpr int kPairThreads = 32 * (2 + kKneeWarps);
constexpr int kChainKneeWarps = 8;  // chain_kernel's (after a walker warp for each of its walks)
constexpr int kChainThreads = 32 * (kChainWalks + kChainKneeWarps);

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// arrives once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait of more
// than ~2^35 cycles (~17 s) can only be a fault: it traps, so that the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk stores but the last committed group have read shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_last() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// orders this thread's shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_shared_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ int aligned_run(const float* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 ? (n & ~3) : 0;
}

// Starts the copy of n samples of the block's row, src -> shared dst
// (16-byte aligned), completing on bar, by the 32 lanes of one warp: lane
// 0 the 16-byte aligned run by one bulk copy, an unaligned row or the
// ragged tail by 4-byte cp.async over the lanes.  bar takes
// kLoadArrivals: lane 0's (with the bulk copy's bytes) and one per lane
// once its cp.async copies have landed.
__device__ __forceinline__ void load_row(float* dst, const float* src, int n, uint64_t* bar,
                                         int lane) {
  const int bulk = aligned_run(src, n);
  if (lane == 0) {
    if (bulk > 0) {
      mbar_arrive_tx(bar, 4u * bulk);
      bulk_load(dst, src, 4u * bulk, bar);
    } else {
      mbar_arrive(bar);
    }
  }
  for (int j = bulk + lane; j < n; j += 32) cp_async4(dst + j, src + j);
  mbar_arrive_cp_async(bar);
}

// Starts the store of n samples of the block's row, shared src -> dst, by
// the 32 lanes of one warp: lane 0 the 16-byte aligned run by one bulk
// store (into its open bulk group), the rest by plain stores over the
// lanes.
__device__ __forceinline__ void store_row(float* dst, const float* src, int n, int lane) {
  const int bulk = aligned_run(dst, n);
  if (lane == 0 && bulk > 0) bulk_store(dst, src, 4u * bulk);
  for (int j = bulk + lane; j < n; j += 32) dst[j] = src[j];
}

// y = the walk over n samples from state s into dst (which may be src);
// returns the last state.  Four samples are read as a float4 and written
// back as one; the next four are read before this four's results are
// written (src may be dst, so the compiler would not move the read), so
// the read's latency hides behind the chain.  The last read of a stage
// lands in its buffer's 4 padding floats.
__device__ __forceinline__ float walk_stage(const float* src, float* dst, int n, float s,
                                            float at, float rt) {
  const float oma = 1.0f - at, omr = 1.0f - rt;
  auto four = [&](float4 u, int j) {
    float4 y;
    y.x = s = walk_step(u.x, s, at, oma, rt, omr);
    y.y = s = walk_step(u.y, s, at, oma, rt, omr);
    y.z = s = walk_step(u.z, s, at, oma, rt, omr);
    y.w = s = walk_step(u.w, s, at, oma, rt, omr);
    *reinterpret_cast<float4*>(dst + j) = y;
  };
  const int n4 = n & ~3;
  float4 u0 = *reinterpret_cast<const float4*>(src);
  int j = 0;
  for (; j + 8 <= n4; j += 8) {  // two registers in turn: no copies between them
    const float4 u1 = *reinterpret_cast<const float4*>(src + j + 4);
    four(u0, j);
    u0 = *reinterpret_cast<const float4*>(src + j + 8);
    four(u1, j + 4);
  }
  if (j < n4) {
    four(u0, j);
    j += 4;
  }
  for (; j < n; ++j) dst[j] = s = walk_step(src[j], s, at, oma, rt, omr);  // the ragged tail
  return s;
}

// The ring of a block: S stages of nbuf buffers of T + 4 floats.
struct Ring {
  float* base;
  int samples, stages, nbuf;
  long long len;

  __device__ float* buf(int slot, int b) const {
    return base + (slot * nbuf + b) * (samples + 4);
  }
  // the samples of stage k (T, or fewer in the last)
  __device__ int count(int k) const {
    return (int)min((long long)samples, len - (long long)k * samples);
  }
  __device__ int count_stages() const { return (int)((len + samples - 1) / samples); }
};

// A stage's slot in the ring and the parity of its mbarriers' phase.
struct Cursor {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Stage k of the row x into buffer 0 of slot, by the copy warp.
__device__ __forceinline__ void load_stage(const Ring& ring, uint64_t* full, const float* x,
                                           int lane, int k, int slot) {
  load_row(ring.buf(slot, 0), x + (long long)k * ring.samples, ring.count(k), &full[slot], lane);
}

// ---------------------------------------------------------------------------
// The walk (#7, #8; the walks of #2 and #5)
// ---------------------------------------------------------------------------

// y = the ballistics walk over x from zi (or init where zi is null), with
// per-row smoothing at, rt; a block a row.  y may be x.  With RES, also
// d[n] = x[n] - y[n-1] and, where last is not null, last = y[L-1].
// Thread 0 walks; warp 1 moves the row and, with RES, computes d.
// Buffers: 0 x (y in place without RES; d with RES); 1 y with RES.
template <bool RES>
__global__ void __launch_bounds__(64) walk_kernel(const float* x, float* y, float* d,
                                                  float* __restrict__ last,
                                                  const float* __restrict__ zi, float init,
                                                  const float* __restrict__ at_,
                                                  const float* __restrict__ rt_, long long len,
                                                  int T, int S) {
  extern __shared__ __align__(16) float ring_smem[];
  __shared__ uint64_t full[kMaxStages], walked[kMaxStages];
  __shared__ float enter[kMaxStages];  // the state entering each stage
  constexpr int kY = RES ? 1 : 0;
  const Ring ring{ring_smem, T, S, RES ? 2 : 1, len};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const long long row_off = (long long)row * len;
  const int stages = ring.count_stages();

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], kLoadArrivals);
      mbar_init(&walked[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Cursor at_k;
  if (warp == 0) {  // the walker
    if (lane != 0) return;
    const float at = at_[row], rt = rt_[row];
    float s = zi != nullptr ? zi[row] : init;
    for (int k = 0; k < stages; ++k, at_k.next(S)) {
      mbar_wait(&full[at_k.slot], at_k.phase);
      if (RES) enter[at_k.slot] = s;
      s = walk_stage(ring.buf(at_k.slot, 0), ring.buf(at_k.slot, kY), ring.count(k), s, at, rt);
      fence_shared_to_bulk();
      mbar_arrive(&walked[at_k.slot]);
    }
    if (RES && last != nullptr) last[row] = s;
    return;
  }
  // the copy warp
  for (int k = 0; k < min(S, stages); ++k) load_stage(ring, full, x + row_off, lane, k, k);
  for (int k = 0; k < stages; ++k, at_k.next(S)) {
    const int slot = at_k.slot, m = ring.count(k);
    mbar_wait(&walked[slot], at_k.phase);
    if (RES) {  // d[j] = u[j] - y[j-1] in place of u, rounded as the walk's u - s
      float* ub = ring.buf(slot, 0);
      const float* yb = ring.buf(slot, kY);
      for (int j = lane; j < m; j += 32) ub[j] = ub[j] - (j > 0 ? yb[j - 1] : enter[slot]);
      fence_shared_to_bulk();
      __syncwarp();
    }
    const long long t0 = row_off + (long long)k * T;
    store_row(y + t0, ring.buf(slot, kY), m, lane);
    if (RES) store_row(d + t0, ring.buf(slot, 0), m, lane);
    bulk_commit();
    // refill the slot stage k - 1 used, once its stores have read it
    if (k >= 1 && k - 1 + S < stages) {
      bulk_wait_read_all_but_last();
      __syncwarp();  // and every lane's plain stores
      load_stage(ring, full, x + row_off, lane, k - 1 + S, slot == 0 ? S - 1 : slot - 1);
    }
  }
  bulk_wait_all();
}

// y = knee(y) in place.
__global__ void __launch_bounds__(kKneeThreads)
knee_kernel(float* __restrict__ y, const float* __restrict__ th, const float* __restrict__ cf,
            const float* __restrict__ hk, int kind, long long len) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kKneeThreads + threadIdx.x;
  if (t >= len) return;
  const long long i = row * len + t;
  y[i] = knee_gain(y[i], th[row], cf[row], hk[row], kind);
}

// ---------------------------------------------------------------------------
// The pair (#1, #3)
// ---------------------------------------------------------------------------

// gain = ga * gb over u, a block a row; with RES also d_a, d_b and the
// final states.  Thread 0 walks member a, thread 32 member b, warps 2..
// compute the knees (and with RES the residuals) and the first of them
// moves the row.  Buffers: U (0): u, then ec = ga^2 u, which b walks (in
// place without RES; with RES into B, and U becomes d_b); V (1): a's
// envelope v (without RES then ga, then the gain); with RES also G (2):
// ga, then the gain; B (3): b's envelope u2; DA (4): d_a.
template <bool RES>
__global__ void __launch_bounds__(kPairThreads)
pair_kernel(const float* __restrict__ u, float* __restrict__ gain, float* __restrict__ d_a,
            float* __restrict__ d_b, float* __restrict__ v_last, float* __restrict__ u_last,
            const float* __restrict__ c, int n, long long len, int kind_a, int kind_b,
            float init_a, float init_b, int T, int S) {
  extern __shared__ __align__(16) float ring_smem[];
  __shared__ uint64_t full[kMaxStages], awalked[kMaxStages], kneed[kMaxStages],
      bwalked[kMaxStages];
  __shared__ float enter[2][kMaxStages];  // a's and b's states entering each stage
  constexpr int kU = 0, kV = 1, kG = RES ? 2 : 1, kB = RES ? 3 : 0, kDA = 4;
  const Ring ring{ring_smem, T, S, RES ? 5 : 2, len};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const long long row_off = (long long)row * len;
  const int stages = ring.count_stages();

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], kLoadArrivals);
      mbar_init(&awalked[i], 1);
      mbar_init(&kneed[i], 32 * kKneeWarps);
      mbar_init(&bwalked[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 2) {  // the walkers: a walks U into V; b walks ec (U) into B
    if (lane != 0) return;
    const bool b = warp == 1;
    const float at = c[(b ? 5 : 0) * n + row], rt = c[(b ? 6 : 1) * n + row];
    float s = b ? init_b : init_a;
    Cursor at_k;
    for (int k = 0; k < stages; ++k, at_k.next(S)) {
      const int slot = at_k.slot;
      mbar_wait(b ? &kneed[slot] : &full[slot], at_k.phase);
      if (RES) enter[b][slot] = s;
      s = walk_stage(ring.buf(slot, kU), ring.buf(slot, b ? kB : kV), ring.count(k), s, at, rt);
      fence_shared_to_bulk();
      mbar_arrive(b ? &bwalked[slot] : &awalked[slot]);
    }
    if (RES) (b ? u_last : v_last)[row] = s;
    return;
  }

  // the knee warps
  const int t = threadIdx.x - 64;
  const bool mover = warp == 2;
  const float th_a = c[2 * n + row], cf_a = c[3 * n + row], hk_a = c[4 * n + row];
  const float th_b = c[7 * n + row], cf_b = c[8 * n + row], hk_b = c[9 * n + row];
  if (mover) {
    for (int k = 0; k < min(S, stages); ++k) load_stage(ring, full, u + row_off, lane, k, k);
  }
  Cursor ka, kb;  // member a's knee at stage k, member b's at stage k - 1
  for (int k = 0; k <= stages; ++k) {
    if (k < stages) {  // member a's knee on stage k: ga, ec for member b, and d_a
      mbar_wait(&awalked[ka.slot], ka.phase);
      const int m = ring.count(k);
      float* ub = ring.buf(ka.slot, kU);
      const float* vb = ring.buf(ka.slot, kV);
      float* gb = ring.buf(ka.slot, kG);
      for (int j = t; j < m; j += 32 * kKneeWarps) {
        const float v = vb[j], x = ub[j];
        if (RES) ring.buf(ka.slot, kDA)[j] = x - (j > 0 ? vb[j - 1] : enter[0][ka.slot]);
        const float ga = knee_gain(v, th_a, cf_a, hk_a, kind_a);
        gb[j] = ga;
        ub[j] = ga * ga * x;
      }
      mbar_arrive(&kneed[ka.slot]);
      ka.next(S);
    }
    if (k >= 1) {  // member b's knee on stage k - 1, the gain and d_b, then the stores
      const int k1 = k - 1, slot = kb.slot;
      mbar_wait(&bwalked[slot], kb.phase);
      const int m = ring.count(k1);
      float* ub = ring.buf(slot, kU);
      const float* bb = ring.buf(slot, kB);
      float* gb = ring.buf(slot, kG);
      for (int j = t; j < m; j += 32 * kKneeWarps) {
        const float g = knee_gain(bb[j], th_b, cf_b, hk_b, kind_b);
        if (RES) ub[j] = ub[j] - (j > 0 ? bb[j - 1] : enter[1][slot]);
        gb[j] = gb[j] * g;
      }
      fence_shared_to_bulk();
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kKneeWarps) : "memory");
      if (mover) {
        const long long t0 = row_off + (long long)k1 * T;
        store_row(gain + t0, ring.buf(slot, kG), m, lane);
        if (RES) {
          store_row(d_a + t0, ring.buf(slot, kDA), m, lane);
          store_row(d_b + t0, ring.buf(slot, kU), m, lane);
        }
        bulk_commit();
        // refill the slot stage k - 2 used, once its stores have read it
        if (k1 >= 1 && k1 - 1 + S < stages) {
          bulk_wait_read_all_but_last();
          __syncwarp();  // and every lane's plain stores
          load_stage(ring, full, u + row_off, lane, k1 - 1 + S, slot == 0 ? S - 1 : slot - 1);
        }
      }
      kb.next(S);
    }
  }
  if (mover) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// The dynamics chain (the port's own kernel)
// ---------------------------------------------------------------------------

// The chain over u, a block a row: walker warp r (lane 0) walks recursion
// r a stage behind walker r - 1; the knee warps compute, between the
// walks, each stage's knee, gain walk input, member gain, product and
// next member's energy in shared memory; the first knee warp also moves
// the row.  gain = the product; last (R, n) = each walk's final state
// where not null; with RES d (R, n, len) = each walk's residual.  c: (8 M,
// n) member constants (ops/ballistics.py:CHAIN_ROWS); zi: (R, n).
// Buffers: U (0) u; P (1) each walk's output; Q the next walk's input (P
// itself without RES: every walk after the first runs in place; with RES
// buffer 2, so that the knee warps still see a walk's input for its
// residual); G the gain.  With RES the knee warps store each residual to
// d as they compute it (coalesced plain stores), so that the ring holds
// four arrays a stage (kept there for the copy warp's bulk stores, the
// four residuals would make it eight, and leave six stages at T = 1024).
template <bool RES>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const float* __restrict__ u, float* __restrict__ gain, float* __restrict__ d,
             float* __restrict__ last, const float* __restrict__ c,
             const float* __restrict__ zi, int n, long long len, int code, int T, int S) {
  extern __shared__ __align__(16) float ring_smem[];
  __shared__ uint64_t full[kMaxStages], walked[kChainWalks][kMaxStages],
      kneed[kChainWalks - 1][kMaxStages];
  __shared__ float enter[kChainWalks][kMaxStages];  // each walk's state entering each stage
  constexpr int kU = 0, kP = 1, kQ = RES ? 2 : 1, kG = RES ? 3 : 2;
  const ChainSpec spec(code);
  const int R = spec.walks;
  const Ring ring{ring_smem, T, S, RES ? 4 : 3, len};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const long long row_off = (long long)row * len;
  const int stages = ring.count_stages();

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], kLoadArrivals);
      for (int r = 0; r < kChainWalks; ++r) mbar_init(&walked[r][i], 1);
      for (int r = 0; r + 1 < kChainWalks; ++r) mbar_init(&kneed[r][i], 32 * kChainKneeWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < kChainWalks) {  // the walkers: r walks U (r = 0) or Q into P
    const int r = warp;
    if (lane != 0 || r >= R) return;
    const int m = spec.wm[r];
    const float* cm = c + (long long)(8 * m + (spec.wg[r] ? 5 : 0)) * n;
    const float at = cm[row], rt = cm[n + row];
    float s = zi[(long long)r * n + row];
    Cursor at_k;
    for (int k = 0; k < stages; ++k, at_k.next(S)) {
      const int slot = at_k.slot;
      mbar_wait(r == 0 ? &full[slot] : &kneed[r - 1][slot], at_k.phase);
      if (RES) enter[r][slot] = s;
      s = walk_stage(ring.buf(slot, r == 0 ? kU : kQ), ring.buf(slot, kP), ring.count(k), s, at,
                     rt);
      fence_shared_to_bulk();
      mbar_arrive(&walked[r][slot]);
    }
    if (last != nullptr) last[(long long)r * n + row] = s;
    return;
  }

  // the knee warps
  const int t = threadIdx.x - 32 * kChainWalks;
  const bool mover = warp == kChainWalks;
  float th[2] = {}, cf[2] = {}, hk[2] = {};
  bool present[2] = {};
  for (int i = 0; i < spec.members; ++i) {
    const float* cm = c + (long long)8 * i * n + row;
    th[i] = cm[2 * n];
    cf[i] = cm[3 * n];
    hk[i] = cm[4 * n];
    present[i] = cm[7 * n] > 0.5f;
  }
  if (mover) {
    for (int k = 0; k < min(S, stages); ++k) load_stage(ring, full, u + row_off, lane, k, k);
  }
  Cursor at_r[kChainWalks];  // step r's cursor, at stage k - r
  for (int k = 0; k < stages + R - 1; ++k) {
    for (int r = 0; r < R; ++r) {
      const int kr = k - r;
      if (kr < 0 || kr >= stages) continue;
      const int slot = at_r[r].slot;
      mbar_wait(&walked[r][slot], at_r[r].phase);
      const int mcount = ring.count(kr);
      const int i = spec.wm[r], kind = spec.kind[i], smooth = spec.smooth[i];
      const bool gain_walk = spec.wg[r], last_walk = r + 1 == R;
      const float* ub = ring.buf(slot, kU);
      const float* pb = ring.buf(slot, kP);
      const float* xb = ring.buf(slot, r == 0 ? kU : kQ);  // the walk's input
      float* qb = ring.buf(slot, kQ);
      float* gb = ring.buf(slot, kG);
      float* dr = RES ? d + ((long long)r * n + row) * len + (long long)kr * T : nullptr;
      for (int j = t; j < mcount; j += 32 * kChainKneeWarps) {
        const float y = pb[j];
        if (RES) dr[j] = xb[j] - (j > 0 ? pb[j - 1] : enter[r][slot]);
        float g;
        if (!gain_walk) {
          const float lg = cf[i] * knee_f(logf(y + kEps) - th[i], hk[i], kind);
          if (smooth != 0) {  // the member's gain walk's input
            qb[j] = smooth == 2 ? lg : expf(lg);
            continue;
          }
          g = expf(lg);
        } else {
          g = smooth == 2 ? expf(y) : y;
        }
        g = present[i] ? g : 1.0f;
        const float prod = i == 0 ? g : gb[j] * g;
        gb[j] = prod;
        if (i + 1 < spec.members) qb[j] = prod * prod * ub[j];  // the next member's energy
      }
      at_r[r].next(S);
      if (!last_walk) {
        mbar_arrive(&kneed[r][slot]);
        continue;
      }
      // the stage is done: its stores, then the refill of the slot before it
      fence_shared_to_bulk();
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kChainKneeWarps) : "memory");
      if (mover) {
        const long long t0 = row_off + (long long)kr * T;
        store_row(gain + t0, gb, mcount, lane);
        bulk_commit();
        if (kr >= 1 && kr - 1 + S < stages) {
          bulk_wait_read_all_but_last();
          __syncwarp();  // and every lane's plain stores
          load_stage(ring, full, u + row_off, lane, kr - 1 + S, slot == 0 ? S - 1 : slot - 1);
        }
      }
    }
  }
  if (mover) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The ring's stages for T samples a stage and nbuf buffers, n rows on the
// device's SMs: at most kMaxStages, within kRingBytes shared by the blocks
// each SM must hold at once (at most kMaxShare), at least kMinStages;
// 0 for a refused T.
int ring_stages(int T, int nbuf, int n, int device) {
  if (T < 32 || T > kMaxSamples || T % 32 != 0) return 0;
  int sms = 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  const int share = std::min(kMaxShare, std::max(1, (n + sms - 1) / sms));
  const long long stage = (long long)(T + 4) * 4 * nbuf;
  const long long S = std::min<long long>(kMaxStages, kRingBytes / share / stage);
  return (int)std::max<long long>(kMinStages, S);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool RES>
cudaError_t walk_launch(const float* x, float* y, float* d, float* last, const float* zi,
                        float init, const float* at, const float* rt, int n, long long len,
                        int T, int device, cudaStream_t s) {
  const int nbuf = RES ? 2 : 1;
  const int S = ring_stages(T, nbuf, n, device);
  if (S == 0) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)S * nbuf * (T + 4) * sizeof(float);
  cudaError_t err = allow_smem(walk_kernel<RES>, bytes);
  if (err != cudaSuccess) return err;
  walk_kernel<RES><<<n, 64, bytes, s>>>(x, y, d, last, zi, init, at, rt, len, T, S);
  return cudaGetLastError();
}

// d null: the primal walk; d set: with residuals (last may be null).
cudaError_t walk(const float* x, float* y, float* d, float* last, const float* zi, float init,
                 const float* at, const float* rt, int n, long long len, int T, int device,
                 cudaStream_t s) {
  return d != nullptr ? walk_launch<true>(x, y, d, last, zi, init, at, rt, n, len, T, device, s)
                      : walk_launch<false>(x, y, d, last, zi, init, at, rt, n, len, T, device, s);
}

cudaError_t knee(int kind, float* y, const float* c, int n, long long len, cudaStream_t s) {
  // c points at the member's th row of its (k, n) constants: th, cf, hk.
  const dim3 grid((unsigned)((len + kKneeThreads - 1) / kKneeThreads), n);
  knee_kernel<<<grid, kKneeThreads, 0, s>>>(y, c, c + n, c + 2 * n, kind, len);
  return cudaGetLastError();
}

bool bad_shape(int n, long long len, int kind) {
  return n > 65535 || (len + kKneeThreads - 1) / kKneeThreads > 0x7fffffffLL || kind < 0 ||
         kind > 1;
}

// The single-member gain; d / ylast null for the primal path.
int gain_fwd(const float* u, float* gain, float* d, float* ylast, const float* consts, int n,
             long long len, int kind, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = consts;
  if ((err = walk(u, gain, d, ylast, c, 0.0f, c + n, c + 2 * n, n, len, T, device, s))) {
    return (int)err;
  }
  return (int)knee(kind, gain, c + 3 * n, n, len, s);
}

// The pair; d_a, d_b, v_last, u_last all null for the primal path.
int gain_pair_fwd(const float* u, float* gain, float* d_a, float* d_b, float* v_last,
                  float* u_last, const float* consts, int n, long long len, int kind_a,
                  int kind_b, float init_a, float init_b, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind_a) || bad_shape(n, len, kind_b)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || len <= 0) return 0;
  const bool res = d_a != nullptr;
  const int nbuf = res ? 5 : 2;
  const int S = ring_stages(T, nbuf, n, device);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)S * nbuf * (T + 4) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res) {
    if ((err = allow_smem(pair_kernel<true>, bytes))) return (int)err;
    pair_kernel<true><<<n, kPairThreads, bytes, s>>>(u, gain, d_a, d_b, v_last, u_last, consts, n,
                                                    len, kind_a, kind_b, init_a, init_b, T, S);
  } else {
    if ((err = allow_smem(pair_kernel<false>, bytes))) return (int)err;
    pair_kernel<false><<<n, kPairThreads, bytes, s>>>(u, gain, nullptr, nullptr, nullptr, nullptr,
                                                     consts, n, len, kind_a, kind_b, init_a,
                                                     init_b, T, S);
  }
  return (int)cudaGetLastError();
}

// The chain; d null for the primal, last may be null.
int chain_fwd(const float* u, float* gain, float* d, float* last, const float* consts,
              const float* zi, int n, long long len, int code, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0) || !ChainSpec::valid(code)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  const ChainSpec spec(code);
  const bool res = d != nullptr;
  const int nbuf = res ? 4 : 3;
  const int fit = ring_stages(T, nbuf, n, device);
  if (fit == 0) return (int)cudaErrorInvalidValue;
  // the ring must hold a stage for each walk and one more (chain_kernel's
  // refill order), whatever the rows sharing an SM leave
  const int S = std::max(fit, spec.walks + 1);
  const size_t bytes = (size_t)S * nbuf * (T + 4) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res) {
    if ((err = allow_smem(chain_kernel<true>, bytes))) return (int)err;
    chain_kernel<true><<<n, kChainThreads, bytes, s>>>(u, gain, d, last, consts, zi, n, len, code,
                                                       T, S);
  } else {
    if ((err = allow_smem(chain_kernel<false>, bytes))) return (int)err;
    chain_kernel<false><<<n, kChainThreads, bytes, s>>>(u, gain, nullptr, last, consts, zi, n, len,
                                                        code, T, S);
  }
  return (int)cudaGetLastError();
}

// The plain walk: y from the per-row initial states zi; where d is not
// null, also its residual d[n] = u[n] - y[n-1] (y[-1] = zi).
int ballistics_fwd(const float* u, float* y, float* d, const float* consts, int n,
                   long long len, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  const float* c = consts;
  return (int)walk(u, y, d, nullptr, c, 0.0f, c + n, c + 2 * n, n, len, T, device,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays: u, gain
// and d (n, len); consts (6, n) with rows zi, at, rt, th, cf, hk; ylast
// (n,).  kind: 0 compressor, 1 noise gate.  samples: the walks' T samples
// a stage (ops/ballistics.py:walk_samples).  Returns the cudaError_t of
// the launches (0 on success; cudaErrorInvalidValue for a refused shape
// or T).
int grafx_gain_fwd(const float* u, float* gain, const float* consts, int n, long long len,
                   int kind, int samples, int device, void* stream) {
  return gain_fwd(u, gain, nullptr, nullptr, consts, n, len, kind, samples, device, stream);
}

int grafx_gain_fwd_res(const float* u, float* gain, float* d, float* ylast, const float* consts,
                       int n, long long len, int kind, int samples, int device, void* stream) {
  return gain_fwd(u, gain, d, ylast, consts, n, len, kind, samples, device, stream);
}

// consts (10, n) with rows at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b,
// cf_b, hk_b; kind_a / kind_b as above; init_a / init_b the members'
// initial envelopes (1.0 ballistics, 0.0 exact one-pole).  d_a and d_b
// are (n, len); v_last and u_last (n,).
int grafx_gain_pair_fwd(const float* u, float* gain, const float* consts, int n, long long len,
                        int kind_a, int kind_b, float init_a, float init_b, int samples,
                        int device, void* stream) {
  return gain_pair_fwd(u, gain, nullptr, nullptr, nullptr, nullptr, consts, n, len, kind_a,
                       kind_b, init_a, init_b, samples, device, stream);
}

int grafx_gain_pair_fwd_res(const float* u, float* gain, float* d_a, float* d_b, float* v_last,
                            float* u_last, const float* consts, int n, long long len, int kind_a,
                            int kind_b, float init_a, float init_b, int samples, int device,
                            void* stream) {
  return gain_pair_fwd(u, gain, d_a, d_b, v_last, u_last, consts, n, len, kind_a, kind_b, init_a,
                       init_b, samples, device, stream);
}

// The dynamics chain of ops/ballistics.py:ballistics_chain_core.  u and
// gain (n, len); d (R, n, len) or null (the primal); last (R, n) or null;
// consts (8 M, n), member i's rows at 8 i: at, rt, th, cf, hk, at_g, rt_g,
// present; zi (R, n); code: ops/ballistics.py:chain_code (R walks, M
// members).
int grafx_chain_fwd(const float* u, float* gain, float* d, float* last, const float* consts,
                    const float* zi, int n, long long len, int code, int samples, int device,
                    void* stream) {
  return chain_fwd(u, gain, d, last, consts, zi, n, len, code, samples, device, stream);
}

// u, y and d (n, len), d may be null; consts (3, n) with rows zi, at, rt.
int grafx_ballistics_fwd(const float* u, float* y, float* d, const float* consts, int n,
                         long long len, int samples, int device, void* stream) {
  return ballistics_fwd(u, y, d, consts, n, len, samples, device, stream);
}

}  // extern "C"
