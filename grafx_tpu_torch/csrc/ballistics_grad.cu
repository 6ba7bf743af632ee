// Adjoints of the ballistics smoother, alone and fused with the
// quadratic-knee gain, for Hopper (sm_90a).  Built with nvcc into a
// shared library with a plain C interface and loaded through ctypes
// (grafx_tpu_torch/ops/_cuda.py).
//
// Replaces four Pallas TPU kernels of grafx_tpu/ops/ballistics_tpu.py:
//   * grafx_gain_bwd       <- _bwd_gain_kernel       (ballistics_tpu.py:496)
//   * grafx_gain_pair_bwd  <- _bwd_gain_pair_kernel  (ballistics_tpu.py:892)
//   * grafx_ballistics_bwd <- _bwd_fused_kernel      (ballistics_tpu.py:111)
//   * grafx_reverse_scan   <- _bwd_kernel            (ballistics_tpu.py:178)
// and holds the adjoint of the port's own dynamics chain (grafx_chain_bwd,
// for grafx_chain_fwd in ballistics_gain.cu; no Pallas counterpart).
//
// Inputs are the residuals of the forwards in ballistics_gain.cu: per
// walk d[n] = x[n] - y[n-1] and the final state y[L-1].  The envelope is
// rebuilt as y[n] = (x - d)[n+1] (y[L-1] the saved state), as the TPU
// kernels rebuild it.  With the attack/release decisions c[n] = (d[n] > 0
// ? at : rt) held constant, the walk's adjoint is the linear reverse
// recursion
//   gh[n] = g[n] + (1 - c[n+1]) gh[n+1],   du[n] = c[n] gh[n],
//   dat / drt = sum of d[n] gh[n] over attack / release samples,
//   dzi = (1 - c[0]) gh[0],
// where g is the envelope's cotangent from the knee:
//   g = gg * gain * cf * f'(x) / (y + 1e-5),  x = log(y + 1e-5) - th.
// The pair (gate a -> compressor b on the gated energy ec = ga^2 u) runs
// b's adjoint first, then a's, whose gain also reaches the output through
// ec:  base_a = gg ga gb + dec 2 ga^2 u,  du = du_walk_a + dec ga^2.
//
// Design and what bounds it.  Only the reverse recursion carries state,
// and with the decisions fixed it is linear, so it is split over time
// chunks of T samples (T a multiple of 32, picked by the wrapper from N
// and L: ops/ballistics.py:walk_chunk).  Each (row, chunk) pair is a
// virtual row; a warp stages (32 virtual rows x 32 samples) tiles of g
// and d through a cp.async ring in shared memory, lane i walking virtual
// row i's tiles from the chunk's end to its start (rwalk_kernel):
//   1. local walk: every chunk walks from gh = 0 and keeps its gh at its
//      first sample and the product of its carry factors (1 - c[m], m
//      from its second sample through the next chunk's first): (2, N, C)
//      scratch.  gh[n] = local[n] + (that product from n+1) gh entering.
//   2. carry_kernel: one warp per row composes the chunks' affine maps
//      gh_start = local + prod * gh_entering from the end (a warp scan
//      over 32 chunks at a time) into the true gh entering each chunk.
//   3. re-walk: every chunk walks again from its true entering gh with
//      the serial walk's arithmetic, writing c gh, the per-tile d gh
//      sums and dzi from chunk 0.  One chunk (C = 1) skips 1 and 2 and is
//      the whole-row walk, bit for bit.
// The split puts N x C virtual rows on the card instead of N rows (the
// console's 68 pair rows and 8 bus rows were 3 and 1 warps on 132 SMs):
// T is the shortest chunk, at least 64, whose virtual rows all fit at
// once: the card's SMs x the blocks an SM holds (grafx_walk_blocks_per_sm,
// the kernel's occupancy; on the H100 8 one-warp blocks, 25 KB of ring
// each, on 132 SMs): T = 288 for 68 x 2^17 (969 warps), 64 for 8 x 2^17
// (512 warps).  Rows of at most two such chunks walk whole (a factorized
// compressor's 128-frame calls), where the two more launches would cost
// what they save.  Lane i keeps virtual row i's offset and length in
// registers, and a tile's copies and stores take them by shuffle, so none
// waits on a memory read (read from shared memory, each of a tile's 32
// copies waited on a load: 70% more device time for a one-warp whole-row
// walk, PERF.md).  On the H100 (80GB HBM3, 700 W) the chunked walk is then
// within 2x of its bytes at 68 x 2^17: grafx_ballistics_bwd's passes take
// 0.090 ms busy on the card
// against the 0.053 ms that the local walk's 8 and the re-walk's 12 bytes
// a sample take at 3.35 TB/s; at 8 x 2^17 the launches and the carry's 64
// warp-scan steps a row set its time (PERF.md, chip_smoke.py).
// Everything else is elementwise over all N x L samples on every SM:
// rebuilding the envelopes (and for the pair ga, ec, u2, gb), the knee
// and its derivatives, the cotangents, base_a, and the final du.
// Per-row parameter sums over time are never one running float sum: each
// 32-sample tile is summed (a warp-shuffle tree in the elementwise
// kernels, the walk's own 32 steps in the reverse walk; chunks start on
// tile boundaries), the tile partials go to device memory, and
// reduce_kernel sums each row's partials with a block tree.
//
// The plain smoother's adjoint (grafx_ballistics_bwd) is the same chunked
// walk fed the raw output cotangent g, then reduce_kernel: exactly
// _bwd_fused_kernel's du, dat, drt and dzi from the forward's residual d.
// Its bytes are 12 per sample (d and g in, du out); on the 4-tile frame
// sequences of a factorized compressor it walks whole rows and is bound
// by its two launches.
// The dynamics chain's adjoint (grafx_chain_bwd) is #4 grown to a run's
// every walk: elementwise passes rebuild each member's gain from the
// residuals (chain_rebuild), then member by member from the last, the
// cotangent of its gain (chain_cotangent: the other member's gain, and
// for the first of two its effect through the second's energy g^2 u),
// its gain walk's chunked reverse walk, its knee adjoint (chain_knee_bwd)
// and its energy walk's chunked reverse walk; an absent member's
// cotangent is 0, so each of its gradients is exactly 0.  At 68 x 2^17
// its four walks and seven elementwise passes take ~0.9 ms against 0.075
// of bytes (PERF.md): fusing the passes into the walks is open work.
// grafx_reverse_scan is the general first-order reverse recurrence
// gh[n] = g[n] + a[n] gh[n+1] (gh[L] = 0) with the coefficient at n itself,
// not at n + 1 as the ballistics adjoint carries it.  It is the same
// chunked walk (rwalk_kernel<., kScan = true>, carry_kernel) with the
// coefficient a read from its tile where the adjoint decides 1 - c from d:
// a chunk's map is gh at its first sample = local + (the product of its a)
// x gh entering, one FMA a sample on the chain.  Its bytes are a and g in,
// gh out (12 a sample); the local walk reads a and g once more (20 in all:
// 0.053 ms at 68 x 2^17 at 3.35 TB/s).  One chunk is the old whole-row
// walk (32 rows a warp, 68 rows on 3 of 132 SMs: 9.456 ms at 68 x 2^17 on
// the H100, PERF.md) bit for bit.

#include "ballistics.cuh"

namespace {

using namespace grafx;

constexpr int kWalkStages = 3;  // rwalk_kernel's: two tiles (g, d) a stage, 25 KB, 8 warps an SM
constexpr int kElemThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullWarp, v, o);
  return v;  // lane 0 holds the sum
}

// Writes each warp's sums of a, b, c (its 32-sample tile of one row) to
// part[(q * n + row) * tiles + tile] for q = 0, 1, 2.  Every thread of the
// block must call it.
__device__ __forceinline__ void tile_partials(float* part, int n, int row,
                                              long long len, float a, float b,
                                              float c) {
  const long long tiles = (len + kTile - 1) / kTile;
  const long long tile = ((long long)blockIdx.x * kElemThreads + threadIdx.x) / kTile;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if ((threadIdx.x & (kTile - 1)) == 0 && tile < tiles) {
    const long long pn = (long long)n * tiles;
    float* p = part + (long long)row * tiles + tile;
    p[0] = a;
    p[pn] = b;
    p[2 * pn] = c;
  }
}

// Starts the copies of the (32 x 32) tiles of g and d at offset t0 of the
// warp's 32 virtual rows: lane j copies sample t0 + j of each.  Lane i
// holds virtual row i's first sample (base) and length (clen, 0 past the
// last virtual row), and a shuffle hands them to every lane, so the 32
// copies depend on no memory read and not on each other.  Samples past a
// chunk's end are zeros.
__device__ __forceinline__ void fetch_chunk_tiles(Tile& tg, Tile& td, const float* g,
                                                  const float* d, long long base, int clen,
                                                  int t0, int lane) {
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const long long b = __shfl_sync(kFullWarp, base, i) + t0 + lane;
    if (t0 + lane < __shfl_sync(kFullWarp, clen, i)) {
      __pipeline_memcpy_async(&tg[i][lane], g + b, sizeof(float));
      __pipeline_memcpy_async(&td[i][lane], d + b, sizeof(float));
    } else {
      tg[i][lane] = 0.0f;
      td[i][lane] = 0.0f;
    }
  }
}

// The reverse recursion over the chunks of `chunk` samples of each row,
// one lane per (row, chunk) virtual row v = row * chunks + chunk, each
// walk entering its chunk with the factor 1 - c of the next chunk's first
// sample (0 after the last chunk).  carry is (2, n, chunks).
// kScan: the plain recurrence gh = g + a gh of grafx_reverse_scan, with d
// read as the coefficients a (at, rt, the sums and dzi unused): the local
// walk's product is that of the chunk's a, and the re-walk writes gh.
//   kLocal: walks from gh = 0; writes carry[0][v] = gh at the chunk's
//     first sample and carry[1][v] = the product of its carry factors.
//   else: walks from gh = carry[0][v] (0 where chunks == 1; carry may then
//     be null) and writes out[n] = c[n] gh[n] (out may be g: a tile is
//     read before it is written, and the ring only reads ahead in its own
//     chunk), each row's per-tile sums of d gh over attack / release
//     samples to part_at / part_rt [row * tiles + tile], and (1 - c[0])
//     gh[0] to dzi where dzi is not null.
// Samples past L are zeros, so gh stays 0 there.
template <bool kLocal, bool kScan>
__global__ void __launch_bounds__(kTile)
rwalk_kernel(const float* g, const float* __restrict__ d, float* out,
             const float* __restrict__ at_, const float* __restrict__ rt_,
             float* __restrict__ part_at, float* __restrict__ part_rt,
             float* __restrict__ dzi, float* __restrict__ carry, int n, long long len,
             int chunk, long long chunks) {
  __shared__ Tile gring[kWalkStages];
  __shared__ Tile dring[kWalkStages];
  const int lane = threadIdx.x;
  const long long vrows = (long long)n * chunks;
  const long long v = (long long)blockIdx.x * kTile + lane;
  const bool live = v < vrows;
  const int row = live ? (int)(v / chunks) : 0;
  const long long k = live ? v % chunks : 0;
  const long long start = k * chunk;
  const long long base = row * len + start;
  const int clen = live ? (int)min((long long)chunk, len - start) : 0;
  const float at = !kScan && live ? at_[row] : 0.0f, rt = !kScan && live ? rt_[row] : 0.0f;
  float gh = 0.0f, omc = 0.0f, prod = 1.0f;
  if (!kScan && live && k + 1 < chunks) {
    omc = 1.0f - (d[row * len + start + chunk] > 0.0f ? at : rt);
  }
  if (!kLocal && live && chunks > 1) gh = carry[v];

  const long long tiles = (len + kTile - 1) / kTile;
  const int ctiles = chunk / kTile;
  // the j-th tile walked is chunk tile (ctiles - 1 - j)
#pragma unroll
  for (int j = 0; j < kWalkStages; ++j) {
    if (j < ctiles) {
      fetch_chunk_tiles(gring[j], dring[j], g, d, base, clen, (ctiles - 1 - j) * kTile, lane);
    }
    __pipeline_commit();
  }
  for (int j = 0; j < ctiles; ++j) {
    Tile& tg = gring[j % kWalkStages];
    Tile& td = dring[j % kWalkStages];
    const int t0 = (ctiles - 1 - j) * kTile;
    __pipeline_wait_prior(kWalkStages - 1);
    __syncwarp();
    float sa = 0.0f, sr = 0.0f;
#pragma unroll
    for (int i = kTile - 1; i >= 0; --i) {
      if (kScan) {
        const float a = td[lane][i];
        gh = fmaf(a, gh, tg[lane][i]);
        if (kLocal) {
          prod *= a;
        } else {
          tg[lane][i] = gh;
        }
        continue;
      }
      const float dd = td[lane][i];
      const bool att = dd > 0.0f;
      const float c = att ? at : rt;
      gh = tg[lane][i] + omc * gh;
      if (kLocal) prod *= omc;
      omc = 1.0f - c;
      if (!kLocal) {
        const float dc = dd * gh;
        sa += att ? dc : 0.0f;
        sr += att ? 0.0f : dc;
        tg[lane][i] = c * gh;
      }
    }
    if (!kLocal) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const long long b = __shfl_sync(kFullWarp, base, i) + t0 + lane;
        if (t0 + lane < __shfl_sync(kFullWarp, clen, i)) out[b] = tg[i][lane];
      }
      if (!kScan && live && start + t0 < len) {
        const long long tile = (start + t0) / kTile;
        part_at[row * tiles + tile] = sa;
        part_rt[row * tiles + tile] = sr;
      }
    }
    __syncwarp();
    if (j + kWalkStages < ctiles) {
      fetch_chunk_tiles(tg, td, g, d, base, clen, t0 - kWalkStages * kTile, lane);
    }
    __pipeline_commit();
  }
  if (!live) return;
  if (kLocal) {
    carry[v] = gh;
    carry[vrows + v] = prod;
  } else if (!kScan && dzi != nullptr && k == 0) {
    dzi[row] = omc * gh;
  }
}

// Pass 2 of the chunked walk, one warp per row: chunk k maps the gh
// entering it from its end, x, to gh at its first sample, b[k] + a[k] x
// (carry[0] and carry[1] of the local walks).  Composes the maps from the
// last chunk back, 32 chunks at a time by a suffix scan over the warp,
// and overwrites b[k] with the true gh entering chunk k (0 for the last).
__global__ void __launch_bounds__(kTile)
carry_kernel(float* __restrict__ carry, int n, long long chunks) {
  const int lane = threadIdx.x;
  float* b = carry + (long long)blockIdx.x * chunks;
  const float* a = carry + ((long long)n + blockIdx.x) * chunks;
  float x = 0.0f;  // gh entering the current group of 32 chunks from its end
  long long k = ((chunks - 1) / kTile) * kTile + lane;
  // the identity map past the last chunk
  float bn = k < chunks ? b[k] : 0.0f, an = k < chunks ? a[k] : 1.0f;
  for (; k >= lane; k -= kTile) {
    float bk = bn, ak = an;
    if (k >= kTile) {  // the next group's maps load while this one scans
      bn = b[k - kTile];
      an = a[k - kTile];
    }
    // lane i: the composition of chunks i .. 31 of the group
#pragma unroll
    for (int o = 1; o < kTile; o <<= 1) {
      const float b2 = __shfl_down_sync(kFullWarp, bk, o), a2 = __shfl_down_sync(kFullWarp, ak, o);
      if (lane + o < kTile) {
        bk = fmaf(ak, b2, bk);
        ak *= a2;
      }
    }
    const float ghs = fmaf(ak, x, bk);  // the true gh at chunk k's first sample
    const float next = __shfl_down_sync(kFullWarp, ghs, 1);
    if (k < chunks) b[k] = lane == kTile - 1 ? x : next;
    x = __shfl_sync(kFullWarp, ghs, 0);
  }
}

// Single member, elementwise: g = the envelope cotangent (into g), and the
// tile sums of the dth, dcf, dhk terms (part: their three partial rows).
// c: (5, n) rows at, rt, th, cf, hk.
__global__ void __launch_bounds__(kElemThreads)
gain_bwd_elem(const float* __restrict__ u, const float* __restrict__ d,
              const float* __restrict__ ylast, const float* __restrict__ gg,
              const float* __restrict__ c, float* __restrict__ g,
              float* __restrict__ part, int kind, int n, long long len) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  float pth = 0.0f, pcf = 0.0f, phk = 0.0f;
  if (t < len) {
    const long long i = row * len + t;
    const float th = c[2 * n + row], cf = c[3 * n + row], hk = c[4 * n + row];
    const float y = t + 1 < len ? u[i + 1] - d[i + 1] : ylast[row];
    const float x = logf(y + kEps) - th;
    const float f = knee_f(x, hk, kind), fp = knee_fp(x, hk, kind);
    const float base = gg[i] * expf(cf * f);  // gg * gain
    g[i] = base * cf * fp / (y + kEps);
    pth = -base * cf * fp;
    pcf = base * f;
    phk = base * cf * knee_fhk(x, hk, kind);
  }
  tile_partials(part, n, row, len, pth, pcf, phk);
}

// The pair's first member's gain at sample t of a row (i = row * len + t),
// from its envelope v[t] = (u - d_a)[t+1], or v_last at the end.
__device__ __forceinline__ float gate_gain(const float* u, const float* da, float vlast,
                                           long long i, long long t, long long len,
                                           float th, float cf, float hk, int kind) {
  const float v = t + 1 < len ? u[i + 1] - da[i + 1] : vlast;
  return knee_gain(v, th, cf, hk, kind);
}

// Pair, second member, elementwise: ga, base_b = gg ga gb and the
// cotangent g2 of its envelope u2[t] = (ec - d_b)[t+1] (ec = ga^2 u), and
// the tile sums of its dth, dcf, dhk terms.  c: (10, n) constants; lasts:
// (2, n) rows v_last, u_last.
__global__ void __launch_bounds__(kElemThreads)
pair_bwd_b(const float* __restrict__ u, const float* __restrict__ da,
           const float* __restrict__ db, const float* __restrict__ lasts,
           const float* __restrict__ gg, const float* __restrict__ c,
           float* __restrict__ ga_out, float* __restrict__ base_out,
           float* __restrict__ g2_out, float* __restrict__ part, int kind_a,
           int kind_b, int n, long long len) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  float pth = 0.0f, pcf = 0.0f, phk = 0.0f;
  if (t < len) {
    const long long i = row * len + t;
    const float tha = c[2 * n + row], cfa = c[3 * n + row], hka = c[4 * n + row];
    const float thb = c[7 * n + row], cfb = c[8 * n + row], hkb = c[9 * n + row];
    const float vlast = lasts[row];
    const float ga = gate_gain(u, da, vlast, i, t, len, tha, cfa, hka, kind_a);
    float u2 = lasts[n + row];
    if (t + 1 < len) {
      const float ga1 = gate_gain(u, da, vlast, i + 1, t + 1, len, tha, cfa, hka, kind_a);
      // ec[t+1] exactly as the forward formed it (no FMA into the subtraction)
      u2 = __fmul_rn(ga1 * ga1, u[i + 1]) - db[i + 1];
    }
    const float x = logf(u2 + kEps) - thb;
    const float f = knee_f(x, hkb, kind_b), fp = knee_fp(x, hkb, kind_b);
    const float gb = expf(cfb * f);
    const float base = gg[i] * ga * gb;
    ga_out[i] = ga;
    base_out[i] = base;
    g2_out[i] = base * cfb * fp / (u2 + kEps);
    pth = -base * cfb * fp;
    pcf = base * f;
    phk = base * cfb * knee_fhk(x, hkb, kind_b);
  }
  tile_partials(part, n, row, len, pth, pcf, phk);
}

// Pair, first member, elementwise, after b's reverse walk turned g2 into
// dec (the cotangent of ec): base_a = base_b + dec 2 ga^2 u, the cotangent
// g1 of the envelope v (into base_g1, over base_b), dec ga^2 (into dec_x,
// over dec), and the tile sums of a's dth, dcf, dhk terms.
__global__ void __launch_bounds__(kElemThreads)
pair_bwd_a(const float* __restrict__ u, const float* __restrict__ da,
           const float* __restrict__ lasts, const float* __restrict__ ga_in,
           float* __restrict__ base_g1, float* __restrict__ dec_x,
           const float* __restrict__ c, float* __restrict__ part, int kind_a, int n,
           long long len) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  float pth = 0.0f, pcf = 0.0f, phk = 0.0f;
  if (t < len) {
    const long long i = row * len + t;
    const float th = c[2 * n + row], cf = c[3 * n + row], hk = c[4 * n + row];
    const float v = t + 1 < len ? u[i + 1] - da[i + 1] : lasts[row];
    const float x = logf(v + kEps) - th;
    const float f = knee_f(x, hk, kind_a), fp = knee_fp(x, hk, kind_a);
    const float ga = ga_in[i], dec = dec_x[i];
    const float base = base_g1[i] + __fmul_rn(dec * 2.0f * ga * ga, u[i]);
    base_g1[i] = base * cf * fp / (v + kEps);
    dec_x[i] = dec * ga * ga;
    pth = -base * cf * fp;
    pcf = base * f;
    phk = base * cf * knee_fhk(x, hk, kind_a);
  }
  tile_partials(part, n, row, len, pth, pcf, phk);
}

__global__ void __launch_bounds__(kElemThreads)
add_kernel(float* __restrict__ y, const float* __restrict__ x, long long size) {
  const long long i = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  if (i < size) y[i] += x[i];
}

// out[b] = the sum of part[b * tiles .. (b + 1) * tiles): each thread sums
// a strided slice, then a tree over the block.  One block per (quantity,
// row).
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out, long long tiles) {
  __shared__ float warps[kReduceThreads / 32];
  const float* p = part + blockIdx.x * tiles;
  float s = 0.0f;
  for (long long k = threadIdx.x; k < tiles; k += kReduceThreads) s += p[k];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < kReduceThreads / 32 ? warps[threadIdx.x] : 0.0f;
    s = warp_sum(s);
    if (threadIdx.x == 0) out[blockIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// The dynamics chain's adjoint (the port's own kernel)
// ---------------------------------------------------------------------------

// The chain's operands for its elementwise passes: d (R, n, len) and last
// (R, n) the forward's residuals and final states, c (8 M, n) the member
// constants, buf the reverse walks' cotangent, g[i] member i's gain and x1
// member 1's energy (scratch), part (8 M, n, tiles) the tile partials.
struct ChainArgs {
  const float *u, *d, *last, *gg, *c;
  float *du, *buf, *x1, *part;
  float* g[2];
  int n;
  long long len;
  ChainSpec spec;
};

// Member i's energy envelope at sample t of a row (k = row * len + t):
// (x - d)[t + 1] of its energy walk, its final state at the end.
__device__ __forceinline__ float chain_envelope(const ChainArgs& a, int i, int row, long long k,
                                                long long t) {
  const int r = a.spec.first[i];
  if (t + 1 >= a.len) return a.last[(long long)r * a.n + row];
  const float* x = i == 0 ? a.u : a.x1;
  return x[k + 1] - a.d[(long long)r * a.n * a.len + k + 1];
}

__device__ __forceinline__ float chain_log_gain(const ChainArgs& a, int i, int row, float e) {
  const float* cm = a.c + (long long)8 * i * a.n + row;
  return cm[3 * a.n] * knee_f(logf(e + kEps) - cm[2 * a.n], cm[4 * a.n], a.spec.kind[i]);
}

// Member i's gain g[i], rebuilt from the residuals as the forward formed
// it (and, for member 0 of two, member 1's energy x1 = g^2 u), forward
// member by member.
__global__ void __launch_bounds__(kElemThreads) chain_rebuild(ChainArgs a, int i) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  if (t >= a.len) return;
  const long long k = row * a.len + t;
  const int smooth = a.spec.smooth[i];
  float g;
  if (smooth == 0) {
    g = expf(chain_log_gain(a, i, row, chain_envelope(a, i, row, k, t)));
  } else {
    // the gain walk's output: (v - d)[t + 1], v its input
    const int r = a.spec.first[i] + 1;
    float y = a.last[(long long)r * a.n + row];
    if (t + 1 < a.len) {
      const float lg = chain_log_gain(a, i, row, chain_envelope(a, i, row, k + 1, t + 1));
      y = (smooth == 2 ? lg : expf(lg)) - a.d[(long long)r * a.n * a.len + k + 1];
    }
    g = smooth == 2 ? expf(y) : y;
  }
  g = a.c[(long long)(8 * i + 7) * a.n + row] > 0.5f ? g : 1.0f;
  a.g[i][k] = g;
  if (i == 0 && a.spec.members == 2) a.x1[k] = g * g * a.u[k];
}

// buf = the cotangent entering member i's first reverse walk: with G the
// cotangent of its gain (gg times the other member's gain, and for member
// 0 of two also dx1 2 g u through member 1's energy x1 = g^2 u, dx1 in
// buf; then du = dx1 g^2), 0 where the member is absent: G g into a log
// gain walk or without one (the cotangent of lg = log g), G into a linear
// one.
__global__ void __launch_bounds__(kElemThreads) chain_cotangent(ChainArgs a, int i) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  if (t >= a.len) return;
  const long long k = row * a.len + t;
  const float gi = a.g[i][k];
  float G = a.gg[k];
  if (a.spec.members == 2) G = G * a.g[1 - i][k];
  if (i == 0 && a.spec.members == 2) {
    const float dx1 = a.buf[k];
    G = G + dx1 * 2.0f * gi * a.u[k];
    a.du[k] = dx1 * gi * gi;
  }
  G = a.c[(long long)(8 * i + 7) * a.n + row] > 0.5f ? G : 0.0f;
  a.buf[k] = a.spec.smooth[i] == 1 ? G : G * gi;
}

// Member i's knee adjoint: from the cotangent dlg of its log gain (buf,
// times v = exp(lg) after a linear gain walk), the cotangent of its energy
// envelope (into buf) and the tile sums of its dth, dcf, dhk terms.
__global__ void __launch_bounds__(kElemThreads) chain_knee_bwd(ChainArgs a, int i) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kElemThreads + threadIdx.x;
  float pth = 0.0f, pcf = 0.0f, phk = 0.0f;
  if (t < a.len) {
    const long long k = row * a.len + t;
    const float* cm = a.c + (long long)8 * i * a.n + row;
    const float th = cm[2 * a.n], cf = cm[3 * a.n], hk = cm[4 * a.n];
    const int kind = a.spec.kind[i];
    const float e = chain_envelope(a, i, row, k, t);
    const float x = logf(e + kEps) - th;
    const float f = knee_f(x, hk, kind), fp = knee_fp(x, hk, kind);
    float dlg = a.buf[k];
    if (a.spec.smooth[i] == 1) dlg = dlg * expf(cf * f);
    a.buf[k] = dlg * cf * fp / (e + kEps);
    pth = -dlg * cf * fp;
    pcf = dlg * f;
    phk = dlg * cf * knee_fhk(x, hk, kind);
  }
  tile_partials(a.part + (long long)(8 * i + 2) * a.n * ((a.len + kTile - 1) / kTile), a.n, row,
                a.len, pth, pcf, phk);
}

bool bad_shape(int n, long long len, int kind, int chunk = kTile) {
  return n > 65535 || (len + kElemThreads - 1) / kElemThreads > 0x7fffffffLL ||
         kind < 0 || kind > 1 || chunk <= 0 || chunk % kTile != 0;
}

dim3 elem_grid(int n, long long len) {
  return dim3((unsigned)((len + kElemThreads - 1) / kElemThreads), n);
}

// The chunked reverse walk (rwalk_kernel, carry_kernel): chunk is a
// positive multiple of 32; carry is (2, n, ceil(len / chunk)) scratch, or
// null where one chunk covers the row.  kScan: grafx_reverse_scan's walk,
// d the coefficients.
template <bool kScan>
cudaError_t rwalk(const float* g, const float* d, float* out, const float* at,
                  const float* rt, float* part_at, float* part_rt, float* dzi, float* carry,
                  int n, long long len, int chunk, cudaStream_t s) {
  const long long tiles = (len + kTile - 1) / kTile;
  if (chunk >= len) chunk = (int)(tiles * kTile);  // one chunk walks the row's tiles only
  const long long chunks = (len + chunk - 1) / chunk;
  const long long blocks = ((long long)n * chunks + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL || (chunks > 1 && carry == nullptr)) return cudaErrorInvalidValue;
  if (chunks > 1) {
    rwalk_kernel<true, kScan><<<(unsigned)blocks, kTile, 0, s>>>(
        g, d, nullptr, at, rt, nullptr, nullptr, nullptr, carry, n, len, chunk, chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    carry_kernel<<<n, kTile, 0, s>>>(carry, n, chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  rwalk_kernel<false, kScan><<<(unsigned)blocks, kTile, 0, s>>>(
      g, d, out, at, rt, part_at, part_rt, dzi, carry, n, len, chunk, chunks);
  return cudaGetLastError();
}

cudaError_t reduce(const float* part, float* out, int quantities, int n, long long tiles,
                   cudaStream_t s) {
  reduce_kernel<<<quantities * n, kReduceThreads, 0, s>>>(part, out, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays: u, d, gg
// and du (n, len); ylast (n,); consts (5, n) with rows at, rt, th, cf, hk;
// grads (6, n), written with rows dzi, dat, drt, dth, dcf, dhk; partials
// (5, n, ceil(len / 32)) scratch; carry (2, n, ceil(len / chunk)) scratch
// (null where chunk >= len), chunk the reverse walk's chunk length, a
// positive multiple of 32.  kind: 0 compressor, 1 noise gate.
// Returns the cudaError_t of the launches (0 on success).
int grafx_gain_bwd(const float* u, const float* d, const float* ylast, const float* gg,
                   const float* consts, float* du, float* grads, float* partials,
                   float* carry, int n, long long len, int chunk, int kind, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind, chunk)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  const float* c = consts;
  // partial rows: dat, drt, dth, dcf, dhk
  gain_bwd_elem<<<elem_grid(n, len), kElemThreads, 0, s>>>(u, d, ylast, gg, c, du,
                                                           partials + 2 * pn, kind, n, len);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = rwalk<false>(du, d, du, c, c + n, partials, partials + pn, grads, carry, n, len,
                          chunk, s))) {
    return (int)err;
  }
  return (int)reduce(partials, grads + n, 5, n, tiles, s);
}

// u, d_a, d_b, gg and du (n, len); lasts (2, n) with rows v_last, u_last;
// consts (10, n) with rows at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b,
// cf_b, hk_b; scratch (2, n, len); grads (10, n), written in the order of
// consts; partials (10, n, ceil(len / 32)) scratch; carry and chunk as for
// grafx_gain_bwd, shared by the two members' walks.
int grafx_gain_pair_bwd(const float* u, const float* d_a, const float* d_b,
                        const float* lasts, const float* gg, const float* consts,
                        float* du, float* scratch, float* grads, float* partials,
                        float* carry, int n, long long len, int chunk, int kind_a,
                        int kind_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind_a, chunk) || bad_shape(n, len, kind_b)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  const float* a = consts;
  const float* b = consts + 5 * n;
  float* ga = scratch;
  float* dec = scratch + (long long)n * len;
  const dim3 grid = elem_grid(n, len);
  // du <- base_b, dec <- g2, walked in place into dec
  pair_bwd_b<<<grid, kElemThreads, 0, s>>>(u, d_a, d_b, lasts, gg, consts, ga, du, dec,
                                           partials + 7 * pn, kind_a, kind_b, n, len);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = rwalk<false>(dec, d_b, dec, b, b + n, partials + 5 * pn, partials + 6 * pn,
                          nullptr, carry, n, len, chunk, s))) {
    return (int)err;
  }
  // du <- g1, walked in place; dec <- dec ga^2, added last
  pair_bwd_a<<<grid, kElemThreads, 0, s>>>(u, d_a, lasts, ga, du, dec, consts,
                                           partials + 2 * pn, kind_a, n, len);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = rwalk<false>(du, d_a, du, a, a + n, partials, partials + pn, nullptr, carry, n,
                          len, chunk, s))) {
    return (int)err;
  }
  const long long size = (long long)n * len;
  add_kernel<<<(unsigned)((size + kElemThreads - 1) / kElemThreads), kElemThreads, 0, s>>>(
      du, dec, size);
  if ((err = cudaGetLastError())) return (int)err;
  return (int)reduce(partials, grads, 10, n, tiles, s);
}

// The plain smoother's adjoint.  d, g and du (n, len); consts (2, n) with
// rows at, rt; grads (3, n), written with rows dzi, dat, drt; partials
// (2, n, ceil(len / 32)) scratch; carry and chunk as for grafx_gain_bwd.
int grafx_ballistics_bwd(const float* d, const float* g, const float* consts, float* du,
                         float* grads, float* partials, float* carry, int n, long long len,
                         int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0, chunk)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  if ((err = rwalk<false>(g, d, du, consts, consts + n, partials, partials + pn, grads, carry,
                          n, len, chunk, s))) {
    return (int)err;
  }
  return (int)reduce(partials, grads + n, 2, n, tiles, s);
}

// *blocks: the reverse walk's one-warp blocks resident at once on one SM
// of the device (the fewer of its two passes'), by which the wrapper
// picks the chunk length (ops/ballistics.py:walk_slots).
int grafx_walk_blocks_per_sm(int* blocks, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int local = 0, rewalk = 0, scan_local = 0, scan_rewalk = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&local, rwalk_kernel<true, false>,
                                                           kTile, 0)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&rewalk, rwalk_kernel<false, false>,
                                                           kTile, 0)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scan_local, rwalk_kernel<true, true>,
                                                           kTile, 0)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scan_rewalk,
                                                           rwalk_kernel<false, true>, kTile, 0))) {
    return (int)err;
  }
  *blocks = min(min(local, rewalk), min(scan_local, scan_rewalk));
  return 0;
}

// gh[n] = g[n] + a[n] gh[n+1], gh[L] = 0; a, g and gh (n, len); carry and
// chunk as for grafx_gain_bwd.
int grafx_reverse_scan(const float* a, const float* g, float* gh, float* carry, int n,
                       long long len, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0, chunk)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  return (int)rwalk<true>(g, a, gh, nullptr, nullptr, nullptr, nullptr, nullptr, carry, n, len,
                          chunk, static_cast<cudaStream_t>(stream));
}

// The dynamics chain's adjoint (ops/ballistics.py:ballistics_chain_bwd).
// u, gg and du (n, len); d (R, n, len) and last (R, n) the residuals and
// final states of grafx_chain_fwd; consts (8 M, n) as there; grads (8 M +
// R, n), written with the rows of consts (0 for present and an unsmoothed
// gain's), then each walk's dzi; scratch (2 M, n, len); partials (8 M, n,
// ceil(len / 32)); carry and chunk as for grafx_gain_bwd, shared by the
// walks; code: ops/ballistics.py:chain_code.
int grafx_chain_bwd(const float* u, const float* d, const float* last, const float* gg,
                    const float* consts, float* du, float* grads, float* scratch,
                    float* partials, float* carry, int n, long long len, int chunk, int code,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0, chunk) || !ChainSpec::valid(code)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ChainSpec spec(code);
  const int M = spec.members, R = spec.walks;
  const long long nl = (long long)n * len;
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  ChainArgs a{u, d, last, gg, consts, du, scratch, M == 2 ? scratch + 3 * nl : nullptr, partials,
              {scratch + nl, M == 2 ? scratch + 2 * nl : nullptr}, n, len, spec};
  const dim3 grid = elem_grid(n, len);
  if ((err = cudaMemsetAsync(grads, 0, sizeof(float) * (8 * M + R) * n, s))) return (int)err;
  for (int i = 0; i < M; ++i) {
    chain_rebuild<<<grid, kElemThreads, 0, s>>>(a, i);
    if ((err = cudaGetLastError())) return (int)err;
  }
  for (int i = M - 1; i >= 0; --i) {
    const int r = spec.first[i];
    const float* c = consts + (long long)8 * i * n;
    float* part = partials + 8 * i * pn;
    float* dzi = grads + (long long)(8 * M + r) * n;
    chain_cotangent<<<grid, kElemThreads, 0, s>>>(a, i);
    if ((err = cudaGetLastError())) return (int)err;
    if (spec.smooth[i] != 0 &&
        (err = rwalk<false>(scratch, d + (r + 1) * nl, scratch, c + 5 * n, c + 6 * n, part + 5 * pn,
                            part + 6 * pn, dzi + n, carry, n, len, chunk, s))) {
      return (int)err;
    }
    chain_knee_bwd<<<grid, kElemThreads, 0, s>>>(a, i);
    if ((err = cudaGetLastError())) return (int)err;
    if ((err = rwalk<false>(scratch, d + r * nl, M == 1 ? du : scratch, c, c + n, part, part + pn,
                            dzi, carry, n, len, chunk, s))) {
      return (int)err;
    }
  }
  if (M == 2) {
    add_kernel<<<(unsigned)((nl + kElemThreads - 1) / kElemThreads), kElemThreads, 0, s>>>(
        du, scratch, nl);
    if ((err = cudaGetLastError())) return (int)err;
  }
  for (int i = 0; i < M; ++i) {
    if ((err = reduce(partials + 8 * i * pn, grads + (long long)8 * i * n,
                      spec.smooth[i] != 0 ? 7 : 5, n, tiles, s))) {
      return (int)err;
    }
  }
  return 0;
}

}  // extern "C"
