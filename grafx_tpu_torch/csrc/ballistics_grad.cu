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
// Design and what bounds it.  Only the reverse recursion carries state.
// It runs as rwalk_kernel, the mirror of the forward walk: one thread per
// row, a warp staging (32 rows x 32 samples) tiles of g and d through a
// cp.async ring in shared memory, walking tiles from the end of time to
// the start; like the forward walk it is bound by issuing the tile copies
// and stores of a lone warp per SM (3 warps for the console's 68 pair
// rows, 1 for its 8 bus rows).  Everything else is elementwise over all
// N x L samples on every SM: rebuilding the envelopes (and for the pair
// ga, ec, u2, gb), the knee and its derivatives, the cotangents, base_a,
// and the final du.  Per-row parameter sums over time are never one
// running float sum: each 32-sample tile is summed (a warp-shuffle tree
// in the elementwise kernels, the walk's own 32 steps in the reverse
// walk), the tile partials go to device memory, and reduce_kernel sums
// each row's partials with a block tree.  Splitting the linear reverse
// walk over time chunks (it is a linear recurrence, unlike the forward)
// is the next step.
//
// The plain smoother's adjoint (grafx_ballistics_bwd) is rwalk_kernel fed
// the raw output cotangent g, then reduce_kernel: exactly
// _bwd_fused_kernel's du, dat, drt and dzi from the forward's residual d.
// Its bytes are 12 per sample (d and g in, du out); like the gain
// adjoints it is bound by the lone warp's tile issue, and on the 4-tile
// frame sequences of a factorized compressor by its two launches.
// grafx_reverse_scan is the general first-order reverse recurrence
// gh[n] = g[n] + a[n] gh[n+1] (gh[L] = 0) with the coefficient at n itself,
// not at n + 1 as the ballistics adjoint carries it: rscan_kernel, the
// same ring staging tiles of a and g, one FMA a sample on the chain.

#include "ballistics.cuh"

namespace {

using namespace grafx;

constexpr int kRStages = 4;  // two tiles (g and d) a stage: 33 KB of ring
constexpr int kElemThreads = 256;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
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

// out[n] = c[n] gh[n] for the reverse recursion over g (out may be g: a
// tile is read before it is written, and the ring only reads ahead).
// Writes each row's per-tile sums of d gh over attack / release samples
// to part_at / part_rt [row * tiles + tile], and (1 - c[0]) gh[0] to dzi
// where dzi is not null.  Samples past L are zeros, so gh stays 0 there.
__global__ void __launch_bounds__(kTile)
rwalk_kernel(const float* g, const float* __restrict__ d, float* out,
             const float* __restrict__ at_, const float* __restrict__ rt_,
             float* __restrict__ part_at, float* __restrict__ part_rt,
             float* __restrict__ dzi, int n, long long len) {
  __shared__ Tile gring[kRStages];
  __shared__ Tile dring[kRStages];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - row0);
  const int row = row0 + lane;
  const bool live = lane < rows;
  const float at = live ? at_[row] : 0.0f, rt = live ? rt_[row] : 0.0f;
  float gh = 0.0f, omc = 0.0f;

  const long long tiles = (len + kTile - 1) / kTile;
  // the k-th tile walked is time tile (tiles - 1 - k)
#pragma unroll
  for (int k = 0; k < kRStages; ++k) {
    if (k < tiles) {
      const long long t0 = (tiles - 1 - k) * kTile;
      fetch_tile(gring[k], g, row0, rows, len, t0, lane);
      fetch_tile(dring[k], d, row0, rows, len, t0, lane);
    }
    __pipeline_commit();
  }
  for (long long k = 0; k < tiles; ++k) {
    Tile& tg = gring[k % kRStages];
    Tile& td = dring[k % kRStages];
    const long long tile = tiles - 1 - k;
    const long long t0 = tile * kTile;
    __pipeline_wait_prior(kRStages - 1);
    __syncwarp();
    float sa = 0.0f, sr = 0.0f;
#pragma unroll
    for (int j = kTile - 1; j >= 0; --j) {
      const float dd = td[lane][j];
      const bool att = dd > 0.0f;
      const float c = att ? at : rt;
      gh = tg[lane][j] + omc * gh;
      omc = 1.0f - c;
      const float dc = dd * gh;
      sa += att ? dc : 0.0f;
      sr += att ? 0.0f : dc;
      tg[lane][j] = c * gh;
    }
    __syncwarp();
    if (t0 + lane < len) {
      for (int i = 0; i < rows; ++i) out[(row0 + i) * len + t0 + lane] = tg[i][lane];
    }
    if (live) {
      part_at[row * tiles + tile] = sa;
      part_rt[row * tiles + tile] = sr;
    }
    __syncwarp();
    if (k + kRStages < tiles) {
      const long long tn = (tile - kRStages) * kTile;
      fetch_tile(tg, g, row0, rows, len, tn, lane);
      fetch_tile(td, d, row0, rows, len, tn, lane);
    }
    __pipeline_commit();
  }
  if (dzi != nullptr && live) dzi[row] = omc * gh;
}

// gh[n] = g[n] + a[n] gh[n+1] over each row, from gh[L] = 0 (gh may be g).
// The same ring as rwalk_kernel; samples past L are zeros, so the state
// entering the last real sample is exactly 0.
__global__ void __launch_bounds__(kTile)
rscan_kernel(const float* a, const float* g, float* gh, int n, long long len) {
  __shared__ Tile aring[kRStages];
  __shared__ Tile gring[kRStages];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - row0);
  float s = 0.0f;

  const long long tiles = (len + kTile - 1) / kTile;
#pragma unroll
  for (int k = 0; k < kRStages; ++k) {
    if (k < tiles) {
      const long long t0 = (tiles - 1 - k) * kTile;
      fetch_tile(aring[k], a, row0, rows, len, t0, lane);
      fetch_tile(gring[k], g, row0, rows, len, t0, lane);
    }
    __pipeline_commit();
  }
  for (long long k = 0; k < tiles; ++k) {
    Tile& ta = aring[k % kRStages];
    Tile& tg = gring[k % kRStages];
    const long long tile = tiles - 1 - k;
    const long long t0 = tile * kTile;
    __pipeline_wait_prior(kRStages - 1);
    __syncwarp();
#pragma unroll
    for (int j = kTile - 1; j >= 0; --j) {
      s = fmaf(ta[lane][j], s, tg[lane][j]);
      tg[lane][j] = s;
    }
    __syncwarp();
    if (t0 + lane < len) {
      for (int i = 0; i < rows; ++i) gh[(row0 + i) * len + t0 + lane] = tg[i][lane];
    }
    __syncwarp();
    if (k + kRStages < tiles) {
      const long long tn = (tile - kRStages) * kTile;
      fetch_tile(ta, a, row0, rows, len, tn, lane);
      fetch_tile(tg, g, row0, rows, len, tn, lane);
    }
    __pipeline_commit();
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

bool bad_shape(int n, long long len, int kind) {
  return n > 65535 || (len + kElemThreads - 1) / kElemThreads > 0x7fffffffLL ||
         kind < 0 || kind > 1;
}

dim3 elem_grid(int n, long long len) {
  return dim3((unsigned)((len + kElemThreads - 1) / kElemThreads), n);
}

cudaError_t rwalk(const float* g, const float* d, float* out, const float* at,
                  const float* rt, float* part_at, float* part_rt, float* dzi, int n,
                  long long len, cudaStream_t s) {
  rwalk_kernel<<<(n + kTile - 1) / kTile, kTile, 0, s>>>(g, d, out, at, rt, part_at,
                                                         part_rt, dzi, n, len);
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
// (5, n, ceil(len / 32)) scratch.  kind: 0 compressor, 1 noise gate.
// Returns the cudaError_t of the launches (0 on success).
int grafx_gain_bwd(const float* u, const float* d, const float* ylast, const float* gg,
                   const float* consts, float* du, float* grads, float* partials,
                   int n, long long len, int kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  const float* c = consts;
  // partial rows: dat, drt, dth, dcf, dhk
  gain_bwd_elem<<<elem_grid(n, len), kElemThreads, 0, s>>>(u, d, ylast, gg, c, du,
                                                           partials + 2 * pn, kind, n, len);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = rwalk(du, d, du, c, c + n, partials, partials + pn, grads, n, len, s))) return (int)err;
  return (int)reduce(partials, grads + n, 5, n, tiles, s);
}

// u, d_a, d_b, gg and du (n, len); lasts (2, n) with rows v_last, u_last;
// consts (10, n) with rows at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b,
// cf_b, hk_b; scratch (2, n, len); grads (10, n), written in the order of
// consts; partials (10, n, ceil(len / 32)) scratch.
int grafx_gain_pair_bwd(const float* u, const float* d_a, const float* d_b,
                        const float* lasts, const float* gg, const float* consts,
                        float* du, float* scratch, float* grads, float* partials, int n,
                        long long len, int kind_a, int kind_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind_a) || bad_shape(n, len, kind_b)) {
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
  if ((err = rwalk(dec, d_b, dec, b, b + n, partials + 5 * pn, partials + 6 * pn, nullptr,
                   n, len, s))) return (int)err;
  // du <- g1, walked in place; dec <- dec ga^2, added last
  pair_bwd_a<<<grid, kElemThreads, 0, s>>>(u, d_a, lasts, ga, du, dec, consts,
                                           partials + 2 * pn, kind_a, n, len);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = rwalk(du, d_a, du, a, a + n, partials, partials + pn, nullptr, n, len, s))) return (int)err;
  const long long size = (long long)n * len;
  add_kernel<<<(unsigned)((size + kElemThreads - 1) / kElemThreads), kElemThreads, 0, s>>>(
      du, dec, size);
  if ((err = cudaGetLastError())) return (int)err;
  return (int)reduce(partials, grads, 10, n, tiles, s);
}

// The plain smoother's adjoint.  d, g and du (n, len); consts (2, n) with
// rows at, rt; grads (3, n), written with rows dzi, dat, drt; partials
// (2, n, ceil(len / 32)) scratch.
int grafx_ballistics_bwd(const float* d, const float* g, const float* consts, float* du,
                         float* grads, float* partials, int n, long long len, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (len + kTile - 1) / kTile;
  const long long pn = (long long)n * tiles;
  if ((err = rwalk(g, d, du, consts, consts + n, partials, partials + pn, grads, n, len, s))) {
    return (int)err;
  }
  return (int)reduce(partials, grads + n, 2, n, tiles, s);
}

// gh[n] = g[n] + a[n] gh[n+1], gh[L] = 0; a, g and gh (n, len).
int grafx_reverse_scan(const float* a, const float* g, float* gh, int n, long long len,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  rscan_kernel<<<(n + kTile - 1) / kTile, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      a, g, gh, n, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
