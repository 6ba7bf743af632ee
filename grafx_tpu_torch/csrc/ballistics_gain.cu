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
// (_kernel_nat, :36), which computes the same function as _kernel.
// The *_res versions also write the residuals the adjoints
// (ballistics_grad.cu) need: d[n] = x[n] - y[n-1] of each walk and, for
// the gains, its final state y[L-1].  grafx_ballistics_fwd is the walk
// alone, from a per-row initial state: the envelope smoother a streamed
// compressor calls once per block, carrying y[L-1] into the next call.
// Given d, grafx_ballistics_fwd also writes the residual: the forward
// of the plain smoother under gradient (a FactorizedCompressor walks its
// 1024-sample frames with it: 128 frames, 4 tiles, per 2^17 samples).
//
// What is computed (per row, sequentially over time):
//   y[n]  = (u[n] > y[n-1]) ? (1-at) y[n-1] + at u[n] : (1-rt) y[n-1] + rt u[n]
//   gain  = exp(cf * f(log(y + 1e-5) - th)),  f = quadratic knee (_knee_f)
// and for the pair, a second walk over the gated energy ga^2 u whose gain
// multiplies the first.  An absent member has cf = 0, so its gain is
// exactly 1.
//
// Design and what bounds it.  Only the walk is serial: it cannot be split
// over time (the attack/release choice depends on the state), and the
// bench console gives it few rows (68 for the pair, 8 for the bus
// compressors), i.e. 3 and 1 warps on 3 of the card's 132 SMs.  So the
// work is cut in two kernels:
//   * walk_kernel: one thread per row walks all L samples and writes the
//     envelope (and, with residuals, d and the final state).  A warp owns
//     32 rows and stages (32 rows x 32 samples) tiles of the input through
//     a ring of kStages tiles in shared memory, filled with cp.async, so
//     that global loads run along time (coalesced) and kStages - 1 tiles
//     are in flight while the warp walks.  Per sample the serial chain is
//     one compare, one FMA and one select (~10 cycles), but on an H100 a
//     walk takes ~1 us per 32-sample tile (~60 cycles a sample): a lone
//     warp per SM is bound by issuing the tile's 64 four-byte copies and
//     stores and their shared-memory traffic, not by the chain or by
//     bandwidth.  Wider accesses or helper warps that move the tiles are
//     the next step.
//   * knee_kernel: the log / exp knee, an elementwise pass over all N x L
//     envelopes on every SM.  Inside the walk it would be the longest part
//     of each step with nothing to hide its latency.
// The pair is walk a -> knee a (also writes ga^2 u) -> walk b -> knee b
// (times ga).  The envelopes go through device memory: 8 B per sample and
// pass, well below what bounds the walk.  The plain walk
// (grafx_ballistics_fwd) is walk_kernel alone; a streamed console calls
// it on 17 and 2 rows x 4096 samples a block, 128 tiles on one warp each,
// so there the cost of moving each tile and the launch set its time.  The
// walk with residuals (grafx_ballistics_fwd given d) is walk_kernel<true>
// alone: 12 B per sample against the same issue-bound tile walk, so it
// costs what the gain forwards' walks cost; on a factorized compressor's
// 4-tile frame sequences the 8-deep ring is primed with empty commit
// groups and the launch sets the time.

#include "ballistics.cuh"

namespace {

using namespace grafx;

constexpr int kStages = 8;
constexpr int kKneeThreads = 256;

// y = the ballistics walk over x from zi (or init where zi is null), with
// per-row smoothing at, rt.  y may be x: tile k is read before it is
// written, and the ring only reads ahead.  With RES, also d[n] = x[n] -
// y[n-1] and, where last is not null, last = y[L-1].
template <bool RES>
__global__ void __launch_bounds__(kTile)
walk_kernel(const float* x, float* y, float* __restrict__ d, float* __restrict__ last,
            const float* __restrict__ zi, float init, const float* __restrict__ at_,
            const float* __restrict__ rt_, int n, long long len) {
  __shared__ Tile ring[kStages];
  __shared__ float dres[RES ? kTile : 1][kTile + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - row0);
  const int row = row0 + lane;
  const bool live = lane < rows;
  const float at = live ? at_[row] : 0.0f, rt = live ? rt_[row] : 0.0f;
  const float oma = 1.0f - at, omr = 1.0f - rt;
  float s = (live && zi != nullptr) ? zi[row] : init;

  const long long tiles = (len + kTile - 1) / kTile;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (k < tiles) fetch_tile(ring[k], x, row0, rows, len, (long long)k * kTile, lane);
    __pipeline_commit();
  }
  for (long long k = 0; k < tiles; ++k) {
    Tile& t = ring[k % kStages];
    const long long t0 = k * kTile;
    __pipeline_wait_prior(kStages - 1);  // this lane's copies of tile k landed
    __syncwarp();                        // and every other lane's
    auto step = [&](int j) {
      const float u = t[lane][j];
      if (RES) dres[lane][j] = u - s;
      s = u > s ? oma * s + at * u : omr * s + rt * u;
      t[lane][j] = s;
    };
    if (t0 + kTile <= len) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) step(j);
    } else {  // the ragged last tile: stop at L - 1, so that s is y[L-1]
      for (int j = 0; j < len - t0; ++j) step(j);
    }
    __syncwarp();
    if (t0 + lane < len) {
      for (int i = 0; i < rows; ++i) {
        const long long at_i = (row0 + i) * len + t0 + lane;
        y[at_i] = t[i][lane];
        if (RES) d[at_i] = dres[i][lane];
      }
    }
    __syncwarp();
    if (k + kStages < tiles) fetch_tile(t, x, row0, rows, len, t0 + kStages * kTile, lane);
    __pipeline_commit();
  }
  if (RES && live && last != nullptr) last[row] = s;
}

// y = mul * knee(y) in place (mul may be null).  Where e is not null,
// also e = knee(y)^2 * u: the energy a pair's second member walks over.
__global__ void __launch_bounds__(kKneeThreads)
knee_kernel(float* __restrict__ y, const float* __restrict__ th,
            const float* __restrict__ cf, const float* __restrict__ hk,
            const float* __restrict__ mul, const float* __restrict__ u,
            float* __restrict__ e, int kind, long long len) {
  const int row = blockIdx.y;
  const long long t = (long long)blockIdx.x * kKneeThreads + threadIdx.x;
  if (t >= len) return;
  const long long i = row * len + t;
  const float g = knee_gain(y[i], th[row], cf[row], hk[row], kind);
  y[i] = mul != nullptr ? mul[i] * g : g;
  if (e != nullptr) e[i] = g * g * u[i];
}

cudaError_t knee(int kind, float* y, const float* c, const float* mul,
                 const float* u, float* e, int n, long long len, cudaStream_t s) {
  // c points at the member's th row of its (k, n) constants: th, cf, hk.
  const dim3 grid((unsigned)((len + kKneeThreads - 1) / kKneeThreads), n);
  knee_kernel<<<grid, kKneeThreads, 0, s>>>(y, c, c + n, c + 2 * n, mul, u, e, kind, len);
  return cudaGetLastError();
}

// d null: the primal walk; d set: with residuals (last may be null).
cudaError_t walk(const float* x, float* y, float* d, float* last, const float* zi,
                 float init, const float* at, const float* rt, int n, long long len,
                 cudaStream_t s) {
  const int blocks = (n + kTile - 1) / kTile;
  if (d != nullptr) {
    walk_kernel<true><<<blocks, kTile, 0, s>>>(x, y, d, last, zi, init, at, rt, n, len);
  } else {
    walk_kernel<false><<<blocks, kTile, 0, s>>>(x, y, d, last, zi, init, at, rt, n, len);
  }
  return cudaGetLastError();
}

bool bad_shape(int n, long long len, int kind) {
  return n > 65535 || (len + kKneeThreads - 1) / kKneeThreads > 0x7fffffffLL ||
         kind < 0 || kind > 1;
}

// The single-member gain; d / ylast null for the primal path.
int gain_fwd(const float* u, float* gain, float* d, float* ylast, const float* consts,
             int n, long long len, int kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = consts;
  if ((err = walk(u, gain, d, ylast, c, 0.0f, c + n, c + 2 * n, n, len, s))) return (int)err;
  return (int)knee(kind, gain, c + 3 * n, nullptr, nullptr, nullptr, n, len, s);
}

// The pair; d_a, d_b, v_last, u_last all null for the primal path.
int gain_pair_fwd(const float* u, float* gain, float* scratch, float* d_a, float* d_b,
                  float* v_last, float* u_last, const float* consts, int n,
                  long long len, int kind_a, int kind_b, float init_a, float init_b,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, kind_a) || bad_shape(n, len, kind_b)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = consts;
  const float* b = consts + 5 * n;
  // scratch <- ga; gain <- ga^2 u, walked in place, then ga * gb
  if ((err = walk(u, scratch, d_a, v_last, nullptr, init_a, a, a + n, n, len, s))) return (int)err;
  if ((err = knee(kind_a, scratch, a + 2 * n, nullptr, u, gain, n, len, s))) return (int)err;
  if ((err = walk(gain, gain, d_b, u_last, nullptr, init_b, b, b + n, n, len, s))) return (int)err;
  return (int)knee(kind_b, gain, b + 2 * n, scratch, nullptr, nullptr, n, len, s);
}

// The plain walk: y from the per-row initial states zi; where d is not
// null, also its residual d[n] = u[n] - y[n-1] (y[-1] = zi).
int ballistics_fwd(const float* u, float* y, float* d, const float* consts, int n,
                   long long len, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(n, len, 0)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || len <= 0) return 0;
  const float* c = consts;
  return (int)walk(u, y, d, nullptr, c, 0.0f, c + n, c + 2 * n, n, len,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays: u, gain
// and d (n, len); consts (6, n) with rows zi, at, rt, th, cf, hk; ylast
// (n,).  kind: 0 compressor, 1 noise gate.  Returns the cudaError_t of
// the launches (0 on success).
int grafx_gain_fwd(const float* u, float* gain, const float* consts, int n,
                   long long len, int kind, int device, void* stream) {
  return gain_fwd(u, gain, nullptr, nullptr, consts, n, len, kind, device, stream);
}

int grafx_gain_fwd_res(const float* u, float* gain, float* d, float* ylast,
                       const float* consts, int n, long long len, int kind,
                       int device, void* stream) {
  return gain_fwd(u, gain, d, ylast, consts, n, len, kind, device, stream);
}

// consts (10, n) with rows at_a, rt_a, th_a, cf_a, hk_a, at_b, rt_b, th_b,
// cf_b, hk_b; kind_a / kind_b as above; init_a / init_b the members'
// initial envelopes (1.0 ballistics, 0.0 exact one-pole).  scratch, d_a
// and d_b are (n, len); v_last and u_last (n,).
int grafx_gain_pair_fwd(const float* u, float* gain, float* scratch,
                        const float* consts, int n, long long len, int kind_a,
                        int kind_b, float init_a, float init_b, int device,
                        void* stream) {
  return gain_pair_fwd(u, gain, scratch, nullptr, nullptr, nullptr, nullptr, consts, n,
                       len, kind_a, kind_b, init_a, init_b, device, stream);
}

int grafx_gain_pair_fwd_res(const float* u, float* gain, float* scratch, float* d_a,
                            float* d_b, float* v_last, float* u_last,
                            const float* consts, int n, long long len, int kind_a,
                            int kind_b, float init_a, float init_b, int device,
                            void* stream) {
  return gain_pair_fwd(u, gain, scratch, d_a, d_b, v_last, u_last, consts, n, len,
                       kind_a, kind_b, init_a, init_b, device, stream);
}

// u, y and d (n, len), d may be null; consts (3, n) with rows zi, at, rt.
int grafx_ballistics_fwd(const float* u, float* y, float* d, const float* consts, int n,
                         long long len, int device, void* stream) {
  return ballistics_fwd(u, y, d, consts, n, len, device, stream);
}

}  // extern "C"
