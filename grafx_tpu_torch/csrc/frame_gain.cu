// The frame-factorized compressor's gain, forward and adjoint, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded through ctypes (grafx_tpu_torch/ops/_cuda.py).
//
// The port's own kernels (#12 in PERF.md): they replace no single
// pallas_call.  Their counterpart is grafx_tpu's FactorizedCompressor gain
// (grafx_tpu/processors/dynamics.py, _FrameSmoother and the quadratic
// knee): a pooling reduction, the ballistics walk over the frame means
// (ballistics_core, #8/#9 here), concatenations, selects, the lerp back
// to the sample rate and the knee's elementwise passes, each its own pass
// over the (N, L) samples forward and again under the gradient.  Here
// the whole gain is one op (ops/ballistics.py:frame_gain_core):
//   * grafx_frame_gain_fwd  pool, frame walk, lerp, knee: three launches
//   * grafx_frame_gain_bwd  its adjoint: three launches
//
// What is computed, per row of (n, len) energy e in frames of F samples
// (frames = ceil(len / F)):
//   m[i]  = sum(e[iF : (i+1)F]) / F            (e zero past len)
//   s     = walk(m) from 1                      (the ballistics recursion)
//   v[t]  = a (1 - frac) + b frac,  t = iF + j, w = (j + 0.5) / F,
//           first = w < 0.5, frac = first ? w + 0.5 : w - 0.5,
//           (a, b) = first ? (s[i-1], s[i]) : (s[i], s[i+1]), clamped
//   gain  = exp(cf f(log(v + 1e-5) - th)),  f the compressor's quadratic
//           knee (ballistics.cuh: knee_f; th already shifted by -6)
// and, for the gain's cotangent gg, with the attack/release decisions
// c[i] = (d[i] > 0 ? at : rt), d[i] = m[i] - s[i-1], held constant:
//   base = gg gain,  g = base cf f'(x) / (v + 1e-5)
//   gs[i] = the lerp weights' sums of g over the samples that read s[i]
//   gh[i] = gs[i] + (1 - c[i+1]) gh[i+1],  dm[i] = c[i] gh[i]
//   de[t] = dm[i] / F over frame i's samples
//   dat / drt = sum of d gh over attack / release frames,
//   dth = -sum base cf f', dcf = sum base f, dhk = sum base cf df/dhk.
//
// Design and what bounds it.  The function reads the energy once and
// writes the gain once (8 bytes a sample; 71 MB, 0.021 ms at 3.35 TB/s for
// 68 x 2^17), and its adjoint reads the gain's cotangent once and writes
// the energy's once (the same).  Everything else lives at frame rate: a
// frame of 1024 samples is one value, so a row of 2^17 samples is 128.
// The serial walk runs over frames only, between two passes over the
// samples that every SM shares:
//   forward  frame_pool    block (frame, row): the frame's sum, each
//                          thread a strided slice of float4s, then a tree
//                          over the block; m = sum / F.
//            frame_walk    one warp a row: the frame walk with every
//                          forward walk's links and steps (ballistics.cuh:
//                          link_pieces, walk_step), so s is #8's walk of m
//                          bit for bit; writes s and, under gradient, d.
//            frame_expand  block (frame, row): the lerp from three frame
//                          values and the knee, float4 stores.
//   adjoint  frame_bwd_knee  block (frame, row): rebuilds v and the gain
//                          from s, forms g, and sums over the frame what
//                          reaches the previous, this and the next frame
//                          value and the knee's three terms (a tree over
//                          the block): (6, n, frames) partials.
//            frame_bwd_walk  one warp a row: gs from the partials, the
//                          reverse walk over the frames, dm / F, and the
//                          row's five sums (each lane a strided slice of
//                          frames, then a warp tree).
//            frame_bwd_spread  block (frame, row): dm / F broadcast to the
//                          frame's samples, float4 stores.
// Nothing (N, L) is saved for the adjoint: the walked envelope s and the
// residual d (n, frames) and the constants.  The per-sample passes spend
// their time on logf / expf and the IEEE divisions more than on their 8
// bytes a sample: the lerp weight (j + 0.5) / F, the knee's / (4 hk) and
// the adjoint's / (v + 1e-5); the adjoint takes its knee derivatives by
// per-row reciprocals (KneeRow).  On the H100 at 68 x 2^17 the forward
// is 2.5x its bytes' time and the adjoint ~3x (PERF.md section 6); the
// walks, a few microseconds at 128 frames, and six launches (a replay's
// ~1 us each) make up the rest.
// There are no atomics: every sum is a tree over a block or a warp in a
// fixed order, so a call is a function of its inputs.  Rows whose length
// or frame is not a multiple of 4, or whose arrays are not 16-byte
// aligned, move by scalar loads and stores on the same path.

#include <algorithm>
#include <climits>
#include <cstdint>

#include "ballistics.cuh"

namespace {

using namespace grafx;

constexpr int kThreads = 256;  // the per-sample passes' most threads a block
constexpr int kParts = 6;      // frame_bwd_knee's sums a frame: prev, self, next, th, cf, hk
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullWarp, v, o);
  return v;  // lane 0 holds the sum
}

// Sums each of K values over the block: a warp-shuffle tree in each warp,
// then one over the warps' sums; thread 0 holds the sums.  Every thread of
// the block calls it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K]) {
  __shared__ float warps[K][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) warps[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_sum(lane < nw ? warps[k][lane] : 0.0f);
  }
}

// Block (blockIdx.x, blockIdx.y) = (frame, row): the offset of the frame's
// first sample in the (n, len) array and its samples inside the row.
struct Frame {
  long long begin;
  int count;

  __device__ Frame(long long len, int frame) {
    const long long start = (long long)blockIdx.x * frame;
    begin = blockIdx.y * len + start;
    count = (int)min((long long)frame, len - start);
  }
};

// The lerp at offset j of a frame of F samples: whether j lies before the
// frame's centre and the weights of its two operands, (j + 0.5) / F
// rounded as ops/ballistics.py:frame_lerp rounds it (no FMA).
struct Lerp {
  bool first;
  float frac, omf;

  __device__ Lerp(int j, int frame) {
    const float w = __fdiv_rn(__fadd_rn((float)j, 0.5f), (float)frame);
    first = w < 0.5f;
    frac = first ? __fadd_rn(w, 0.5f) : __fsub_rn(w, 0.5f);
    omf = __fsub_rn(1.0f, frac);
  }

  // v from the previous, this and the next frame's value
  __device__ float at(float sp, float sc, float sn) const {
    const float a = first ? sp : sc, b = first ? sc : sn;
    return __fadd_rn(__fmul_rn(a, omf), __fmul_rn(b, frac));
  }
};

// A row's three frame values around frame f (clamped at the ends).
struct Around {
  float sp, sc, sn;

  __device__ Around(const float* s, int frames) {
    const float* r = s + (long long)blockIdx.y * frames;
    const int f = blockIdx.x;
    sp = r[max(f - 1, 0)];
    sc = r[f];
    sn = r[min(f + 1, frames - 1)];
  }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
frame_pool(const float* __restrict__ e, float* __restrict__ m, long long len, int frame) {
  const Frame fr(len, frame);
  const float* p = e + fr.begin;
  float acc[1] = {0.0f};
  if constexpr (kVec) {
    for (int q = threadIdx.x; 4 * q < fr.count; q += blockDim.x) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      acc[0] += (a.x + a.y) + (a.z + a.w);
    }
  } else {
    for (int j = threadIdx.x; j < fr.count; j += blockDim.x) acc[0] += p[j];
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
    m[(long long)blockIdx.y * gridDim.x + blockIdx.x] = __fdiv_rn(acc[0], (float)frame);
  }
}

// One warp a row (block), from the oriented state of zi = 1.  A round
// takes 32 links of kLink frames: lane l computes link l's pieces, the
// whole warp walks the round's links in turn from the shuffled pieces
// (every lane the same chain), lane l keeps its link's entering and end
// states and walks its inner frames by single steps, as fill_links does;
// then writes s and d = m - s[i-1].  The row's last frames mod kLink walk
// single steps.  consts: (5, n), rows at, rt first.
__global__ void __launch_bounds__(32)
frame_walk(const float* __restrict__ m, const float* __restrict__ consts, float* __restrict__ s,
           float* __restrict__ d, int n, int frames) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const WalkRow w(consts[row], consts[n + row]);
  const LinkSlopes c(w);
  const long long off = (long long)row * frames;
  const float* mr = m + off;
  float* sr = s + off;
  float* dr = d == nullptr ? nullptr : d + off;
  const int links = frames / kLink;
  float st = w.sgn;  // sgn * zi
  for (int base = 0; base < links; base += 32) {
    const int l = base + lane, in_round = min(32, links - base);
    float x[kLink], o[kLink + 1];
#pragma unroll
    for (int i = 0; i <= kLink; ++i) o[i] = 0.0f;
    if (l < links) {
#pragma unroll
      for (int i = 0; i < kLink; ++i) x[i] = mr[(long long)l * kLink + i];
      link_pieces(x, o, w, c);
    }
    float enter = 0.0f, end = 0.0f;
    for (int k = 0; k < in_round; ++k) {
      float f[kLink + 1];
#pragma unroll
      for (int i = 0; i <= kLink; ++i) f[i] = __fmaf_rn(c.c[i], st, __shfl_sync(kFullWarp, o[i], k));
      if (lane == k) enter = st;
      st = max_of<0, kLink + 1>(f);
      if (lane == k) end = st;
    }
    if (l < links) {
      float y[kLink], so = enter;
#pragma unroll
      for (int i = 0; i + 1 < kLink; ++i) {
        so = w.walk_step(x[i], so);
        y[i] = __fmul_rn(w.sgn, so);
      }
      y[kLink - 1] = __fmul_rn(w.sgn, end);
      float prev = __fmul_rn(w.sgn, enter);
#pragma unroll
      for (int i = 0; i < kLink; ++i) {
        sr[(long long)l * kLink + i] = y[i];
        if (dr != nullptr) dr[(long long)l * kLink + i] = __fsub_rn(x[i], prev);
        prev = y[i];
      }
    }
  }
  float prev = __fmul_rn(w.sgn, st);
  for (int t = links * kLink; t < frames; ++t) {  // the ragged tail, every lane; lane 0 writes
    const float x = mr[t];
    st = w.walk_step(x, st);
    const float y = __fmul_rn(w.sgn, st);
    if (lane == 0) {
      sr[t] = y;
      if (dr != nullptr) dr[t] = __fsub_rn(x, prev);
    }
    prev = y;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
frame_expand(const float* __restrict__ s, const float* __restrict__ consts,
             float* __restrict__ gain, int n, long long len, int frame) {
  const Frame fr(len, frame);
  const Around v(s, gridDim.x);
  const int row = blockIdx.y;
  const float th = consts[2 * n + row], cf = consts[3 * n + row], hk = consts[4 * n + row];
  float* g = gain + fr.begin;
  if constexpr (kVec) {
    for (int q = threadIdx.x; 4 * q < fr.count; q += blockDim.x) {
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = knee_gain(Lerp(4 * q + k, frame).at(v.sp, v.sc, v.sn), th, cf, hk, 0);
      reinterpret_cast<float4*>(g)[q] = make_float4(r[0], r[1], r[2], r[3]);
    }
  } else {
    for (int j = threadIdx.x; j < fr.count; j += blockDim.x) {
      g[j] = knee_gain(Lerp(j, frame).at(v.sp, v.sc, v.sn), th, cf, hk, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Adjoint
// ---------------------------------------------------------------------------

// A row's knee constants for the adjoint: th, cf, hk and the reciprocals
// 1 / (2 hk) and 1 / (4 hk^2), so that a sample's knee derivatives take
// products where knee_fp and knee_fhk divide (the same function, rounded
// apart by an ulp or so: the adjoint's sums are held to the plain version
// at GRAD_REL).
struct KneeRow {
  float th, cf, hk, r2, r4;

  __device__ KneeRow(const float* consts, int n, int row)
      : th(consts[2 * n + row]), cf(consts[3 * n + row]), hk(consts[4 * n + row]),
        r2(1.0f / (2.0f * hk)), r4(1.0f / (4.0f * hk * hk)) {}
};

// One sample's terms: its cotangent g split by the lerp's weights between
// the frame values it reads, and the knee's three gradient terms (the
// compressor's knee: ballistics.cuh's knee_f, knee_fp and knee_fhk).
__device__ __forceinline__ void knee_terms(float gg, const Lerp& lw, const Around& v,
                                           const KneeRow& k, float (&acc)[kParts]) {
  const float y = lw.at(v.sp, v.sc, v.sn);
  const float x = logf(y + kEps) - k.th;
  const float f = knee_f(x, k.hk, 0);
  const bool above = x > k.hk, inside = x >= -k.hk && !above;
  const float fp = above ? 1.0f : (inside ? (x + k.hk) * k.r2 : 0.0f);
  const float fhk = inside ? (x + k.hk) * (k.hk - x) * k.r4 : 0.0f;
  const float base = gg * expf(k.cf * f);  // gg * gain
  const float g = base * k.cf * fp / (y + kEps);
  const float ga = g * lw.omf, gb = g * lw.frac;  // the cotangents of a and b
  acc[0] += lw.first ? ga : 0.0f;  // a = s[i-1]
  acc[1] += lw.first ? gb : ga;    // s[i]
  acc[2] += lw.first ? 0.0f : gb;  // b = s[i+1]
  acc[3] += -base * k.cf * fp;
  acc[4] += base * f;
  acc[5] += base * k.cf * fhk;
}

// Block (frame, row): part[q][row][frame] for the kParts sums.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
frame_bwd_knee(const float* __restrict__ s, const float* __restrict__ gg,
               const float* __restrict__ consts, float* __restrict__ part, int n,
               long long len, int frame) {
  const Frame fr(len, frame);
  const Around v(s, gridDim.x);
  const int row = blockIdx.y;
  const KneeRow k(consts, n, row);
  const float* p = gg + fr.begin;
  float acc[kParts] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kVec) {
    for (int q = threadIdx.x; 4 * q < fr.count; q += blockDim.x) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      knee_terms(a.x, Lerp(4 * q, frame), v, k, acc);
      knee_terms(a.y, Lerp(4 * q + 1, frame), v, k, acc);
      knee_terms(a.z, Lerp(4 * q + 2, frame), v, k, acc);
      knee_terms(a.w, Lerp(4 * q + 3, frame), v, k, acc);
    }
  } else {
    for (int j = threadIdx.x; j < fr.count; j += blockDim.x) {
      knee_terms(p[j], Lerp(j, frame), v, k, acc);
    }
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
    const long long pn = (long long)n * gridDim.x, at = (long long)row * gridDim.x + blockIdx.x;
#pragma unroll
    for (int q = 0; q < kParts; ++q) part[q * pn + at] = acc[q];
  }
}

// One warp a row: the frames' cotangents gs from the partials (the clamped
// ends add a frame's own prev / next sums), the reverse walk in rounds of
// 32 frames from the last (every lane the same chain from the shuffled gs
// and 1 - c), dm[i] = c gh / F, and the row's sums into grads (5, n): dat,
// drt, dth, dcf, dhk.
__global__ void __launch_bounds__(32)
frame_bwd_walk(const float* __restrict__ d, const float* __restrict__ part,
               const float* __restrict__ consts, float* __restrict__ dm,
               float* __restrict__ grads, int n, int frames, int frame) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const float at = consts[row], rt = consts[n + row];
  const long long off = (long long)row * frames, pn = (long long)n * frames;
  const float* prev = part + off;
  const float* self = part + pn + off;
  const float* next = part + 2 * pn + off;
  float sum[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gh = 0.0f, a = 0.0f;  // gh after the round's frames and its factor 1 - c (0 past the end)
  for (int base = (frames - 1) / 32 * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    float gs = 0.0f, di = 0.0f, c = 0.0f;
    if (i < frames) {
      gs = self[i];
      if (i + 1 < frames) gs += prev[i + 1];
      if (i > 0) gs += next[i - 1];
      if (i == 0) gs += prev[0];
      if (i == frames - 1) gs += next[i];
      di = d[off + i];
      c = di > 0.0f ? at : rt;
#pragma unroll
      for (int q = 0; q < 3; ++q) sum[2 + q] += part[(3 + q) * pn + off + i];
    }
    const float omc = 1.0f - c;
    float mine = 0.0f;
    for (int k = 31; k >= 0; --k) {
      const float gk = __shfl_sync(kFullWarp, gs, k), ok = __shfl_sync(kFullWarp, omc, k);
      if (base + k < frames) {
        gh = __fmaf_rn(a, gh, gk);
        a = ok;
        if (lane == k) mine = gh;
      }
    }
    if (i < frames) {
      dm[off + i] = __fdiv_rn(c * mine, (float)frame);
      const float dc = di * mine;
      if (di > 0.0f) {
        sum[0] += dc;
      } else {
        sum[1] += dc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) sum[q] = warp_sum(sum[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) grads[q * n + row] = sum[q];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
frame_bwd_spread(const float* __restrict__ dm, float* __restrict__ de, long long len, int frame) {
  const Frame fr(len, frame);
  const float v = dm[(long long)blockIdx.y * gridDim.x + blockIdx.x];
  float* p = de + fr.begin;
  if constexpr (kVec) {
    const float4 q4 = make_float4(v, v, v, v);
    for (int q = threadIdx.x; 4 * q < fr.count; q += blockDim.x) reinterpret_cast<float4*>(p)[q] = q4;
  } else {
    for (int j = threadIdx.x; j < fr.count; j += blockDim.x) p[j] = v;
  }
}

// The per-sample passes' launch: (frames, n) blocks of the threads a
// frame's float4s (or samples) need, a multiple of 32 up to kThreads.
struct Grid {
  dim3 blocks;
  int threads;
  bool vec;
};

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 0 and the launch shape, or cudaErrorInvalidValue for shapes the kernels
// do not take (n and len >= 1 here).
int grid_of(int n, long long len, int frame, bool vec, Grid* g) {
  if (frame <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const long long frames = (len + frame - 1) / frame;
  if (frames > INT_MAX) return (int)cudaErrorInvalidValue;
  g->vec = vec && len % 4 == 0 && frame % 4 == 0;
  const long long per = g->vec ? frame / 4 : frame;
  g->threads = (int)std::min<long long>(kThreads, std::max<long long>(32, (per + 31) / 32 * 32));
  g->blocks = dim3((unsigned)frames, (unsigned)n);
  return 0;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays: e and
// gain (n, len); m (n, frames) scratch, s (n, frames) the walked envelope,
// d (n, frames) the walk's residual or null (the primal), frames =
// ceil(len / frame); consts (5, n) with rows at, rt, th, cf, hk.
// Returns the cudaError_t of the launches (0 on success).
int grafx_frame_gain_fwd(const float* e, float* gain, float* m, float* s, float* d,
                         const float* consts, int n, long long len, int frame, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || len == 0) return 0;
  Grid g;
  if (int bad = grid_of(n, len, frame, aligned(e) && aligned(gain), &g)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.vec) {
    frame_pool<true><<<g.blocks, g.threads, 0, st>>>(e, m, len, frame);
  } else {
    frame_pool<false><<<g.blocks, g.threads, 0, st>>>(e, m, len, frame);
  }
  if ((err = cudaGetLastError())) return (int)err;
  frame_walk<<<n, 32, 0, st>>>(m, consts, s, d, n, (int)g.blocks.x);
  if ((err = cudaGetLastError())) return (int)err;
  if (g.vec) {
    frame_expand<true><<<g.blocks, g.threads, 0, st>>>(s, consts, gain, n, len, frame);
  } else {
    frame_expand<false><<<g.blocks, g.threads, 0, st>>>(s, consts, gain, n, len, frame);
  }
  return (int)cudaGetLastError();
}

// s and d (n, frames) the forward's residuals; gg and de (n, len); consts
// (5, n) as for grafx_frame_gain_fwd; part (6, n, frames) and dm (n,
// frames) scratch; grads (5, n), written with rows dat, drt, dth, dcf, dhk.
int grafx_frame_gain_bwd(const float* s, const float* d, const float* gg, const float* consts,
                         float* de, float* part, float* dm, float* grads, int n, long long len,
                         int frame, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || len == 0) return 0;
  Grid g;
  if (int bad = grid_of(n, len, frame, aligned(gg) && aligned(de), &g)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.vec) {
    frame_bwd_knee<true><<<g.blocks, g.threads, 0, st>>>(s, gg, consts, part, n, len, frame);
  } else {
    frame_bwd_knee<false><<<g.blocks, g.threads, 0, st>>>(s, gg, consts, part, n, len, frame);
  }
  if ((err = cudaGetLastError())) return (int)err;
  frame_bwd_walk<<<n, 32, 0, st>>>(d, part, consts, dm, grads, n, (int)g.blocks.x, frame);
  if ((err = cudaGetLastError())) return (int)err;
  if (g.vec) {
    frame_bwd_spread<true><<<g.blocks, g.threads, 0, st>>>(dm, de, len, frame);
  } else {
    frame_bwd_spread<false><<<g.blocks, g.threads, 0, st>>>(dm, de, len, frame);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
