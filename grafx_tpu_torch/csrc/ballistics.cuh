// Shared pieces of the ballistics gain kernels (ballistics_gain.cu,
// ballistics_grad.cu): the 32 x 32 time tiles a reverse walk stages
// through shared memory, the steps and links of every forward walk, the quadratic
// knee of grafx_tpu/ops/ballistics_tpu.py (_knee_f, _knee_fp, _knee_fhk)
// and the layout of a dynamics chain (ChainSpec).
//
// kind 0: compressor (cf = 1/ratio - 1); kind 1: noise gate
// (cf = ratio - 1).  logf/expf are the accurate library versions and
// divisions are IEEE: no file including this may be built with
// --use_fast_math.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace grafx {

constexpr int kTile = 32;
constexpr float kEps = 1e-5f;
constexpr int kChainWalks = 4;  // a dynamics chain's walks at most: two members' energy and gain

using Tile = float[kTile][kTile + 1];  // +1: row and column reads hit 32 banks

// The forward walks' link: kLink samples of the serial chain a step of
// the walker (ops/ballistics.py:WALK_LINK; scripts/walk_link_sweep.py times
// builds with 1, 2, 4 and 8).  Every forward walk kernel uses this one
// constant, so that walks in different kernels agree bit for bit.
constexpr int kLink = 8;
static_assert(kLink == 1 || kLink == 2 || kLink == 4 || kLink == 8, "a link of 1, 2, 4 or 8");

// A link's kLink + 1 offsets in shared memory: its first kVec float4s
// together, then each of the kRest others in an array of its own, so that
// the walker reads them with few loads: one float4 where four scalar
// loads would queue behind each other on the memory pipe and hold up the
// chain's instructions after them.
constexpr int kVec = (kLink + 1) / 4, kRest = (kLink + 1) % 4;

// A row's walk: the smoothing factors at, rt in [0, 1], oma = 1 - at,
// omr = 1 - rt, and the row's orientation sgn.  The select step
// u > s ? oma s + at u : omr s + rt u is the max of its two pieces where
// at >= rt and their min where at < rt (they differ by (at - rt)(u - s));
// a row walks sgn u from sgn s with the max, and sgn times that walk is
// its walk (negation is exact, and so is every rounding under it).  The
// states the walkers keep, pass and store (enter, the link ends) are the
// oriented ones.
struct WalkRow {
  float at, rt, oma, omr, sgn;

  __device__ WalkRow(float at_, float rt_)
      : at(at_), rt(rt_), oma(1.0f - at_), omr(1.0f - rt_), sgn(at_ >= rt_ ? 1.0f : -1.0f) {}

  // One step of the recursion from the oriented state so over the sample
  // u: the step of every forward walk's single samples (a link's inner
  // samples, a row's ragged tail), with its roundings spelled out.  Its
  // chain is an FMA and a max (~4.5 + ~5-7 cycles on the H100); a
  // compare and a select in place of the max put a predicate and two
  // dependent instructions on it (~19 cycles a sample measured).
  __device__ __forceinline__ float walk_step(float u, float so) const {
    const float uo = __fmul_rn(sgn, u);
    return fmaxf(__fmaf_rn(oma, so, __fmul_rn(at, uo)), __fmaf_rn(omr, so, __fmul_rn(rt, uo)));
  }
};

// A link's kLink + 1 slopes, oma^i omr^(kLink - i) for i attack steps:
// each power by repeated products, then their product
// (ops/ballistics.py:_link_slopes).
struct LinkSlopes {
  float c[kLink + 1];

  __device__ explicit LinkSlopes(const WalkRow& w) {
    float pa[kLink + 1], pr[kLink + 1];
    pa[0] = pr[0] = 1.0f;
#pragma unroll
    for (int i = 1; i <= kLink; ++i) {
      pa[i] = __fmul_rn(pa[i - 1], w.oma);
      pr[i] = __fmul_rn(pr[i - 1], w.omr);
    }
#pragma unroll
    for (int i = 0; i <= kLink; ++i) c[i] = __fmul_rn(pa[i], pr[kLink - i]);
  }
};

// The kLink samples of a link at p (16-byte aligned where kLink >= 4).
__device__ __forceinline__ void load_link(const float* p, float (&v)[kLink]) {
  if constexpr (kLink == 1) {
    v[0] = p[0];
  } else if constexpr (kLink == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < kLink; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x, v[i + 1] = a.y, v[i + 2] = a.z, v[i + 3] = a.w;
    }
  }
}

__device__ __forceinline__ void store_link(float* p, const float (&v)[kLink]) {
  if constexpr (kLink == 1) {
    p[0] = v[0];
  } else if constexpr (kLink == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kLink; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

// The offsets of a link's pieces from its samples x: offset i is the
// largest over the step sequences with i attack steps, built one step at
// a time (ops/ballistics.py:_link_pieces), so that the link's walk is
// s -> max_i (c[i] s + o[i]).  A flat link (every sample v) takes o[i] =
// v - c[i] v, each rounded once, which is every sequence's offset in real
// arithmetic: then each piece maps v to v exactly (its error is below
// half an ulp of v), as the select step does, so that a walk that meets a
// constant input (a static gain of 1, a held level) stays on it instead
// of climbing by the largest of the pieces' roundings every link.
__device__ __forceinline__ void link_pieces(const float (&x)[kLink], float (&o)[kLink + 1],
                                            const WalkRow& w, const LinkSlopes& c) {
  bool flat = true;
#pragma unroll
  for (int j = 1; j < kLink; ++j) flat = flat && x[j] == x[0];
  if (flat) {
    const float v = __fmul_rn(w.sgn, x[0]);
#pragma unroll
    for (int i = 0; i <= kLink; ++i) o[i] = __fmaf_rn(-c.c[i], v, v);
    return;
  }
  float a[kLink], r[kLink];
#pragma unroll
  for (int j = 0; j < kLink; ++j) {
    const float uo = __fmul_rn(w.sgn, x[j]);
    a[j] = __fmul_rn(w.at, uo);
    r[j] = __fmul_rn(w.rt, uo);
  }
  o[0] = r[0];
  o[1] = a[0];
#pragma unroll
  for (int j = 1; j < kLink; ++j) {
    const float top = __fmaf_rn(w.oma, o[j], a[j]);  // every step an attack
#pragma unroll
    for (int i = j; i >= 1; --i) {
      o[i] = fmaxf(__fmaf_rn(w.oma, o[i - 1], a[j]), __fmaf_rn(w.omr, o[i], r[j]));
    }
    o[0] = __fmaf_rn(w.omr, o[0], r[j]);
    o[j + 1] = top;
  }
}

// max f[B..E), as a balanced tree
template <int B, int E>
__device__ __forceinline__ float max_of(const float (&f)[kLink + 1]) {
  if constexpr (E - B == 1) {
    return f[B];
  } else {
    constexpr int M = (B + E) / 2;
    return fmaxf(max_of<B, M>(f), max_of<M, E>(f));
  }
}

// The walker reads a link's offsets kAhead links before it walks it and
// stores kAhead links' end states at once.
constexpr int kAhead = 4;

// A stage's walk scratch, after its buffers in the ring: the pieces'
// offsets of its ls = T / kLink links (link l's float4s at
// P[4 kVec l], its offset 4 kVec + r at P[4 kVec ls + r ls + l]), then
// the end states of the stage's links and of its ragged tail's single
// samples, all oriented.  The spare floats take the walker's reads ahead
// past the last link.
__host__ __device__ constexpr int link_scratch(int T) {
  return ((kLink + 2) * (T / kLink) + kLink + (4 * kVec + 1) * kAhead + 3) & ~3;
}

__device__ __forceinline__ void fetch_pieces(const float* P, int ls, int l,
                                             float (&o)[kLink + 1]) {
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const float4 q = *reinterpret_cast<const float4*>(P + 4 * (kVec * l + v));
    o[4 * v] = q.x, o[4 * v + 1] = q.y, o[4 * v + 2] = q.z, o[4 * v + 3] = q.w;
  }
#pragma unroll
  for (int r = 0; r < kRest; ++r) o[4 * kVec + r] = P[(4 * kVec + r) * ls + l];
}

// The walker over a stage of n samples x (read only in the ragged tail)
// from the oriented state s and the pieces' offsets P of ls links at most:
// writes each link's end state, then each tail sample's, to e (16-byte
// aligned); returns the last.
__device__ __forceinline__ float walk_links(const float* x, const float* P, int ls, float* e,
                                            int n, float s, const LinkSlopes& c,
                                            const WalkRow& w) {
  const int links = n / kLink;
  float o[kAhead][kLink + 1];  // kAhead register sets in turn
  auto link = [&](const float(&r)[kLink + 1]) {
    float f[kLink + 1];
#pragma unroll
    for (int i = 0; i <= kLink; ++i) f[i] = __fmaf_rn(c.c[i], s, r[i]);
    return max_of<0, kLink + 1>(f);
  };
#pragma unroll
  for (int a = 0; a < kAhead; ++a) fetch_pieces(P, ls, a, o[a]);
  int l = 0;
  for (; l + kAhead <= links; l += kAhead) {
    float end[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      end[a] = s = link(o[a]);
      fetch_pieces(P, ls, l + a + kAhead, o[a]);
    }
#pragma unroll
    for (int q = 0; q < kAhead; q += 4) {
      *reinterpret_cast<float4*>(e + l + q) =
          make_float4(end[q], end[q + 1], end[q + 2], end[q + 3]);
    }
  }
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (l + a < links) e[l + a] = s = link(o[a]);
  }
  l = links;
  for (int j = links * kLink; j < n; ++j) e[l++] = s = w.walk_step(x[j], s);  // the ragged tail
  return s;
}

// Helpers, lane t of nt: each link's pieces of a stage of n samples x into
// P (ls links at most), for the walker.
__device__ __forceinline__ void stage_pieces(const float* x, float* P, int ls, int n,
                                             const WalkRow& w, int t, int nt) {
  const LinkSlopes c(w);
  for (int l = t; l < n / kLink; l += nt) {
    float v[kLink], o[kLink + 1];
    load_link(x + l * kLink, v);
    link_pieces(v, o, w, c);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      *reinterpret_cast<float4*>(P + 4 * (kVec * l + q)) =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
#pragma unroll
    for (int r = 0; r < kRest; ++r) P[(4 * kVec + r) * ls + l] = o[4 * kVec + r];
  }
}

// Helpers, lane t of nt, after the walker: the stage's walk y (not
// oriented; y may be x) from the end states e and the oriented state
// entering the stage: a link's inner samples by single steps from its
// entering state, its end and each tail sample from e.
__device__ __forceinline__ void fill_links(const float* x, float* y, const float* e, int n,
                                           float enter, const WalkRow& w, int t, int nt) {
  const int links = n / kLink, units = links + n % kLink;
  for (int q = t; q < units; q += nt) {
    float s = q == 0 ? enter : e[q - 1];
    if (q < links) {
      float v[kLink];
      load_link(x + q * kLink, v);
#pragma unroll
      for (int m = 0; m + 1 < kLink; ++m) {
        s = w.walk_step(v[m], s);
        v[m] = __fmul_rn(w.sgn, s);
      }
      v[kLink - 1] = __fmul_rn(w.sgn, e[q]);
      store_link(y + q * kLink, v);
    } else {
      y[links * kLink + (q - links)] = __fmul_rn(w.sgn, e[q]);
    }
  }
}

__device__ __forceinline__ float knee_f(float x, float hk, int kind) {
  if (kind == 0) {
    const float d = x + hk;
    const float mid = d * d / (4.0f * hk);
    return x > hk ? x : (x < -hk ? 0.0f : mid);
  }
  const float d = x - hk;
  const float mid = -(d * d) / (4.0f * hk);
  return x < -hk ? x : (x > hk ? 0.0f : mid);
}

// df/dx
__device__ __forceinline__ float knee_fp(float x, float hk, int kind) {
  if (kind == 0) {
    const float mid = (x + hk) / (2.0f * hk);
    return x > hk ? 1.0f : (x < -hk ? 0.0f : mid);
  }
  const float mid = -(x - hk) / (2.0f * hk);
  return x < -hk ? 1.0f : (x > hk ? 0.0f : mid);
}

// df/dhk, nonzero only inside the knee
__device__ __forceinline__ float knee_fhk(float x, float hk, int kind) {
  const bool inside = x >= -hk && x <= hk;
  const float mid = kind == 0 ? (x + hk) * (hk - x) / (4.0f * hk * hk)
                              : (x - hk) * (x + hk) / (4.0f * hk * hk);
  return inside ? mid : 0.0f;
}

__device__ __forceinline__ float knee_gain(float y, float th, float cf, float hk, int kind) {
  return expf(cf * knee_f(logf(y + kEps) - th, hk, kind));
}

// A dynamics chain's members and walks, from the code of
// ops/ballistics.py:chain_code.  Walk r is member wm[r]'s energy walk, or
// its gain walk where wg[r]; member i's energy walk is walk first[i], its
// gain walk (where smooth[i] != 0) the next.
struct ChainSpec {
  int members, walks;
  int kind[2], smooth[2];  // smooth: 0 none, 1 linear, 2 log
  int first[2];
  int wm[kChainWalks], wg[kChainWalks];

  __host__ __device__ explicit ChainSpec(int code) : members((code & 1) + 1), walks(0) {
    for (int i = 0; i < 2; ++i) {
      kind[i] = (code >> (1 + 3 * i)) & 1;
      smooth[i] = (code >> (2 + 3 * i)) & 3;
    }
    for (int i = 0; i < members; ++i) {
      first[i] = walks;
      for (int g = 0; g <= (smooth[i] != 0); ++g) {
        wm[walks] = i;
        wg[walks++] = g;
      }
    }
  }

  // a code ops/ballistics.py:chain_code can give
  __host__ __device__ static bool valid(int code) {
    if (code < 0 || code >= 128) return false;
    for (int i = 0; i <= (code & 1); ++i) {
      if (((code >> (2 + 3 * i)) & 3) == 3) return false;
    }
    return true;
  }
};

}  // namespace grafx
