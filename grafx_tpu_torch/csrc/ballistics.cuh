// Shared pieces of the ballistics gain kernels (ballistics_gain.cu,
// ballistics_grad.cu): the 32 x 32 time tiles a reverse walk stages
// through shared memory, the step of every forward walk, the quadratic
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

// One step of the ballistics recursion from state s, oma = 1 - at and
// omr = 1 - rt: u > s ? oma s + at u : omr s + rt u, the arithmetic of
// every forward walk, with its roundings spelled out, so that walks in
// different kernels agree bit for bit.  The choice is a register mask
// (set) and a bitwise select (lop3): written as a conditional, the
// compiler guards one FMA with the compare's predicate, a longer chain of
// dependent latency on the H100.
__device__ __forceinline__ float walk_step(float u, float s, float at, float oma, float rt,
                                           float omr) {
  const float up = __fmaf_rn(oma, s, __fmul_rn(at, u));
  const float dn = __fmaf_rn(omr, s, __fmul_rn(rt, u));
  unsigned attack, y;  // attack: all ones where u > s
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(attack) : "f"(u), "f"(s));
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;"  // attack ? up : dn
      : "=r"(y)
      : "r"(attack), "r"(__float_as_uint(up)), "r"(__float_as_uint(dn)));
  return __uint_as_float(y);
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
