// Shared pieces of the two LJ cell sweeps (lj_cells.cu, lj_half.cu): the
// packing pass, the window filter, the culling test and the pair body.
//
// Packing (lj_pack, one warp per 32-slot tile of every cell of the grid):
// the planes' x, y, z and element rows become one float4 per slot,
// Q [cells, T * 32] with T = ceil(C / 32) and the slots past C padded,
// and each 16-slot group gets the box of its live slots from this call's
// positions, B [cells, T, 2, 2] = (lo, hi): lo = (min x, min y, min z,
// min element), hi the maxima.  Pad slots (x >= kPadMin: the planes park
// them at 1e7) take part in no pair: a pad meets a live slot at ~1e7 and
// another pad at r = 0, both outside the LJ window, so leaving them out
// of the boxes is exact.  A group with no live slot gets lo = +FLT_MAX,
// hi = -FLT_MAX in x, y, z, which no point is near, and elements 0, so
// that the cutoff over its element range stays finite.
//
// Culling (near): a lane tests its A slot against a B group's box; the
// squared gap from the point to the box is a lower bound of the squared
// distance to every slot of the group (each axis gap is at most that
// axis's difference, and rounding keeps the order), so the warp skips a
// group only when for every lane the gap exceeds the largest LJ cutoff
// the lane can meet over the group's element range (linear in the
// element code, so its extremes lie at the range's ends), raised by 1e-5
// against rounding.  The test needs no slot order; a spatial order
// (neighbor/device_build.py sorts each cell's slots by sub-cell) makes
// the groups compact so that it pays.

#pragma once

#include <cfloat>
#include <cstddef>

#include <cuda_runtime.h>

namespace lj {

// constant vector layout (ops/lj_cells.py: LJ_NAMES, 4 bilinear
// coefficients each: value = (a0 + a1 e_a) + (b0 + b1 e_a) e_b)
enum { kLj1, kLj2, kLj3, kLj4, kLjMinSq, kLjMaxSq, kS95Sq, kLjMin, kK2, kK3,
       kC2, kC3, kNLj };

constexpr int kTile = 32;           // slots per tile = lanes per warp
constexpr int kGroup = 16;          // slots per culling box
constexpr int kGroups = kTile / kGroup;
constexpr int kBoxes = 2 * kGroups; // float4 of boxes per tile
constexpr int kWarps = 4;           // warps per block
constexpr int kThreads = kTile * kWarps;
constexpr float kPad = 1e7f;        // where the planes park pad slots
constexpr float kPadMin = 1e6f;     // x at or past it marks a pad slot
constexpr float kCutSlack = 1.0f + 1e-5f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// min and max over the kGroup lanes of the lane's group
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int m = kGroup / 2; m > 0; m >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int m = kGroup / 2; m > 0; m >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// P [cells, 8, C] -> Q [cells, T * kTile] float4, B [cells, T, kGroups, 2]
// float4 (static: each sweep's object file has its own copy)
static __global__ void __launch_bounds__(kThreads) lj_pack(
    const float* __restrict__ P, float4* __restrict__ Q,
    float4* __restrict__ B, int ncells, int C, int T) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) / kTile;
  const int lane = threadIdx.x % kTile;
  if (w >= ncells * T) return;                 // whole warps
  const int cell = w / T, s = (w % T) * kTile + lane;
  float4 q = make_float4(kPad, kPad, kPad, 0.f);
  if (s < C) {
    const float* p = P + (size_t)cell * 8 * C + s;
    q = make_float4(p[0], p[C], p[2 * C], p[3 * C]);
  }
  Q[(size_t)cell * T * kTile + s] = q;
  const bool live = q.x < kPadMin;
  float4 lo = make_float4(
      group_min(live ? q.x : FLT_MAX), group_min(live ? q.y : FLT_MAX),
      group_min(live ? q.z : FLT_MAX), group_min(live ? q.w : FLT_MAX));
  float4 hi = make_float4(
      group_max(live ? q.x : -FLT_MAX), group_max(live ? q.y : -FLT_MAX),
      group_max(live ? q.z : -FLT_MAX), group_max(live ? q.w : -FLT_MAX));
  if (!(lo.x <= hi.x)) lo.w = hi.w = 0.f;      // finite cutoff
  if (lane % kGroup == 0) {
    float4* g = B + (size_t)w * kBoxes + 2 * (lane / kGroup);
    g[0] = lo;
    g[1] = hi;
  }
}

// scratch layout: Q then B, in floats
inline size_t q_floats(int ncells, int T) {
  return (size_t)ncells * T * kTile * 4;
}

inline cudaError_t launch_pack(const float* P, float* scratch, int ncells,
                               int C, int T, cudaStream_t s) {
  const size_t warps = (size_t)ncells * T;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  lj_pack<<<blocks, kThreads, 0, s>>>(
      P, reinterpret_cast<float4*>(scratch),
      reinterpret_cast<float4*>(scratch + q_floats(ncells, T)), ncells, C,
      T);
  return cudaGetLastError();
}

// the bilinear rows of a slot with element e in the A role: the pair
// constant with a slot of element e_o is a[q] + b[q] * e_o
__device__ __forceinline__ void rows_a(const float4* c4, float e, float* a,
                                       float* b) {
#pragma unroll
  for (int q = 0; q < kNLj; ++q) {
    const float4 k = c4[q];
    a[q] = k.x + e * k.y;
    b[q] = k.z + e * k.w;
  }
}

// the same constants seen from the B slot (element e) of the pair:
// (a0 + a1 e_a) + (b0 + b1 e_a) e = (a0 + b0 e) + (a1 + b1 e) e_a
__device__ __forceinline__ void rows_b(const float4* c4, float e, float* a,
                                       float* b) {
#pragma unroll
  for (int q = 0; q < kNLj; ++q) {
    const float4 k = c4[q];
    a[q] = k.x + e * k.z;
    b[q] = k.y + e * k.w;
  }
}

// is the point q within the lane's largest cutoff of the group box (lo, hi)?
__device__ __forceinline__ bool near(float4 q, float4 lo, float4 hi,
                                     const float* a, const float* b) {
  const float gx = fmaxf(fmaxf(lo.x - q.x, q.x - hi.x), 0.f);
  const float gy = fmaxf(fmaxf(lo.y - q.y, q.y - hi.y), 0.f);
  const float gz = fmaxf(fmaxf(lo.z - q.z, q.z - hi.z), 0.f);
  const float cut2 = fmaxf(a[kLjMaxSq] + b[kLjMaxSq] * lo.w,
                           a[kLjMaxSq] + b[kLjMaxSq] * hi.w) * kCutSlack;
  return gx * gx + gy * gy + gz * gz <= cut2;
}

// bit j set: slot j of the B tile `ch` lies inside the lane's LJ window,
// [ljminsq, ljmaxsq] of the pair's elements; `gb` holds the tile's group
// boxes, and a group that no lane of the warp reaches is not tested (its
// bits are 0: none of its slots can be inside).  Self pairs (r = 0) and
// pads fall outside, so no rsqrt ever meets r = 0.  Call with the whole
// warp.
__device__ __forceinline__ unsigned window_mask(const float4* ch,
                                                const float4* gb, float4 q,
                                                const float* a,
                                                const float* b) {
  unsigned m = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (!__any_sync(0xffffffffu, near(q, gb[2 * g], gb[2 * g + 1], a, b)))
      continue;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int j = g * kGroup + i;
      const float4 p = ch[j];
      const float dx = q.x - p.x, dy = q.y - p.y, dz = q.z - p.z;
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (rsq >= a[kLjMinSq] + b[kLjMinSq] * p.w &&
          rsq <= a[kLjMaxSq] + b[kLjMaxSq] * p.w)
        m |= 1u << j;
    }
  }
  return m;
}

// reciprocal square root without the denormal scaling of rsqrtf: its
// argument is an in-window r^2, far above the denormal range
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// force factor fp (F_own += fp * (x_own - x_other)) and, when kEnergy, the
// pair energy v of an in-window pair at squared distance rsq with a slot
// of element e (pair_rebomos.cpp:518-543: 12-6 above 0.95 sigma, the
// cubic ramp below)
template <bool kEnergy>
__device__ __forceinline__ float pair_fp(const float* a, const float* b,
                                         float rsq, float e, float& v) {
  const float rinv = rsqrt_ftz(rsq);
  const float r = rsq * rinv;
  const float r2inv = rinv * rinv;
  const float r6inv = r2inv * r2inv * r2inv;
  const bool lj126 = rsq >= a[kS95Sq] + b[kS95Sq] * e;
  const float drp = r - (a[kLjMin] + b[kLjMin] * e);
  float fp;
  if (lj126)
    fp = ((a[kLj1] + b[kLj1] * e) * r6inv - (a[kLj2] + b[kLj2] * e)) * r6inv *
         r2inv;
  else
    fp = drp * ((a[kK3] + b[kK3] * e) * drp + (a[kK2] + b[kK2] * e)) * rinv;
  if (kEnergy) {
    if (lj126)
      v = ((a[kLj3] + b[kLj3] * e) * r6inv - (a[kLj4] + b[kLj4] * e)) * r6inv;
    else
      v = drp * drp * ((a[kC3] + b[kC3] * e) * drp + (a[kC2] + b[kC2] * e));
  }
  return fp;
}

// vir += fp * d_a d_b of one pair, in vatom order xx yy zz xy xz yz.  The
// products d_a d_b are __fmul_rn, which the compiler neither merges with
// the plain products of r^2 and of the force sum nor contracts: a shared
// product would keep it from fusing those sums into fmas, and the forces
// would round otherwise with kVirial than without.
__device__ __forceinline__ void add_virial(float* vir, float fp, float dx,
                                           float dy, float dz) {
  vir[0] = fmaf(fp, __fmul_rn(dx, dx), vir[0]);
  vir[1] = fmaf(fp, __fmul_rn(dy, dy), vir[1]);
  vir[2] = fmaf(fp, __fmul_rn(dz, dz), vir[2]);
  vir[3] = fmaf(fp, __fmul_rn(dx, dy), vir[3]);
  vir[4] = fmaf(fp, __fmul_rn(dx, dz), vir[4]);
  vir[5] = fmaf(fp, __fmul_rn(dy, dz), vir[5]);
}

// F_own += sum of fp * (x_own - x_other) (and E_own += v; when kVirial
// vir[0..5] += fp * d_a d_b in vatom order xx yy zz xy xz yz, d = x_own -
// x_other) over the slots `others[j]` of the set bits j of m, in ascending
// j.  Two pairs per step, so that the two bodies' latencies overlap; the
// sums are taken in the same order as one pair per step.  `a`, `b` are the
// own slot's rows.
template <bool kEnergy, bool kVirial = false>
__device__ __forceinline__ void sum_hits(const float4* others, unsigned m,
                                         float4 q, const float* a,
                                         const float* b, float& fx,
                                         float& fy, float& fz, float& en,
                                         float* vir = nullptr) {
  while (m) {
    const int j1 = __ffs(m) - 1;
    m &= m - 1;
    const bool two = m != 0;
    const int j2 = two ? __ffs(m) - 1 : j1;
    m &= m - 1;
    const float4 p1 = others[j1], p2 = others[j2];
    const float dx1 = q.x - p1.x, dy1 = q.y - p1.y, dz1 = q.z - p1.z;
    const float dx2 = q.x - p2.x, dy2 = q.y - p2.y, dz2 = q.z - p2.z;
    float v1, v2;
    const float fp1 =
        pair_fp<kEnergy>(a, b, dx1 * dx1 + dy1 * dy1 + dz1 * dz1, p1.w, v1);
    const float fp2 =
        pair_fp<kEnergy>(a, b, dx2 * dx2 + dy2 * dy2 + dz2 * dz2, p2.w, v2);
    fx += fp1 * dx1;
    fy += fp1 * dy1;
    fz += fp1 * dz1;
    if (kEnergy) en += v1;
    if (kVirial) add_virial(vir, fp1, dx1, dy1, dz1);
    if (two) {
      fx += fp2 * dx2;
      fy += fp2 * dy2;
      fz += fp2 * dz2;
      if (kEnergy) en += v2;
      if (kVirial) add_virial(vir, fp2, dx2, dy2, dz2);
    }
  }
}

// 32 x 32 bit-matrix transpose across the warp: on entry bit j of lane i
// is M[i][j], on return bit i of lane j is M[i][j] (five xor-shuffle
// rounds, each swapping the off-diagonal blocks of half the size)
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const unsigned m = masks[k];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~m) | ((y & ~m) >> s))
                   : ((x & m) | ((y & m) << s));
  }
  return x;
}

}  // namespace lj
