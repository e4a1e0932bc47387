// REBO per-edge cotangents G_e = dE_REBO/dd_e, gradient derived by hand.
//
// Replaces: lammps_plugins_tpu/ops/rebo_pallas.py::_rebo_call (body
// _make_kernel), the Pallas TPU kernel of the REBOMoS force path.  The
// physics and every term follow rebo_pallas.py:97-218 (Sp switch, fR/fA,
// P(N), the K x K angular sums w_k g(cos theta_jk), p_ij, chain rule).
//
// What bounds it on the H100: FP32 arithmetic and transcendentals, about
// 70 flops x K^2 per atom (~25M angular pairs a step at 98k atoms, K=16);
// memory traffic is only ~9 x K x Np x 4 B (~56 MB a step).
//
// Design: one thread per center atom.  Inputs stay in the [K, Np] layout
// so that across a warp thread i reads d[k*Np + i] coalesced.  Per-edge
// terms live in per-thread arrays; the K x K angular terms are recomputed
// in loops over k and never stored: pass 1 builds Etmp_j (hence p_j and
// T_j), pass 2 builds Gg_j = sum_k T_k g_jk and the cos-chain sums from
// M_jk = (T_j w_k + T_k w_j) g'_jk.  The TPU kernel's restricted-range
// sin/cos polynomials are replaced by sincosf.  Constants come from
// derive_rebo_constants as bilinear (pair) and linear (center) rows.
// Simple and right first; register blocking and shared-memory staging of
// the edge data are left to later work.
//
// emit_rows (rebo_pallas.py:219-226, 245): when `rows` is not null the
// same thread also stores G_e as one 16-byte float4 (gx, gy, gz, 0) of
// the interleaved [K, Np, 4] table that the `rows` mirror combine
// (csrc/mirror_rows.cu) gathers from.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTol = 1.0e-9f;     // pair_rebomos.cpp:52
// constant vector layout (ops/rebo.py: rebo_constant_vector)
constexpr int kPairRcmin = 0, kPairInvDrc = 1, kPairQ = 2, kPairA = 3,
              kPairAlpha = 4, kPairBIJc = 5, kPairBeta = 6;
constexpr int kCtrBase = 28;        // 7 pair constants x 4 coefficients
constexpr int kCtrB = 0, kCtrBg = 7, kCtrA = 14;
constexpr int kNConst = kCtrBase + 2 * 18;

__device__ __forceinline__ float pairc(const float* c, int q, float eI,
                                       float ej) {
  return (c[4 * q] + c[4 * q + 1] * eI) + (c[4 * q + 2] + c[4 * q + 3] * eI) * ej;
}

__device__ __forceinline__ float ctrc(const float* c, int q, float eI) {
  return c[kCtrBase + 2 * q] + c[kCtrBase + 2 * q + 1] * eI;
}

// g(cos) and g'(cos): two sixth-degree polynomials blended by
// psi = sin^2(pi (c - 1/2)) for c >= 1/2 (pair_rebomos.h:68-167)
__device__ __forceinline__ void g_spline(float c, const float* b,
                                         const float* bg, float& g,
                                         float& gp) {
  float vb = b[6], db = 0.f, vg = bg[6], dg = 0.f;
#pragma unroll
  for (int q = 5; q >= 0; --q) {
    db = db * c + vb;
    vb = vb * c + b[q];
    dg = dg * c + vg;
    vg = vg * c + bg[q];
  }
  if (c >= 0.5f) {
    float sn, cn;
    sincosf(kPi * (c - 0.5f), &sn, &cn);
    const float psi = sn * sn;
    const float psip = (2.0f * kPi) * sn * cn;
    const float diff = vg - vb;
    g = vb + psi * diff;
    gp = db + psip * diff + psi * (dg - db);
  } else {
    g = vb;
    gp = db;
  }
}

template <int K>
__global__ void rebo_cotangents_kernel(
    const float* __restrict__ dxT, const float* __restrict__ dyT,
    const float* __restrict__ dzT, const float* __restrict__ jelT,
    const float* __restrict__ mskT, const float* __restrict__ ei,
    const float* __restrict__ cst, float* __restrict__ gxT,
    float* __restrict__ gyT, float* __restrict__ gzT,
    float4* __restrict__ rows, int Np) {
  __shared__ float c[kNConst];
  for (int t = threadIdx.x; t < kNConst; t += blockDim.x) c[t] = cst[t];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Np) return;

  const float eI = ei[i];
  float b[7], bg[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    b[q] = ctrc(c, kCtrB + q, eI);
    bg[q] = ctrc(c, kCtrBg + q, eI);
  }

  float dx[K], dy[K], dz[K], rinv[K], w[K], wp[K];
  float fR[K], fRp[K], fA[K], fAp[K], live[K], pij[K], T[K];
  float nM = 0.f, nS = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)k * Np + i;
    const float mf = mskT[e];
    const float ej = jelT[e];
    dx[k] = dxT[e];
    dy[k] = dyT[e];
    dz[k] = dzT[e];
    float rsq = dx[k] * dx[k] + dy[k] * dy[k] + dz[k] * dz[k];
    rsq = mf > 0.f ? rsq : 1.0f;
    rsq = fmaxf(rsq, 1e-12f);
    const float ri = rsqrtf(rsq);
    const float r = rsq * ri;
    rinv[k] = ri;
    // switching function Sp and its derivative (pair_rebomos.h:195-211)
    const float inv_drc = pairc(c, kPairInvDrc, eI, ej);
    const float t = (r - pairc(c, kPairRcmin, eI, ej)) * inv_drc;
    const float tc = fminf(fmaxf(t, 0.f), 1.f);
    float sn, cn;
    sincosf(tc * kPi, &sn, &cn);
    const float wk = (t <= 0.f ? 1.f : (t >= 1.f ? 0.f : 0.5f * (1.f + cn))) * mf;
    w[k] = wk;
    wp[k] = (t > 0.f && t < 1.f) ? (-0.5f * kPi) * inv_drc * sn * mf : 0.f;
    // pair repulsion / attraction radial factors
    const float Q = pairc(c, kPairQ, eI, ej);
    const float A = pairc(c, kPairA, eI, ej);
    const float al = pairc(c, kPairAlpha, eI, ej);
    const float eR = A * expf(-al * r);
    fR[k] = (1.f + Q * ri) * eR;
    fRp[k] = -eR * (Q * ri * ri + al * (1.f + Q * ri));
    const float beta = pairc(c, kPairBeta, eI, ej);
    fA[k] = pairc(c, kPairBIJc, eI, ej) * expf(-beta * r);
    fAp[k] = -beta * fA[k];
    live[k] = (mf > 0.f && wk > kTol) ? 1.f : 0.f;
    nM += wk * (1.f - ej);
    nS += wk * ej;
  }

  // coordination penalty P(N) and dP/dN (pair_rebomos.h:173-179)
  const float Nc = nM + nS;
  const float a0 = ctrc(c, kCtrA + 0, eI), a1 = ctrc(c, kCtrA + 1, eI);
  const float a2 = ctrc(c, kCtrA + 2, eI), a3 = ctrc(c, kCtrA + 3, eI);
  const float expN = a1 * expf(-a2 * Nc);
  const float P = -a0 * (Nc - 1.f) - expN + a3;
  const float Pp = -a0 + a2 * expN;

  // pass 1: Etmp_j = sum_{k != j} w_k g(cos_jk) -> p_j, T_j = dE/dEtmp_j
  float ST = 0.f;
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    float etmp = 0.f;
    for (int k = 0; k < K; ++k) {
      if (k == j) continue;
      float cs = (dx[j] * dx[k] + dy[j] * dy[k] + dz[j] * dz[k]) * (rinv[j] * rinv[k]);
      cs = fminf(fmaxf(cs, -1.f), 1.f);
      float g, gp;
      g_spline(cs, b, bg, g, gp);
      etmp += w[k] * g;
    }
    const float p = rsqrtf(1.f + etmp + P);
    pij[j] = p;
    T[j] = 0.25f * live[j] * w[j] * fA[j] * p * p * p;
    ST += T[j];
  }

  // pass 2: dE/dw and the cos chain, dcos_jk/dd_j = d_k/(r_j r_k) - cos d_j/r_j^2
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    float Gg = 0.f, S2 = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
    for (int k = 0; k < K; ++k) {
      if (k == j) continue;
      const float riv = rinv[j] * rinv[k];
      float cs = (dx[j] * dx[k] + dy[j] * dy[k] + dz[j] * dz[k]) * riv;
      cs = fminf(fmaxf(cs, -1.f), 1.f);
      float g, gp;
      g_spline(cs, b, bg, g, gp);
      Gg += T[k] * g;
      const float M = (T[j] * w[k] + T[k] * w[j]) * gp;
      S2 += M * cs;
      const float Mr = M * riv;
      cx += Mr * dx[k];
      cy += Mr * dy[k];
      cz += Mr * dz[k];
    }
    const float dEdw = 0.5f * live[j] * (fR[j] - pij[j] * fA[j]) + Gg + ST * Pp;
    const float dEdr = 0.5f * live[j] * w[j] * (fRp[j] - pij[j] * fAp[j]);
    const float C1 = dEdr + dEdw * wp[j];
    const float coef = C1 * rinv[j] - S2 * rinv[j] * rinv[j];
    const size_t e = (size_t)j * Np + i;
    const float gx = coef * dx[j] + cx;
    const float gy = coef * dy[j] + cy;
    const float gz = coef * dz[j] + cz;
    gxT[e] = gx;
    gyT[e] = gy;
    gzT[e] = gz;
    if (rows != nullptr) rows[e] = make_float4(gx, gy, gz, 0.f);
  }
}

template <int K>
int launch(const float* dx, const float* dy, const float* dz,
           const float* jel, const float* msk, const float* ei,
           const float* cst, float* gx, float* gy, float* gz,
           float4* rows, int Np, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (Np + threads - 1) / threads;
  rebo_cotangents_kernel<K><<<blocks, threads, 0, s>>>(
      dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, rows, Np);
  return (int)cudaGetLastError();
}

}  // namespace

// K must be a multiple of 4 in [8, 64] (every value Engine._quantize_k and
// the rebuild plans produce up to 64); returns -1 for any other K.
// rows: null, or the [K, Np, 4] interleaved output (16-byte aligned).
extern "C" int lpt_rebo_cotangents(const float* dx, const float* dy,
                                   const float* dz, const float* jel,
                                   const float* msk, const float* ei,
                                   const float* cst, float* gx, float* gy,
                                   float* gz, float* rows, int K, int Np,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LPT_REBO_CASE(KK) \
  case KK:                \
    return launch<KK>(dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, \
                      (float4*)rows, Np, s);
  switch (K) {
    LPT_REBO_CASE(8) LPT_REBO_CASE(12) LPT_REBO_CASE(16) LPT_REBO_CASE(20)
    LPT_REBO_CASE(24) LPT_REBO_CASE(28) LPT_REBO_CASE(32) LPT_REBO_CASE(36)
    LPT_REBO_CASE(40) LPT_REBO_CASE(44) LPT_REBO_CASE(48) LPT_REBO_CASE(52)
    LPT_REBO_CASE(56) LPT_REBO_CASE(60) LPT_REBO_CASE(64)
    default:
      return -1;
  }
#undef LPT_REBO_CASE
}
