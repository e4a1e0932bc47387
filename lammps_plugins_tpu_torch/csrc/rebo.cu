// REBO per-edge cotangents G_e = dE_REBO/dd_e, gradient derived by hand.
//
// Replaces: lammps_plugins_tpu/ops/rebo_pallas.py::_rebo_call (body
// _make_kernel), the Pallas TPU kernel of the REBOMoS force path.  The
// physics and every term follow rebo_pallas.py:97-218 (Sp switch, fR/fA,
// P(N), the angular sums w_k g(cos theta_jk), p_ij, chain rule).
//
// What bounds it on the H100: the bytes of the [K, Np] planes (5 in, 3
// out, ~63 MB a step at 98k atoms, K = 20: ~0.02 ms at 3.35 TB/s).  The
// arithmetic is ~60 FP32 flops and one sincos per unordered pair of live
// edges, ~9M pairs a step, well under that.
//
// Design: one warp per centre atom, eight atoms per 256-thread block.
//  * The block stages its eight columns of the five input planes through
//    shared memory (eight consecutive floats of a row are one 32-byte
//    sector; rows padded to 9 floats so that a warp reading its atom's
//    slots hits 32 banks) and writes its outputs back the same way.
//  * Lane k computes the switch w_k, w'_k of slot k (and k + 32 when
//    K > 32).  A slot with w = w' = 0 (the mask, the K pad, or past rcmax)
//    adds exactly 0 to every sum and its own G_e is exactly 0, so the warp
//    compacts the other slots (__ballot_sync, __popc) in slot order and
//    every later loop runs over those n slots, not over K.
//  * cos theta_jk, g and g' are symmetric in (j, k): for n <= 32 each
//    unordered pair is evaluated once, spread over the 32 lanes, into an
//    n x n table of g and g' in shared memory (diagonal 0), and both
//    passes read it back.  Lane j then forms Etmp_j, p_j and T_j (pass 1)
//    and Gg_j and the cos-chain sums (pass 2) as loops over k that read
//    the compacted edge data as shared-memory broadcasts.
//  * An atom with n > 32 (only after a re-size past K = 32) takes a branch
//    of the same kernel that evaluates g and g' per ordered pair in both
//    passes instead of storing them; lane j owns j and j + 32.
//  * Reductions over the atom's slots (N_M, N_S, sum_j T_j) are xor
//    butterflies, which leave the same value on every lane: no float
//    atomics, and reruns are bit-identical.
// K is a run-time argument in [1, 64].  sincosf and expf keep their
// accurate forms.
//
// emit_rows (rebo_pallas.py:219-226, 245): when `rows` is not null the
// block also stores G_e as one 16-byte float4 (gx, gy, gz, 0) of the
// interleaved [K, Np, 4] table that the `rows` mirror combine
// (csrc/mirror_rows.cu) gathers from, from the same staged values as the
// planes, so the two are bit-identical.

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

constexpr int kAtoms = 8;           // atoms (warps) per block
constexpr int kThreads = 32 * kAtoms;
// staging row pitch: lanes reading one atom's slots hit distinct banks
constexpr int kPitch = kAtoms + 1;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
// compacted per-slot arrays of one warp: dx, dy, dz, 1/r, w, T
constexpr int kSlotArrays = 6;

__device__ __forceinline__ float pairc(const float* c, int q, float eI,
                                       float ej) {
  return (c[4 * q] + c[4 * q + 1] * eI) + (c[4 * q + 2] + c[4 * q + 3] * eI) * ej;
}

__device__ __forceinline__ float ctrc(const float* c, int q, float eI) {
  return c[kCtrBase + 2 * q] + c[kCtrBase + 2 * q + 1] * eI;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

// cos theta_jk (clamped to [-1, 1]) and 1/(r_j r_k) of two compacted slots
__device__ __forceinline__ float cos_jk(const float* sx, const float* sy,
                                        const float* sz, const float* sr,
                                        int j, int k, float& riv) {
  riv = sr[j] * sr[k];
  const float cs = (sx[j] * sx[k] + sy[j] * sy[k] + sz[j] * sz[k]) * riv;
  return fminf(fmaxf(cs, -1.f), 1.f);
}

// S = slots per lane: 1 for K <= 32, 2 for K <= 64.  ld = min(K, 32) + 1
// is the row pitch of the g / g' tables (odd: lanes reading one column
// of different rows hit different banks).
template <int S>
__global__ void __launch_bounds__(kThreads) rebo_cotangents_kernel(
    const float* __restrict__ dxT, const float* __restrict__ dyT,
    const float* __restrict__ dzT, const float* __restrict__ jelT,
    const float* __restrict__ mskT, const float* __restrict__ ei,
    const float* __restrict__ cst, float* __restrict__ gxT,
    float* __restrict__ gyT, float* __restrict__ gzT,
    float4* __restrict__ rows, int K, int Np, int ld) {
  extern __shared__ float sm[];
  float* c = sm;                                      // [kNConst]
  float* stage = c + kNConst;                         // [5][K][kPitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tab = (ld - 1) * ld;                      // one table's floats
  float* slots = stage + 5 * K * kPitch + warp * (kSlotArrays * 32 * S);
  float* sx = slots;
  float* sy = sx + 32 * S;
  float* sz = sy + 32 * S;
  float* sr = sz + 32 * S;
  float* sw = sr + 32 * S;
  float* sT = sw + 32 * S;
  int* sidx = reinterpret_cast<int*>(stage + 5 * K * kPitch +
                                     kAtoms * kSlotArrays * 32 * S) +
              warp * 32 * S;
  float* tg = stage + 5 * K * kPitch + kAtoms * (kSlotArrays + 1) * 32 * S +
              warp * 2 * tab;
  float* tgp = tg + tab;

  const int i0 = blockIdx.x * kAtoms;
  for (int t = threadIdx.x; t < kNConst; t += kThreads) c[t] = cst[t];
  // stage[(p K + k) kPitch + a] = plane p, slot k, atom i0 + a
  for (int t = threadIdx.x; t < 5 * K * kAtoms; t += kThreads) {
    const int a = t % kAtoms, r = t / kAtoms;
    const int p = r / K, k = r - p * K;
    const float* src = p == 0 ? dxT : p == 1 ? dyT : p == 2 ? dzT
                     : p == 3 ? jelT : mskT;
    stage[r * kPitch + a] = (i0 + a < Np) ? src[(size_t)k * Np + i0 + a] : 0.f;
  }
  __syncthreads();

  const int i = i0 + warp;
  const float eI = i < Np ? ei[i] : 0.f;
  float* col = stage + warp;            // column of this warp's atom
  float b[7], bg[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    b[q] = ctrc(c, kCtrB + q, eI);
    bg[q] = ctrc(c, kCtrBg + q, eI);
  }

  // switch per raw slot k = lane + 32 q; compact the slots with w or w' != 0
  float nM = 0.f, nS = 0.f;
  float wq[S], wpq[S], ejq[S], rq[S], riq[S], dxq[S], dyq[S], dzq[S],
      mfq[S];
  unsigned bal[S];
  int n = 0;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int k = lane + 32 * q;
    float w = 0.f, wp = 0.f;
    ejq[q] = 0.f; rq[q] = 1.f; riq[q] = 1.f; mfq[q] = 0.f;
    dxq[q] = 0.f; dyq[q] = 0.f; dzq[q] = 0.f;
    if (k < K) {
      const float mf = col[(4 * K + k) * kPitch];
      const float ej = col[(3 * K + k) * kPitch];
      const float dx = col[(0 * K + k) * kPitch];
      const float dy = col[(1 * K + k) * kPitch];
      const float dz = col[(2 * K + k) * kPitch];
      float rsq = dx * dx + dy * dy + dz * dz;
      rsq = mf > 0.f ? rsq : 1.0f;
      rsq = fmaxf(rsq, 1e-12f);
      const float ri = rsqrtf(rsq);
      const float r = rsq * ri;
      // switching function Sp and its derivative (pair_rebomos.h:195-211)
      const float inv_drc = pairc(c, kPairInvDrc, eI, ej);
      const float t = (r - pairc(c, kPairRcmin, eI, ej)) * inv_drc;
      const float tc = fminf(fmaxf(t, 0.f), 1.f);
      float sn, cn;
      sincosf(tc * kPi, &sn, &cn);
      w = (t <= 0.f ? 1.f : (t >= 1.f ? 0.f : 0.5f * (1.f + cn))) * mf;
      wp = (t > 0.f && t < 1.f) ? (-0.5f * kPi) * inv_drc * sn * mf : 0.f;
      nM += w * (1.f - ej);
      nS += w * ej;
      ejq[q] = ej; rq[q] = r; riq[q] = ri; mfq[q] = mf;
      dxq[q] = dx; dyq[q] = dy; dzq[q] = dz;
    }
    wq[q] = w;
    wpq[q] = wp;
    bal[q] = __ballot_sync(kFull, w != 0.f || wp != 0.f);
  }
  // every lane has read its column of the staged inputs; from here the
  // warp reuses that column for its outputs (zeros for the dead slots)
  __syncwarp();
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int k = lane + 32 * q;
    if (k < K) {
      col[(0 * K + k) * kPitch] = 0.f;
      col[(1 * K + k) * kPitch] = 0.f;
      col[(2 * K + k) * kPitch] = 0.f;
    }
  }
  // compacted slot data in slot order; per-edge radial terms stay with
  // the owning lane (j = lane + 32 q) after a shuffle
  const unsigned lt = (1u << lane) - 1u;
  float ej_j[S], r_j[S], mf_j[S], wp_j[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int base = q == 0 ? 0 : __popc(bal[0]);
    if ((bal[q] >> lane) & 1u) {
      const int j = base + __popc(bal[q] & lt);
      sx[j] = dxq[q]; sy[j] = dyq[q]; sz[j] = dzq[q]; sr[j] = riq[q];
      sw[j] = wq[q];
      sidx[j] = lane + 32 * q;
      // park the radial inputs where the owning lane reads them back
      sT[j] = rq[q];
    }
    n += __popc(bal[q]);
  }
  __syncwarp();
  // the owning lane of compacted slot j = lane + 32 q fetches its raw
  // slot's ej, mf, w' by shuffle from the lane that computed them
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int j = lane + 32 * q;
    const int src = j < n ? sidx[j] : 0;
    float ej = 0.f, mf = 0.f, wp = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float e_s = __shfl_sync(kFull, ejq[s], src & 31);
      const float m_s = __shfl_sync(kFull, mfq[s], src & 31);
      const float p_s = __shfl_sync(kFull, wpq[s], src & 31);
      if ((src >> 5) == s) { ej = e_s; mf = m_s; wp = p_s; }
    }
    ej_j[q] = ej; mf_j[q] = mf; wp_j[q] = wp;
    r_j[q] = j < n ? sT[j] : 1.f;
  }

  // coordination penalty P(N) and dP/dN (pair_rebomos.h:173-179)
  const float Nc = warp_sum(nM) + warp_sum(nS);
  const float a0 = ctrc(c, kCtrA + 0, eI), a1 = ctrc(c, kCtrA + 1, eI);
  const float a2 = ctrc(c, kCtrA + 2, eI), a3 = ctrc(c, kCtrA + 3, eI);
  const float expN = a1 * expf(-a2 * Nc);
  const float P = -a0 * (Nc - 1.f) - expN + a3;
  const float Pp = -a0 + a2 * expN;

  // radial terms of the owned slots j = lane + 32 q < n
  float fR[S], fRp[S], fA[S], fAp[S], live[S], pij[S], T[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const float r = r_j[q], ej = ej_j[q];
    const float ri = lane + 32 * q < n ? sr[lane + 32 * q] : 1.f;
    const float Q = pairc(c, kPairQ, eI, ej);
    const float A = pairc(c, kPairA, eI, ej);
    const float al = pairc(c, kPairAlpha, eI, ej);
    const float eR = A * expf(-al * r);
    fR[q] = (1.f + Q * ri) * eR;
    fRp[q] = -eR * (Q * ri * ri + al * (1.f + Q * ri));
    const float beta = pairc(c, kPairBeta, eI, ej);
    fA[q] = pairc(c, kPairBIJc, eI, ej) * expf(-beta * r);
    fAp[q] = -beta * fA[q];
    const float w = lane + 32 * q < n ? sw[lane + 32 * q] : 0.f;
    live[q] = (mf_j[q] > 0.f && w > kTol) ? 1.f : 0.f;
  }
  __syncwarp();                         // sT is free again

  const bool table = n <= 32;           // warp-uniform
  if (table) {
    // each unordered pair once: p -> (j, k = j + d mod n), d = p / n + 1
    const int npairs = n * (n - 1) / 2;
    for (int p = lane; p < npairs; p += 32) {
      const int d = p / n + 1;
      const int j = p - (d - 1) * n;
      const int k = j + d < n ? j + d : j + d - n;
      float riv, g, gp;
      const float cs = cos_jk(sx, sy, sz, sr, j, k, riv);
      g_spline(cs, b, bg, g, gp);
      tg[j * ld + k] = g;
      tg[k * ld + j] = g;
      tgp[j * ld + k] = gp;
      tgp[k * ld + j] = gp;
    }
    if (lane < n) {
      tg[lane * ld + lane] = 0.f;
      tgp[lane * ld + lane] = 0.f;
    }
    __syncwarp();
  }

  // pass 1: Etmp_j = sum_{k != j} w_k g(cos_jk) -> p_j, T_j = dE/dEtmp_j
  float STl = 0.f;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int j = lane + 32 * q;
    pij[q] = 0.f;
    T[q] = 0.f;
    if (j < n) {
      float etmp = 0.f;
      if (table) {
        for (int k = 0; k < n; ++k) etmp += sw[k] * tg[j * ld + k];
      } else {
        for (int k = 0; k < n; ++k) {
          if (k == j) continue;
          float riv, g, gp;
          const float cs = cos_jk(sx, sy, sz, sr, j, k, riv);
          g_spline(cs, b, bg, g, gp);
          etmp += sw[k] * g;
        }
      }
      const float p = rsqrtf(1.f + etmp + P);
      pij[q] = p;
      T[q] = 0.25f * live[q] * sw[j] * fA[q] * p * p * p;
      sT[j] = T[q];
    }
    STl += T[q];
  }
  const float ST = warp_sum(STl);
  __syncwarp();

  // pass 2: dE/dw and the cos chain, dcos_jk/dd_j = d_k/(r_j r_k) - cos d_j/r_j^2
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int j = lane + 32 * q;
    if (j >= n) continue;
    const float wj = sw[j], Tj = T[q];
    float Gg = 0.f, S2 = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
    for (int k = 0; k < n; ++k) {
      float riv, g, gp;
      const float cs = cos_jk(sx, sy, sz, sr, j, k, riv);
      if (table) {
        g = tg[j * ld + k];
        gp = tgp[j * ld + k];
      } else {
        if (k == j) continue;
        g_spline(cs, b, bg, g, gp);
      }
      Gg += sT[k] * g;
      const float M = (Tj * sw[k] + sT[k] * wj) * gp;
      S2 += M * cs;
      const float Mr = M * riv;
      cx += Mr * sx[k];
      cy += Mr * sy[k];
      cz += Mr * sz[k];
    }
    const float rinv = sr[j];
    const float dEdw = 0.5f * live[q] * (fR[q] - pij[q] * fA[q]) + Gg + ST * Pp;
    const float dEdr = 0.5f * live[q] * wj * (fRp[q] - pij[q] * fAp[q]);
    const float C1 = dEdr + dEdw * wp_j[q];
    const float coef = C1 * rinv - S2 * rinv * rinv;
    const int k = sidx[j];
    col[(0 * K + k) * kPitch] = coef * sx[j] + cx;
    col[(1 * K + k) * kPitch] = coef * sy[j] + cy;
    col[(2 * K + k) * kPitch] = coef * sz[j] + cz;
  }
  __syncthreads();

  // outputs: planes p < 3 of the staging buffer, back in the [K, Np] layout
  for (int t = threadIdx.x; t < 3 * K * kAtoms; t += kThreads) {
    const int a = t % kAtoms, r = t / kAtoms;
    const int p = r / K, k = r - p * K;
    if (i0 + a < Np) {
      float* dst = p == 0 ? gxT : p == 1 ? gyT : gzT;
      dst[(size_t)k * Np + i0 + a] = stage[r * kPitch + a];
    }
  }
  if (rows != nullptr) {
    for (int t = threadIdx.x; t < K * kAtoms; t += kThreads) {
      const int a = t % kAtoms, k = t / kAtoms;
      if (i0 + a < Np)
        rows[(size_t)k * Np + i0 + a] = make_float4(
            stage[(0 * K + k) * kPitch + a], stage[(1 * K + k) * kPitch + a],
            stage[(2 * K + k) * kPitch + a], 0.f);
    }
  }
}

template <int S>
int launch(const float* dx, const float* dy, const float* dz,
           const float* jel, const float* msk, const float* ei,
           const float* cst, float* gx, float* gy, float* gz,
           float4* rows, int K, int Np, cudaStream_t s) {
  const int m = K < 32 ? K : 32;
  const int ld = m + 1;
  const size_t floats = kNConst + 5 * (size_t)K * kPitch +
                        (size_t)kAtoms * (kSlotArrays + 1) * 32 * S +
                        (size_t)kAtoms * 2 * m * ld;
  const size_t bytes = floats * sizeof(float);
  static size_t allowed = 48 * 1024;   // the default dynamic limit
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rebo_cotangents_kernel<S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const int blocks = (Np + kAtoms - 1) / kAtoms;
  rebo_cotangents_kernel<S><<<blocks, kThreads, bytes, s>>>(
      dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, rows, K, Np, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// K in [1, 64] (a run-time argument); returns -1 for any other K.
// rows: null, or the [K, Np, 4] interleaved output (16-byte aligned).
extern "C" int lpt_rebo_cotangents(const float* dx, const float* dy,
                                   const float* dz, const float* jel,
                                   const float* msk, const float* ei,
                                   const float* cst, float* gx, float* gy,
                                   float* gz, float* rows, int K, int Np,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > kMaxK || Np < 0) return -1;
  if (Np == 0) return 0;
  if (K <= 32)
    return launch<1>(dx, dy, dz, jel, msk, ei, cst, gx, gy, gz,
                     (float4*)rows, K, Np, s);
  return launch<2>(dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, (float4*)rows,
                   K, Np, s);
}
