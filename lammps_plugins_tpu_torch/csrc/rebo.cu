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
// Design: one warp per centre atom, 8 atoms a 256-thread block (4, 2 or 1
// when K's shared memory needs it: ops/rebo.py::rebo_plan).
//  * The block stages its columns of the five input planes through shared
//    memory (eight consecutive floats of a row are one 32-byte sector;
//    rows padded to atoms + 1 floats so that a warp reading its atom's
//    slots hits distinct banks) and writes its outputs back the same way.
//    When the five [K] planes do not fit, it stages them in groups of G
//    slots, and the outputs go to a [3, K] stage of their own.
//  * The lanes walk the slots 32 at a time and compute the switch w_k,
//    w'_k of slot k.  A slot with w = w' = 0 (the mask, the K pad, or
//    past rcmax) adds exactly 0 to every sum and its own G_e is exactly 0,
//    so the warp compacts the other slots (__ballot_sync, __popc) in slot
//    order into per-warp arrays (K slots' room), with the radial terms fR,
//    fA and their derivatives that the lane computing a live slot forms
//    there, and every later loop runs over those n slots, not over K: a
//    large K costs reading the planes.
//  * cos theta_jk, g and g' are symmetric in (j, k): for n <= 32 each
//    unordered pair is evaluated once, spread over the 32 lanes, into an
//    n x n table of g and g' in shared memory (diagonal 0), and both
//    passes read it back.  Lane j then forms Etmp_j, p_j and T_j (pass 1)
//    and Gg_j and the cos-chain sums (pass 2) as loops over k that read
//    the compacted edge data as shared-memory broadcasts.
//  * An atom with n > 32 takes a branch of the same kernel that evaluates
//    g and g' per ordered pair in both passes instead of storing them;
//    lane j owns j, j + 32, ...
//  * Reductions over the atom's slots (N_M, N_S, sum_j T_j) are xor
//    butterflies, which leave the same value on every lane: no float
//    atomics, and reruns are bit-identical.
// K is a run-time argument, any K >= 1 whose shared memory fits a block.
// sincosf and expf keep their accurate forms.
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

constexpr unsigned kFull = 0xffffffffu;
// compacted per-slot arrays of one warp: dx, dy, dz, 1/r, w, T, fR, fR',
// fA, fA', w', p_ij (float) and the raw slot (int)
constexpr int kSlotArrays = 13;
constexpr int kSmemLimit = 232448;  // the H100's opt-in block limit

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

// ATOMS atoms (warps) a block.  G: the slots of the five input planes
// staged at once (G = K: all of them, and the outputs are written over
// planes 0-2 of the stage; G < K: groups of G slots, and a separate
// [3, K] output stage); Kc = K rounded up to 32, the capacity of a warp's
// compacted arrays.  The g / g' tables have row pitch ld = min(K, 32) + 1
// (odd: lanes reading one column of different rows hit different banks).
// kSmall: K <= 32 (the main path): one group, one 32-slot step and n <= 32,
// so every loop over slots runs once (the `if (kSmall) break;` lets the
// compiler drop it, and the n > 32 branch), compiled for five eight-warp
// blocks an SM (at most 51 registers a thread).
template <int ATOMS, bool kSmall>
__global__ void __launch_bounds__(32 * ATOMS, kSmall ? 5 : 1)
rebo_cotangents_kernel(
    const float* __restrict__ dxT, const float* __restrict__ dyT,
    const float* __restrict__ dzT, const float* __restrict__ jelT,
    const float* __restrict__ mskT, const float* __restrict__ ei,
    const float* __restrict__ cst, float* __restrict__ gxT,
    float* __restrict__ gyT, float* __restrict__ gzT,
    float4* __restrict__ rows, int K, int Np, int G, int Kc) {
  // staging row pitch: lanes reading one atom's slots hit distinct banks
  constexpr int pitch = ATOMS + 1;
  constexpr int threads = 32 * ATOMS;
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = K < 32 ? K : 32, ld = m + 1, tab = m * ld;
  const bool grouped = G < K;
  float* c = sm;                                      // [kNConst]
  float* in = c + kNConst;                            // [5][G][pitch]
  float* out = grouped ? in + 5 * G * pitch : in;     // [3][K][pitch]
  float* sx = (grouped ? out + 3 * K * pitch : in + 5 * K * pitch) +
              warp * (kSlotArrays * Kc + 2 * tab);
  float* sy = sx + Kc;
  float* sz = sy + Kc;
  float* sr = sz + Kc;
  float* sw = sr + Kc;
  float* sT = sw + Kc;
  float* sfR = sT + Kc;
  float* sfRp = sfR + Kc;
  float* sfA = sfRp + Kc;
  float* sfAp = sfA + Kc;
  float* swp = sfAp + Kc;
  float* sp = swp + Kc;
  int* sidx = reinterpret_cast<int*>(sp + Kc);
  float* tg = reinterpret_cast<float*>(sidx + Kc);
  float* tgp = tg + tab;

  const int i0 = blockIdx.x * ATOMS;
  const int i = i0 + warp;
  for (int t = threadIdx.x; t < kNConst; t += threads) c[t] = cst[t];
  const float eI = i < Np ? ei[i] : 0.f;
  const float* incol = in + warp;       // this warp's atom's column
  float* outcol = out + warp;
  const unsigned lt = (1u << lane) - 1u;

  // the switch of raw slot k, the lanes walking the slots 32 at a time;
  // the slots with w or w' != 0 are compacted in slot order
  float nM = 0.f, nS = 0.f;
  int n = 0;
  for (int g0 = 0; g0 < K; g0 += G) {
    const int gn = min(G, K - g0);
    if (g0 > 0) __syncthreads();        // the last group is read
    // in[(p G + k) pitch + a] = plane p, slot g0 + k, atom i0 + a
    for (int t = threadIdx.x; t < 5 * gn * ATOMS; t += threads) {
      const int a = t % ATOMS, r = t / ATOMS;
      const int p = r / gn, k = r - p * gn;
      const float* src = p == 0 ? dxT : p == 1 ? dyT : p == 2 ? dzT
                       : p == 3 ? jelT : mskT;
      in[(p * G + k) * pitch + a] =
          (i0 + a < Np) ? src[(size_t)(g0 + k) * Np + i0 + a] : 0.f;
    }
    __syncthreads();
    for (int k0 = 0; k0 < gn; k0 += 32) {
      const int k = k0 + lane;
      float w = 0.f, wp = 0.f, ej = 0.f, r = 1.f, ri = 1.f;
      float dx = 0.f, dy = 0.f, dz = 0.f, fR = 0.f, fRp = 0.f, fA = 0.f,
            fAp = 0.f;
      if (k < gn) {
        const float mf = incol[(4 * G + k) * pitch];
        ej = incol[(3 * G + k) * pitch];
        dx = incol[(0 * G + k) * pitch];
        dy = incol[(1 * G + k) * pitch];
        dz = incol[(2 * G + k) * pitch];
        float rsq = dx * dx + dy * dy + dz * dz;
        rsq = mf > 0.f ? rsq : 1.0f;
        rsq = fmaxf(rsq, 1e-12f);
        ri = rsqrtf(rsq);
        r = rsq * ri;
        // switching function Sp and its derivative (pair_rebomos.h:195-211)
        const float inv_drc = pairc(c, kPairInvDrc, eI, ej);
        const float t = (r - pairc(c, kPairRcmin, eI, ej)) * inv_drc;
        // the sincos only inside the switch: most slots of a large K lie
        // past rcmax (w = w' = 0), the masked ones inside (w = mf = 0)
        if (t <= 0.f) {
          w = mf;
        } else if (t < 1.f) {
          float sn, cn;
          sincosf(t * kPi, &sn, &cn);
          w = 0.5f * (1.f + cn) * mf;
          wp = (-0.5f * kPi) * inv_drc * sn * mf;
        }
        nM += w * (1.f - ej);
        nS += w * ej;
        if (w != 0.f || wp != 0.f) {
          // the radial terms of a live slot, kept beside its geometry
          const float Q = pairc(c, kPairQ, eI, ej);
          const float A = pairc(c, kPairA, eI, ej);
          const float al = pairc(c, kPairAlpha, eI, ej);
          const float eR = A * expf(-al * r);
          fR = (1.f + Q * ri) * eR;
          fRp = -eR * (Q * ri * ri + al * (1.f + Q * ri));
          const float beta = pairc(c, kPairBeta, eI, ej);
          fA = pairc(c, kPairBIJc, eI, ej) * expf(-beta * r);
          fAp = -beta * fA;
        }
      }
      const unsigned bal = __ballot_sync(kFull, w != 0.f || wp != 0.f);
      if ((bal >> lane) & 1u) {
        const int j = n + __popc(bal & lt);
        sx[j] = dx;
        sy[j] = dy;
        sz[j] = dz;
        sr[j] = ri;
        sw[j] = w;
        sfR[j] = fR;
        sfRp[j] = fRp;
        sfA[j] = fA;
        sfAp[j] = fAp;
        swp[j] = wp;
        sidx[j] = g0 + k;
      }
      n += __popc(bal);
      if (kSmall) break;
    }
    if (kSmall) break;
  }
  // every lane has read its column of the staged inputs: the warp's
  // outputs start at zero (the dead slots stay so)
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    outcol[(0 * K + k) * pitch] = 0.f;
    outcol[(1 * K + k) * pitch] = 0.f;
    outcol[(2 * K + k) * pitch] = 0.f;
    if (kSmall) break;
  }
  __syncwarp();

  float b[7], bg[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    b[q] = ctrc(c, kCtrB + q, eI);
    bg[q] = ctrc(c, kCtrBg + q, eI);
  }
  // coordination penalty P(N) and dP/dN (pair_rebomos.h:173-179)
  const float Nc = warp_sum(nM) + warp_sum(nS);
  const float a0 = ctrc(c, kCtrA + 0, eI), a1 = ctrc(c, kCtrA + 1, eI);
  const float a2 = ctrc(c, kCtrA + 2, eI), a3 = ctrc(c, kCtrA + 3, eI);
  const float expN = a1 * expf(-a2 * Nc);
  const float P = -a0 * (Nc - 1.f) - expN + a3;
  const float Pp = -a0 + a2 * expN;

  const bool table = kSmall || n <= 32;   // warp-uniform
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
  // (lane j owns compacted slots j, j + 32, ...; a compacted slot is
  // masked in, so it is live when w > tol)
  float STl = 0.f;
  for (int j = lane; j < n; j += 32) {
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
    const float fA = sfA[j];
    const float live = sw[j] > kTol ? 1.f : 0.f;
    const float p = rsqrtf(1.f + etmp + P);
    const float T = 0.25f * live * sw[j] * fA * p * p * p;
    sT[j] = T;
    sp[j] = p;
    STl += T;
    if (kSmall) break;
  }
  const float ST = warp_sum(STl);
  __syncwarp();

  // pass 2: dE/dw and the cos chain, dcos_jk/dd_j = d_k/(r_j r_k) - cos d_j/r_j^2
  for (int j = lane; j < n; j += 32) {
    const float wj = sw[j], Tj = sT[j];
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
    // radial terms of slot j
    const float rinv = sr[j];
    const float fR = sfR[j], fRp = sfRp[j], fA = sfA[j], fAp = sfAp[j];
    const float live = wj > kTol ? 1.f : 0.f;
    const float pij = sp[j];
    const float dEdw = 0.5f * live * (fR - pij * fA) + Gg + ST * Pp;
    const float dEdr = 0.5f * live * wj * (fRp - pij * fAp);
    const float C1 = dEdr + dEdw * swp[j];
    const float coef = C1 * rinv - S2 * rinv * rinv;
    const int k = sidx[j];
    outcol[(0 * K + k) * pitch] = coef * sx[j] + cx;
    outcol[(1 * K + k) * pitch] = coef * sy[j] + cy;
    outcol[(2 * K + k) * pitch] = coef * sz[j] + cz;
    if (kSmall) break;
  }
  __syncthreads();

  // outputs: the [3, K] stage, back in the [K, Np] layout
  for (int t = threadIdx.x; t < 3 * K * ATOMS; t += threads) {
    const int a = t % ATOMS, r = t / ATOMS;
    const int p = r / K, k = r - p * K;
    if (i0 + a < Np) {
      float* dst = p == 0 ? gxT : p == 1 ? gyT : gzT;
      dst[(size_t)k * Np + i0 + a] = out[r * pitch + a];
    }
  }
  if (rows != nullptr) {
    for (int t = threadIdx.x; t < K * ATOMS; t += threads) {
      const int a = t % ATOMS, k = t / ATOMS;
      if (i0 + a < Np)
        rows[(size_t)k * Np + i0 + a] = make_float4(
            out[(0 * K + k) * pitch + a], out[(1 * K + k) * pitch + a],
            out[(2 * K + k) * pitch + a], 0.f);
    }
  }
}

// shared memory of a launch (ops/rebo.py::rebo_plan computes the same)
size_t rebo_bytes(int atoms, int K, int G) {
  const size_t pitch = atoms + 1, Kc = (K + 31) / 32 * 32;
  const size_t m = K < 32 ? K : 32;
  const size_t stage = G < K ? (5 * (size_t)G + 3 * (size_t)K) * pitch
                             : 5 * (size_t)K * pitch;
  return 4 * (kNConst + stage + atoms * (kSlotArrays * Kc + 2 * m * (m + 1)));
}

template <int ATOMS, bool kSmall>
int launch(const float* dx, const float* dy, const float* dz,
           const float* jel, const float* msk, const float* ei,
           const float* cst, float* gx, float* gy, float* gz,
           float4* rows, int K, int Np, int G, cudaStream_t s) {
  const size_t bytes = rebo_bytes(ATOMS, K, G);
  if (bytes > (size_t)kSmemLimit) return -1;
  const int blocks = (Np + ATOMS - 1) / ATOMS;
  rebo_cotangents_kernel<ATOMS, kSmall><<<blocks, 32 * ATOMS, bytes, s>>>(
      dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, rows, K, Np, G,
      (K + 31) / 32 * 32);
  return (int)cudaGetLastError();
}

// Let every instantiation take up to the block limit of dynamic shared
// memory, once a device (the attribute is the calling thread's current
// device's), at the entry point's first call there (the Engine's first
// force pass runs eagerly), so that a later call, which a CUDA graph may be
// capturing after a K re-size picked another instantiation, makes no call
// but the device query and the launch.
constexpr int kMaxDevices = 64;

int opt_in_all() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (done[dev]) return 0;
  const void* kernels[] = {
      (const void*)rebo_cotangents_kernel<8, true>,
      (const void*)rebo_cotangents_kernel<8, false>,
      (const void*)rebo_cotangents_kernel<4, false>,
      (const void*)rebo_cotangents_kernel<2, false>,
      (const void*)rebo_cotangents_kernel<1, false>};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
  }
  done[dev] = true;
  return 0;
}

}  // namespace

// Any K >= 1; atoms (8, 4, 2 or 1) a block and G (1 <= G <= K) the slots
// staged at once, whose shared memory must fit a block
// (ops/rebo.py::rebo_plan); returns -1 otherwise.  rows: null, or the
// [K, Np, 4] interleaved output (16-byte aligned).
extern "C" int lpt_rebo_cotangents(const float* dx, const float* dy,
                                   const float* dz, const float* jel,
                                   const float* msk, const float* ei,
                                   const float* cst, float* gx, float* gy,
                                   float* gz, float* rows, int K, int Np,
                                   int atoms, int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || Np < 0 || G < 1 || G > K) return -1;
  if (Np == 0) return 0;
  const int err = opt_in_all();
  if (err) return err;
  float4* r4 = (float4*)rows;
  if (K <= 32 && atoms == 8)
    return launch<8, true>(dx, dy, dz, jel, msk, ei, cst, gx, gy, gz, r4, K,
                           Np, G, s);
  switch (atoms) {
    case 8: return launch<8, false>(dx, dy, dz, jel, msk, ei, cst, gx, gy,
                                    gz, r4, K, Np, G, s);
    case 4: return launch<4, false>(dx, dy, dz, jel, msk, ei, cst, gx, gy,
                                    gz, r4, K, Np, G, s);
    case 2: return launch<2, false>(dx, dy, dz, jel, msk, ei, cst, gx, gy,
                                    gz, r4, K, Np, G, s);
    case 1: return launch<1, false>(dx, dy, dz, jel, msk, ei, cst, gx, gy,
                                    gz, r4, K, Np, G, s);
    default: return -1;
  }
}
