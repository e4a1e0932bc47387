// Switched-LJ forces (and per-slot energy) over the dense cell grid.
//
// Replaces: lammps_plugins_tpu/ops/lj_cells_pallas.py::lj_cell_forces
// (_lj_cell_call, body _make_kernel), including its with_energy row.
// Physics: the three-regime switched LJ of pair_rebomos.cpp:518-543 — zero
// outside [rcLJmin, rcLJmax], 12-6 above 0.95 sigma, cubic ramp below.
//
// What bounds it on the H100: FP32 arithmetic, 27 x C^2 pair evaluations
// per A cell (C ~ 104 at 98k atoms: ~2.8e8 pairs a step).
//
// Design: one block per A cell of a_range, blockDim = C rounded up to 32,
// one thread per A slot.  For each of the 27 neighbour cells the block
// stages the B cell's x, y, z and element code in shared memory, then each
// thread sums its A slot's force (and energy when asked) in registers.
// Every ordered pair is evaluated from its A side, so an owned atom's force
// is complete from its own cell row: no scatter, no atomics.  The grid has
// a one-cell empty halo ring, so neighbour indexing needs no boundary
// logic.  Pair constants are bilinear in the element codes
// (derive_lj_constants).  A self pair has rsq = 0 and pad slots sit at
// 1e7 (pad-pad pairs also give rsq = 0): the window test selects before
// any rsqrt, so no inf ever meets a multiply.
// Output layout is the JAX one, [Ax, Ay, Az, 8, C]: rows 0-2 force, row 3
// 0.5 * owned * sum_b V when with_energy (else 0), rows 4-7 zero.

#include <cuda_runtime.h>

namespace {

// constant vector layout (ops/lj_cells.py: LJ_NAMES, 4 bilinear
// coefficients each)
enum { kLj1, kLj2, kLj3, kLj4, kLjMinSq, kLjMaxSq, kS95Sq, kLjMin, kK2, kK3,
       kC2, kC3, kNLj };

__global__ void lj_cells_kernel(const float* __restrict__ P,
                                const float* __restrict__ cst,
                                float* __restrict__ out, int Dy, int Dz,
                                int C, int x0, int y0, int z0, int Ay,
                                int Az, int with_energy) {
  extern __shared__ float sh[];          // [4, C]: x, y, z, element
  const int b = blockIdx.x;
  const int az = b % Az, ay = (b / Az) % Ay, ax = b / (Az * Ay);
  const int cx = x0 + ax, cy = y0 + ay, cz = z0 + az;
  const int t = threadIdx.x;
  const bool act = t < C;

  const size_t abase = ((size_t)(cx * Dy + cy) * Dz + cz) * 8 * C;
  float xa = 0.f, ya = 0.f, za = 0.f, ea = 0.f, own = 0.f;
  if (act) {
    xa = P[abase + 0 * C + t];
    ya = P[abase + 1 * C + t];
    za = P[abase + 2 * C + t];
    ea = P[abase + 3 * C + t];
    own = P[abase + 4 * C + t];
  }
  // per-A-slot bilinear rows: value = pa + pb * e_b
  float pa[kNLj], pb[kNLj];
#pragma unroll
  for (int q = 0; q < kNLj; ++q) {
    pa[q] = cst[4 * q] + ea * cst[4 * q + 1];
    pb[q] = cst[4 * q + 2] + ea * cst[4 * q + 3];
  }

  float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;
  for (int o = 0; o < 27; ++o) {
    const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
    const size_t bbase =
        ((size_t)((cx + ox) * Dy + (cy + oy)) * Dz + (cz + oz)) * 8 * C;
    __syncthreads();
    for (int s = t; s < 4 * C; s += blockDim.x) sh[s] = P[bbase + s];
    __syncthreads();
    if (!act) continue;
    for (int s = 0; s < C; ++s) {
      const float dxm = xa - sh[s];
      const float dym = ya - sh[C + s];
      const float dzm = za - sh[2 * C + s];
      const float rsq = dxm * dxm + dym * dym + dzm * dzm;
      const float eb = sh[3 * C + s];
      if (rsq < pa[kLjMinSq] + pb[kLjMinSq] * eb ||
          rsq > pa[kLjMaxSq] + pb[kLjMaxSq] * eb)
        continue;
      const float rinv = rsqrtf(rsq);
      const float r = rsq * rinv;
      const float r2inv = rinv * rinv;
      const float r6inv = r2inv * r2inv * r2inv;
      const bool lj126 = rsq >= pa[kS95Sq] + pb[kS95Sq] * eb;
      const float drp = r - (pa[kLjMin] + pb[kLjMin] * eb);
      float fp;
      if (lj126)
        fp = ((pa[kLj1] + pb[kLj1] * eb) * r6inv - (pa[kLj2] + pb[kLj2] * eb)) *
             r6inv * r2inv;
      else
        fp = drp * ((pa[kK3] + pb[kK3] * eb) * drp + (pa[kK2] + pb[kK2] * eb)) *
             rinv;
      fx += fp * dxm;
      fy += fp * dym;
      fz += fp * dzm;
      if (with_energy) {
        if (lj126)
          en += ((pa[kLj3] + pb[kLj3] * eb) * r6inv - (pa[kLj4] + pb[kLj4] * eb)) *
                r6inv;
        else
          en += drp * drp *
                ((pa[kC3] + pb[kC3] * eb) * drp + (pa[kC2] + pb[kC2] * eb));
      }
    }
  }
  if (!act) return;
  const size_t obase = ((size_t)(ax * Ay + ay) * Az + az) * 8 * C;
  out[obase + 0 * C + t] = fx;
  out[obase + 1 * C + t] = fy;
  out[obase + 2 * C + t] = fz;
  out[obase + 3 * C + t] = with_energy ? 0.5f * own * en : 0.f;
#pragma unroll
  for (int r = 4; r < 8; ++r) out[obase + r * C + t] = 0.f;
}

}  // namespace

// P: [Dx, Dy, Dz, 8, C]; out: [Ax, Ay, Az, 8, C] over the a_range cells
// starting at (x0, y0, z0).  C <= 1024.
extern "C" int lpt_lj_cell_forces(const float* P, const float* cst,
                                  float* out, int Dy, int Dz, int C, int x0,
                                  int y0, int z0, int Ax, int Ay, int Az,
                                  int with_energy, void* stream) {
  const int threads = ((C + 31) / 32) * 32;
  const size_t shmem = 4 * (size_t)C * sizeof(float);
  lj_cells_kernel<<<Ax * Ay * Az, threads, shmem, (cudaStream_t)stream>>>(
      P, cst, out, Dy, Dz, C, x0, y0, z0, Ay, Az, with_energy);
  return (int)cudaGetLastError();
}
