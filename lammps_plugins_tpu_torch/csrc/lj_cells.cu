// Switched-LJ forces (and per-slot energy) over the dense cell grid.
//
// Replaces: lammps_plugins_tpu/ops/lj_cells_pallas.py::lj_cell_forces
// (_lj_cell_call, body _make_kernel), including its with_energy row.
// Physics: the three-regime switched LJ of pair_rebomos.cpp:518-543 — zero
// outside [rcLJmin, rcLJmax], 12-6 above 0.95 sigma, cubic ramp below.
//
// What bounds it on the H100: instruction issue and latency, not flops or
// bytes.  At the 97,920-atom bench shapes (C = 104, 1,188 A cells) one
// slot pair in ~28 of the 27-cell sweep lies inside the LJ window.  A
// sweep that tests every slot pair and, under divergence, runs the whole
// pair body for every B slot that any lane of the warp hits spends ~60 %
// of its issue on lanes with nothing to do.  Here the issue goes to the
// window test, ~12 instructions per tested slot pair, over the (A tile,
// B group) pairs that survive culling (69 % of those with live slots at
// the bench shapes), and to the pair body, run max-over-lanes(hits) times
// per group of tests, ~4x the mean.  All 1,188 blocks are resident at
// once (9 per SM, 56 registers), so the time is the busiest SM's.
//
// Design (pieces shared with lj_half.cu in lj_common.cuh):
//   * a packing pass makes one float4 (x, y, z, element) per slot and the
//     box of every 16-slot group from this call's positions;
//   * one block of 4 warps per A cell of a_range; warp w holds A tile w
//     (tiles w + 4, w + 8, ... in further rounds when C > 128), one lane
//     per A slot; a tile without live slots idles;
//   * the 27 B cells stream through a double buffer in shared memory with
//     cp.async (the next B cell's slots and group boxes load while the
//     current one is swept), one __syncthreads per B cell;
//   * per B tile: each lane tests its A slot against the boxes of the
//     tile's two 16-slot groups and the warp skips a group that no lane
//     reaches; for the others each lane builds the bits of the B slots
//     inside its pair window (one float4 broadcast from shared memory per
//     slot), then runs the pair body only over its set bits, in ascending
//     slot order, two pairs per step.
// Each A slot's force is summed in its own lane in (B cell, B slot) order:
// no atomics, and reruns are bit-identical.  The grid has a one-cell empty
// halo ring, so neighbour indexing needs no boundary logic.
// Output layout is the JAX one, [Ax, Ay, Az, 8, C]: rows 0-2 force, row 3
// 0.5 * owned * sum_b V when with_energy (else 0), rows 4-7 zero.  With
// with_virial a second output [Ax, Ay, Az, 6, C] holds each A slot's
// 0.5 * owned * sum_b fp d_a d_b (vatom order xx yy zz xy xz yz), summed in
// the same lane and order as its force.  That instantiation (a thermo row
// or a stress/atom frame) carries six more accumulators and is allowed 64
// registers (8 blocks an SM); the per-step one (no energy, no virial) is
// unchanged.

#include "lj_common.cuh"

namespace {

using namespace lj;

constexpr int kNOff = 27;

template <bool kEnergy, bool kVirial>
__global__ void __launch_bounds__(kThreads, kVirial ? 8 : 9) lj_cells_kernel(
    const float* __restrict__ P, const float4* __restrict__ Q,
    const float4* __restrict__ box, const float* __restrict__ cst,
    float* __restrict__ out, int Dy, int Dz, int C, int T, int x0, int y0,
    int z0, int Ay, int Az, float* __restrict__ vout) {
  extern __shared__ float4 sh[];   // 2 x [T * 32 slots | T x boxes]
  __shared__ float4 c4[kNLj];
  const int stride = T * (kTile + kBoxes);
  const int b = blockIdx.x;
  const int az = b % Az, ay = (b / Az) % Ay, ax = b / (Az * Ay);
  const int cx = x0 + ax, cy = y0 + ay, cz = z0 + az;
  const int warp = threadIdx.x / kTile, lane = threadIdx.x % kTile;
  const size_t acell = ((size_t)cx * Dy + cy) * Dz + cz;
  if (threadIdx.x < kNLj)
    c4[threadIdx.x] = reinterpret_cast<const float4*>(cst)[threadIdx.x];

  auto stage = [&](int o, int buf) {
    const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
    const size_t bc = ((size_t)(cx + ox) * Dy + (cy + oy)) * Dz + (cz + oz);
    const float4* sq = Q + bc * T * kTile;
    const float4* sb = box + bc * T * kBoxes;
    float4* d = sh + buf * stride;
    for (int i = threadIdx.x; i < stride; i += kThreads)
      cp_async16(d + i, i < T * kTile ? sq + i : sb + (i - T * kTile));
    cp_async_commit();
  };

  const int rounds = (T + kWarps - 1) / kWarps;
  for (int rd = 0; rd < rounds; ++rd) {
    const int t = rd * kWarps + warp;
    const int s = t * kTile + lane;
    stage(0, 0);
    __syncthreads();                       // c4 is in place
    const float4 qa =
        t < T ? Q[acell * T * kTile + s] : make_float4(kPad, kPad, kPad, 0.f);
    const bool live = __any_sync(0xffffffffu, qa.x < kPadMin);
    float a[kNLj], bb[kNLj];
    rows_a(c4, qa.w, a, bb);
    float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;
    float vir[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < kNOff; ++o) {
      cp_async_wait_all();
      __syncthreads();                     // B cell o landed; o - 1 swept
      if (o + 1 < kNOff) stage(o + 1, (o + 1) & 1);
      if (!live) continue;
      const float4* cell = sh + (o & 1) * stride;
      const float4* bx = cell + T * kTile;
      for (int c = 0; c < T; ++c) {
        const float4* ch = cell + c * kTile;
        sum_hits<kEnergy, kVirial>(
            ch, window_mask(ch, bx + c * kBoxes, qa, a, bb), qa, a, bb, fx,
            fy, fz, en, vir);
      }
    }
    __syncthreads();                       // before the next round's stage
    if (t < T && s < C) {
      const size_t obase = ((size_t)(ax * Ay + ay) * Az + az) * 8 * C;
      out[obase + 0 * C + s] = fx;
      out[obase + 1 * C + s] = fy;
      out[obase + 2 * C + s] = fz;
      out[obase + 3 * C + s] =
          kEnergy ? 0.5f * P[acell * 8 * C + 4 * C + s] * en : 0.f;
#pragma unroll
      for (int r = 4; r < 8; ++r) out[obase + r * C + s] = 0.f;
      if (kVirial) {
        const size_t vbase = ((size_t)(ax * Ay + ay) * Az + az) * 6 * C;
        const float w = 0.5f * P[acell * 8 * C + 4 * C + s];
#pragma unroll
        for (int r = 0; r < 6; ++r) vout[vbase + r * C + s] = w * vir[r];
      }
    }
  }
}

template <bool kEnergy, bool kVirial>
void launch_sweep(const float* P, const float4* Q, const float4* B,
                  const float* cst, float* out, float* vout, int Dy, int Dz,
                  int C, int T, int x0, int y0, int z0, int Ax, int Ay,
                  int Az, size_t shmem, cudaStream_t s) {
  lj_cells_kernel<kEnergy, kVirial><<<Ax * Ay * Az, kThreads, shmem, s>>>(
      P, Q, B, cst, out, Dy, Dz, C, T, x0, y0, z0, Ay, Az, vout);
}

}  // namespace

// P: [Dx, Dy, Dz, 8, C]; out: [Ax, Ay, Az, 8, C] over the a_range cells
// starting at (x0, y0, z0); scratch: Dx * Dy * Dz * ceil(C / 32) * 144
// floats (the packed slots and group boxes); vir: [Ax, Ay, Az, 6, C],
// written when with_virial (else unused, may be null).  C <= 1024.
extern "C" int lpt_lj_cell_forces(const float* P, const float* cst,
                                  float* out, int Dy, int Dz, int C, int x0,
                                  int y0, int z0, int Ax, int Ay, int Az,
                                  int with_energy, void* stream,
                                  float* scratch, int Dx, int with_virial,
                                  float* vir) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = (C + kTile - 1) / kTile;
  const int ncells = Dx * Dy * Dz;
  cudaError_t e = launch_pack(P, scratch, ncells, C, T, s);
  if (e != cudaSuccess) return (int)e;
  const float4* Q = reinterpret_cast<const float4*>(scratch);
  const float4* B =
      reinterpret_cast<const float4*>(scratch + q_floats(ncells, T));
  const size_t shmem = 2 * (size_t)T * (kTile + kBoxes) * sizeof(float4);
  auto* go = with_virial
                 ? (with_energy ? launch_sweep<true, true>
                                : launch_sweep<false, true>)
                 : (with_energy ? launch_sweep<true, false>
                                : launch_sweep<false, false>);
  go(P, Q, B, cst, out, vir, Dy, Dz, C, T, x0, y0, z0, Ax, Ay, Az, shmem, s);
  return (int)cudaGetLastError();
}
