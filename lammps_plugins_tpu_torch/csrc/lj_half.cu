// Newton-half switched-LJ forces over the dense cell grid.
//
// Replaces: lammps_plugins_tpu/ops/lj_cells_pallas.py::lj_cell_forces_half
// (_lj_half_call, body _make_half_kernel; LPT_LJ_HALF).  Same physics as
// csrc/lj_cells.cu (pair_rebomos.cpp:518-543), but every unordered pair of
// neighbouring cells is evaluated once: the self cell plus the 13
// lexicographically positive offsets, 14 instead of 27.  Each evaluated
// pair adds fp * (x_a - x_b) to atom a and subtracts it from atom b.
//
// What bounds it on the H100: instruction issue and latency.  The window
// test runs once per unordered slot pair, over the (A tile, B group)
// pairs that survive culling (69 % of those with live slots at the bench
// shapes), ~12 instructions each; the pair body runs on hits only, once
// from each side.  Summing each B slot's side with a 15-shuffle butterfly
// whenever any lane of the warp has a hit (~60 % of the B slots at the
// bench shapes) would cost more than the pair bodies the half sweep
// saves.
//
// Design (pieces shared with lj_cells.cu in lj_common.cuh):
//   * the packing pass of lj_common.cuh (float4 slots, group boxes);
//   * pass 1: one block of 4 warps per (A cell, offset o); the A and B
//     cells' float4 slots and the B group boxes are staged in shared
//     memory; warp w holds A tile w (w + 4, ... in further rounds), one
//     lane per A slot.  Per B tile: groups that no lane reaches are
//     skipped; each lane builds the 32-bit mask of the B slots inside its
//     pair window (the only window test of the pair) and runs the pair
//     body over its set bits into its A-side sum in registers; a
//     five-round xor-shuffle transpose of the warp's 32 x 32 hit matrix
//     then gives lane b the mask of the A lanes that hit B slot b, and
//     lane b evaluates the body again from the B side over just those
//     hits, in A-lane order, adding to the warp's B-side row in shared
//     memory.  After the sweep the block sums the warps' rows in order.
//     Block (A, o) writes its A-side sums into partial slot o and its
//     B-side sums into slot 13 + o, each over the a_range grid: every
//     (slot, cell) has exactly one writer.
//   * pass 2: one thread per (a_range cell, C slot) sums the 27 partial
//     slots in a fixed order.  No float atomics: reruns are bit-identical.
// The A cells of offset o span a_range extended by one cell on the side a
// pair can straddle (as lj_cells_pallas.py:319-327); a_range leaves one
// cell of the grid on every side, so both cells of every block exist, no
// index is clamped and no pair is evaluated twice.  A block whose A cell
// lies outside a_range writes (and computes) no A-side sums, one whose B
// cell does no B-side sums; the self-cell block (o = 0) sees both slot
// orders of every in-cell pair and writes no B-side sums.
// Output [Ax, Ay, Az, C, 3], the JAX function's layout.

#include "lj_common.cuh"

namespace {

using namespace lj;

constexpr int kNOff = 14;
constexpr int kNSlots = 2 * kNOff - 1;
// the self cell, then the 13 offsets with (ox, oy, oz) > (0, 0, 0)
__constant__ int kOff[kNOff][3] = {
    {0, 0, 0},  {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},  {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

__global__ void __launch_bounds__(kThreads, 9) lj_half_pairs(
    const float4* __restrict__ Q, const float4* __restrict__ box,
    const float* __restrict__ cst, float* __restrict__ part, int Dy, int Dz,
    int C, int T, int x0, int y0, int z0, int Ax, int Ay, int Az) {
  // A slots [T * 32] | B slots [T * 32] | B boxes [T x boxes] float4,
  // then the warps' B-side rows [kWarps, T * 32, 3] float
  extern __shared__ float4 sh[];
  __shared__ float4 c4[kNLj];
  const int o = blockIdx.y;
  const int ox = kOff[o][0], oy = kOff[o][1], oz = kOff[o][2];
  const int ex = Ax + abs(ox), ey = Ay + abs(oy), ez = Az + abs(oz);
  const int b = blockIdx.x;
  if (b >= ex * ey * ez) return;
  // A cell relative to the a_range origin: one cell past the range on the
  // side opposite to each non-zero offset component
  const int rax = b / (ez * ey) - max(ox, 0);
  const int ray = (b / ez) % ey - max(oy, 0);
  const int raz = b % ez - max(oz, 0);
  const int rbx = rax + ox, rby = ray + oy, rbz = raz + oz;
  const bool writeA = rax >= 0 && rax < Ax && ray >= 0 && ray < Ay &&
                      raz >= 0 && raz < Az;
  const bool writeB = o != 0 && rbx >= 0 && rbx < Ax && rby >= 0 &&
                      rby < Ay && rbz >= 0 && rbz < Az;
  if (!writeA && !writeB) return;

  const int warp = threadIdx.x / kTile, lane = threadIdx.x % kTile;
  const int ns = T * kTile;
  float4* sA = sh;
  float4* sB = sh + ns;
  float4* sbx = sB + ns;
  float* sred = reinterpret_cast<float*>(sbx + kBoxes * T);
  const size_t ac =
      ((size_t)(x0 + rax) * Dy + (y0 + ray)) * Dz + (z0 + raz);
  const size_t bc =
      ((size_t)(x0 + rbx) * Dy + (y0 + rby)) * Dz + (z0 + rbz);
  if (threadIdx.x < kNLj)
    c4[threadIdx.x] = reinterpret_cast<const float4*>(cst)[threadIdx.x];
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    sA[i] = Q[ac * ns + i];
    sB[i] = Q[bc * ns + i];
  }
  for (int i = threadIdx.x; i < kBoxes * T; i += kThreads)
    sbx[i] = box[bc * kBoxes * T + i];
  if (writeB)
    for (int i = threadIdx.x; i < kWarps * ns * 3; i += kThreads)
      sred[i] = 0.f;
  __syncthreads();

  const size_t ncell = (size_t)Ax * Ay * Az;
  const int rounds = (T + kWarps - 1) / kWarps;
  for (int rd = 0; rd < rounds; ++rd) {
    const int t = rd * kWarps + warp;
    if (t >= T) break;                     // no barrier follows in the loop
    const int s = t * kTile + lane;
    const float4 qa = sA[s];
    const bool live = __any_sync(0xffffffffu, qa.x < kPadMin);
    float a[kNLj], bb[kNLj];
    rows_a(c4, qa.w, a, bb);
    float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;   // en: unused
    for (int c = 0; live && c < T; ++c) {
      const float4* ch = sB + c * kTile;
      const unsigned m = window_mask(ch, sbx + c * kBoxes, qa, a, bb);
      if (writeA) sum_hits<false>(ch, m, qa, a, bb, fx, fy, fz, en);
      if (writeB) {
        unsigned hits = transpose32(m, lane);  // A lanes that hit slot b
        if (hits) {
          const float4 qb = ch[lane];
          float a2[kNLj], b2[kNLj];
          rows_b(c4, qb.w, a2, b2);
          float gx = 0.f, gy = 0.f, gz = 0.f;
          sum_hits<false>(sA + t * kTile, hits, qb, a2, b2, gx, gy, gz, en);
          float* r = sred + ((size_t)warp * ns + c * kTile + lane) * 3;
          r[0] += gx;
          r[1] += gy;
          r[2] += gz;
        }
      }
    }
    if (writeA && s < C) {
      const size_t ca = ((size_t)rax * Ay + ray) * Az + raz;
      float* w = part + ((size_t)o * ncell + ca) * 3 * C;
      w[s] = fx;
      w[C + s] = fy;
      w[2 * C + s] = fz;
    }
  }
  if (!writeB) return;
  __syncthreads();
  const size_t cb = ((size_t)rbx * Ay + rby) * Az + rbz;
  float* w = part + ((size_t)(kNOff - 1 + o) * ncell + cb) * 3 * C;
  for (int s = threadIdx.x; s < C; s += kThreads) {
    float gx = 0.f, gy = 0.f, gz = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      const float* r = sred + ((size_t)v * ns + s) * 3;
      gx += r[0];
      gy += r[1];
      gz += r[2];
    }
    w[s] = gx;
    w[C + s] = gy;
    w[2 * C + s] = gz;
  }
}

__global__ void lj_half_reduce(const float* __restrict__ part,
                               float* __restrict__ out, int C,
                               size_t ncell) {
  const size_t id = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= ncell * C) return;
  const size_t cell = id / C;
  const int t = (int)(id % C);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float f = 0.f;
    for (int s = 0; s < kNSlots; ++s)
      f += part[((size_t)s * ncell + cell) * 3 * C + (size_t)a * C + t];
    out[id * 3 + a] = f;
  }
}

}  // namespace

// P: [Dx, Dy, Dz, 8, C]; part: [27, Ax*Ay*Az, 3, C]; out: [Ax, Ay, Az,
// C, 3] over the a_range cells starting at (x0, y0, z0), which must leave
// one halo cell on every side; scratch: Dx * Dy * Dz * ceil(C / 32) * 144
// floats (the packed slots and group boxes).  C <= 1024 (shared memory
// above 48 KB is requested for the launch).
extern "C" int lpt_lj_cell_forces_half(const float* P, const float* cst,
                                       float* part, float* out, int Dy,
                                       int Dz, int C, int x0, int y0, int z0,
                                       int Ax, int Ay, int Az, void* stream,
                                       float* scratch, int Dx) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = (C + kTile - 1) / kTile;
  const int ncells = Dx * Dy * Dz;
  cudaError_t e = launch_pack(P, scratch, ncells, C, T, s);
  if (e != cudaSuccess) return (int)e;
  const size_t shmem = (2 * (size_t)T * kTile + kBoxes * T) * sizeof(float4) +
                       (size_t)kWarps * T * kTile * 3 * sizeof(float);
  if (shmem > 48 * 1024) {
    e = cudaFuncSetAttribute(lj_half_pairs,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Ax + 1) * (Ay + 1) * (Az + 1), kNOff);
  lj_half_pairs<<<grid, kThreads, shmem, s>>>(
      reinterpret_cast<const float4*>(scratch),
      reinterpret_cast<const float4*>(scratch + q_floats(ncells, T)), cst,
      part, Dy, Dz, C, T, x0, y0, z0, Ax, Ay, Az);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)Ax * Ay * Az * C;
  const int rthreads = 256;
  lj_half_reduce<<<(unsigned)((n + rthreads - 1) / rthreads), rthreads, 0,
                   s>>>(part, out, C, (size_t)Ax * Ay * Az);
  return (int)cudaGetLastError();
}
