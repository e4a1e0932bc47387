// Newton-half switched-LJ forces over the dense cell grid.
//
// Replaces: lammps_plugins_tpu/ops/lj_cells_pallas.py::lj_cell_forces_half
// (_lj_half_call, body _make_half_kernel; LPT_LJ_HALF).  Same physics as
// csrc/lj_cells.cu (pair_rebomos.cpp:518-543), but every unordered pair of
// neighbouring cells is evaluated once: the self cell plus the 13
// lexicographically positive offsets, 14 instead of 27.  Each evaluated
// pair adds fp * (x_a - x_b) to atom a and subtracts it from atom b.
//
// What bounds it on the H100: FP32 arithmetic, 14 x C^2 pair evaluations
// per A cell (about half of kernel C's), plus the warp reductions of the
// B-side sums.
//
// Design.  The TPU kernel accumulated the B-side forces across its
// sequential grid; blocks here run in no order, so nothing is accumulated
// across blocks and no float atomics are used:
//   * pass 1: one block per (A cell, offset o), blockDim = C rounded up to
//     32, one thread per A slot; the B cell (A + o) is staged in shared
//     memory.  For every B slot s the thread's pair term is added to its
//     A-side sum in registers; the B-side term of slot s is summed over
//     the warp by an xor butterfly (skipped when no lane of the warp has
//     the pair inside the LJ window) and lane 0 stores it in shared memory;
//     after the loop thread s sums its B slot over the warps in order.
//     Block (A, o) writes its A-side sums into partial slot o and its
//     B-side sums into slot 13 + o, each over the a_range grid: every
//     (slot, cell) has exactly one writer.
//   * pass 2: one thread per (a_range cell, C slot) sums the 27 partial
//     slots in a fixed order.  Reruns are bit-identical.
// The A cells of offset o span a_range extended by one cell on the side a
// pair can straddle (as lj_cells_pallas.py:319-327); a_range leaves one
// cell of the grid on every side, so both cells of every block exist, no
// index is clamped and no pair is evaluated twice.  A block whose A cell lies outside a_range
// writes no A-side sums, one whose B cell does writes no B-side sums; the
// self-cell block (o = 0) sees both slot orders of every in-cell pair and
// writes no B-side sums.  Self pairs (rsq = 0) and pad slots (parked at
// 1e7) fall outside the LJ window, which is tested before any rsqrt.
// Output [Ax, Ay, Az, C, 3], the JAX function's layout.

#include <cuda_runtime.h>

namespace {

// constant vector layout (ops/lj_cells.py: LJ_NAMES, 4 bilinear
// coefficients each)
enum { kLj1, kLj2, kLj3, kLj4, kLjMinSq, kLjMaxSq, kS95Sq, kLjMin, kK2, kK3,
       kC2, kC3, kNLj };

constexpr int kNOff = 14;
constexpr int kNSlots = 2 * kNOff - 1;
// the self cell, then the 13 offsets with (ox, oy, oz) > (0, 0, 0)
__constant__ int kOff[kNOff][3] = {
    {0, 0, 0},  {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},  {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

__global__ void lj_half_pairs(const float* __restrict__ P,
                              const float* __restrict__ cst,
                              float* __restrict__ part, int Dy, int Dz,
                              int C, int x0, int y0, int z0, int Ax, int Ay,
                              int Az) {
  extern __shared__ float sh[];    // [4, C] B cell, then [nwarps, C, 3]
  float* sred = sh + 4 * C;
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

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const bool act = t < C;
  const size_t abase =
      ((size_t)((x0 + rax) * Dy + (y0 + ray)) * Dz + (z0 + raz)) * 8 * C;
  const size_t bbase =
      ((size_t)((x0 + rbx) * Dy + (y0 + rby)) * Dz + (z0 + rbz)) * 8 * C;
  for (int s = t; s < 4 * C; s += blockDim.x) sh[s] = P[bbase + s];
  float xa = 0.f, ya = 0.f, za = 0.f, ea = 0.f;
  if (act) {
    xa = P[abase + 0 * C + t];
    ya = P[abase + 1 * C + t];
    za = P[abase + 2 * C + t];
    ea = P[abase + 3 * C + t];
  }
  // per-A-slot bilinear rows: value = pa + pb * e_b
  float pa[kNLj], pb[kNLj];
#pragma unroll
  for (int q = 0; q < kNLj; ++q) {
    pa[q] = cst[4 * q] + ea * cst[4 * q + 1];
    pb[q] = cst[4 * q + 2] + ea * cst[4 * q + 3];
  }
  __syncthreads();

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int s = 0; s < C; ++s) {
    const float dxm = xa - sh[s];
    const float dym = ya - sh[C + s];
    const float dzm = za - sh[2 * C + s];
    const float rsq = dxm * dxm + dym * dym + dzm * dzm;
    const float eb = sh[3 * C + s];
    const bool inwin = act && rsq >= pa[kLjMinSq] + pb[kLjMinSq] * eb &&
                       rsq <= pa[kLjMaxSq] + pb[kLjMaxSq] * eb;
    float fp = 0.f;
    if (inwin) {
      const float rinv = rsqrtf(rsq);
      const float r = rsq * rinv;
      const float r2inv = rinv * rinv;
      const float r6inv = r2inv * r2inv * r2inv;
      const float drp = r - (pa[kLjMin] + pb[kLjMin] * eb);
      if (rsq >= pa[kS95Sq] + pb[kS95Sq] * eb)
        fp = ((pa[kLj1] + pb[kLj1] * eb) * r6inv - (pa[kLj2] + pb[kLj2] * eb)) *
             r6inv * r2inv;
      else
        fp = drp * ((pa[kK3] + pb[kK3] * eb) * drp + (pa[kK2] + pb[kK2] * eb)) *
             rinv;
    }
    float px = fp * dxm, py = fp * dym, pz = fp * dzm;
    fx += px;
    fy += py;
    fz += pz;
    if (writeB) {
      if (__any_sync(0xffffffffu, inwin)) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          px += __shfl_xor_sync(0xffffffffu, px, m);
          py += __shfl_xor_sync(0xffffffffu, py, m);
          pz += __shfl_xor_sync(0xffffffffu, pz, m);
        }
      }
      if (lane == 0) {
        float* r = sred + ((size_t)warp * C + s) * 3;
        r[0] = px;
        r[1] = py;
        r[2] = pz;
      }
    }
  }
  __syncthreads();
  if (!act) return;
  const size_t ncell = (size_t)Ax * Ay * Az;
  if (writeA) {
    const size_t ca = ((size_t)rax * Ay + ray) * Az + raz;
    float* w = part + ((size_t)o * ncell + ca) * 3 * C;
    w[t] = fx;
    w[C + t] = fy;
    w[2 * C + t] = fz;
  }
  if (writeB) {
    float bx = 0.f, by = 0.f, bz = 0.f;
    for (int v = 0; v < nwarps; ++v) {
      const float* r = sred + ((size_t)v * C + t) * 3;
      bx += r[0];
      by += r[1];
      bz += r[2];
    }
    const size_t cb = ((size_t)rbx * Ay + rby) * Az + rbz;
    float* w = part + ((size_t)(kNOff - 1 + o) * ncell + cb) * 3 * C;
    w[t] = -bx;
    w[C + t] = -by;
    w[2 * C + t] = -bz;
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

// P: [Dx, Dy, Dz, 8, C]; part: scratch [27, Ax*Ay*Az, 3, C]; out:
// [Ax, Ay, Az, C, 3] over the a_range cells starting at (x0, y0, z0), which
// must leave one halo cell on every side.  C <= 640 (shared memory above
// 48 KB is requested for the launch).
extern "C" int lpt_lj_cell_forces_half(const float* P, const float* cst,
                                       float* part, float* out, int Dy,
                                       int Dz, int C, int x0, int y0, int z0,
                                       int Ax, int Ay, int Az, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = ((C + 31) / 32) * 32;
  const size_t shmem = (4 + 3 * (size_t)(threads / 32)) * C * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lj_half_pairs, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Ax + 1) * (Ay + 1) * (Az + 1), kNOff);
  lj_half_pairs<<<grid, threads, shmem, s>>>(P, cst, part, Dy, Dz, C, x0, y0,
                                             z0, Ax, Ay, Az);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t n = (size_t)Ax * Ay * Az * C;
  const int rthreads = 256;
  lj_half_reduce<<<(unsigned)((n + rthreads - 1) / rthreads), rthreads, 0,
                   s>>>(part, out, C, (size_t)Ax * Ay * Az);
  return (int)cudaGetLastError();
}
