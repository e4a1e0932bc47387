// Block-sparse REBO reaction combine:
//   F_i = sum_k G[k, i] - R_i,
//   R_i = sum of G[k, j] over the routed edges (j, k) whose neighbour's
//         owner is i.
//
// Replaces: lammps_plugins_tpu/ops/react_pallas.py::react_combine, both of
// its Pallas calls (the stack phase _make_stack_kernel and the route phase
// _make_route_kernel; LPT_REACT).  The TPU kernel stacked each 128-atom
// chunk's routed source entries and summed them into its output lanes with
// one-hot [128, 128] products.  Here the routing is done once per rebuild:
// ops/react.py::route_by_target turns the route tables
// (build_route_tables) into a target-major table rtgt [Dt, Np] whose
// column i lists the flat plane indices k * Np + j of the entries aimed at
// atom i, in the route tables' order (window, route row, source column),
// -1 past the last.
//
// What bounds it on the H100: the bytes, like the mirror combine (B): the
// three [K, Np] planes, the [Dt, Np] table and the [Np, 3] output, each
// once; the routed reads of G are random 4-byte reads, mostly from L2.
//
// Design: one thread per output atom reads its own K slots and its Dt
// table entries (coalesced across the warp) and the G values they name,
// and writes sum_k G[k, i] - sum_d G[entry_d]: no shared memory, no
// atomics.  Each atom's routed entries are summed in the order in which
// the previous design's route-row scan (one block per chunk, every lane
// scanning the staged rows) met them, from zero, and the own slots
// likewise, so F is bit for bit the previous design's and reruns are
// bit-identical.  Output rows are [Np, 3].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
react_combine_kernel(const float* __restrict__ gx,
                     const float* __restrict__ gy,
                     const float* __restrict__ gz,
                     const int* __restrict__ rtgt, float* __restrict__ out,
                     int K, int Np, int Dt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Np) return;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  for (int d = 0; d < Dt; ++d) {
    const int e = rtgt[(size_t)d * Np + i];
    if (e < 0) break;                   // an atom's entries fill d = 0, 1..
    rx += gx[e];
    ry += gy[e];
    rz += gz[e];
  }
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)k * Np + i;
    sx += gx[e];
    sy += gy[e];
    sz += gz[e];
  }
  out[3 * (size_t)i + 0] = sx - rx;
  out[3 * (size_t)i + 1] = sy - ry;
  out[3 * (size_t)i + 2] = sz - rz;
}

}  // namespace

// gx/gy/gz: [K, Np] with K * Np < 2^31; rtgt: [Dt, Np] int32; out: [Np, 3].
extern "C" int lpt_react_combine(const float* gx, const float* gy,
                                 const float* gz, const int* rtgt, float* out,
                                 int K, int Np, int Dt, void* stream) {
  if (Np == 0) return 0;
  react_combine_kernel<<<(Np + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(gx, gy, gz, rtgt, out, K,
                                                 Np, Dt);
  return (int)cudaGetLastError();
}
