// Block-sparse REBO reaction combine:
//   F_i = sum_k G[k, i] - R_i,
//   R_i = sum of G[k, j] over the routed edges (j, k) whose neighbour's
//         owner is i.
//
// Replaces: lammps_plugins_tpu/ops/react_pallas.py::react_combine, both of
// its Pallas calls (the stack phase _make_stack_kernel and the route phase
// _make_route_kernel; LPT_REACT).  The rebuild-time tables are those of
// build_route_tables (ops/react.py): for each 128-atom output chunk c,
// rblocks[c, w] names the w-th 128-column source block, and
// route[c, w, kc, col] = (k << 8) | lane is the kc-th edge from source
// column col of that block into output lane `lane` of chunk c (-1: none).
//
// What bounds it on the H100: shared-memory broadcast reads of the route
// scan, 128 entries per routed row for every output lane (~rq x 128 x 128
// per chunk), and the random 4-byte reads of G at the routed slots.
//
// Design.  The TPU selected each window's entries by a K-deep where-chain,
// stacked them at packed row offsets (qoff) in scratch and routed them
// with a one-hot [128, 128] compare-accumulate.  Here one block of 128
// threads serves one output chunk: for each window and each route row
// kc, thread `col` decodes its route entry and reads (gx, gy, gz)[k] of
// its source column directly (no k-select), and stores (value, lane) as
// one float4 in shared memory; then every thread, as output lane t, scans
// the row's 128 entries and adds those aimed at t.  The stack never exists
// as a whole (it would be up to 254 KB per chunk, above a block's shared
// memory), so the packed offsets are not needed.  A route row with no
// valid entry ends its window: a source column's edges into one chunk fill
// depths 0, 1, ... without gaps.  Every row is staged afresh and invalid
// entries carry lane -1, which no thread matches, so no stale entry of an
// earlier chunk or window can route.  Each lane sums in a fixed
// (window, row, column) order and owns its output: no atomics, reruns are
// bit-identical.  Output rows are [Np, 3].

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;

__global__ void react_combine_kernel(const float* __restrict__ gx,
                                     const float* __restrict__ gy,
                                     const float* __restrict__ gz,
                                     const int* __restrict__ rblocks,
                                     const int* __restrict__ route,
                                     float* __restrict__ out, int K, int Np,
                                     int NW, int KC) {
  __shared__ float4 ent[kChunk];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  for (int w = 0; w < NW; ++w) {
    const size_t src = (size_t)rblocks[(size_t)c * NW + w] * kChunk + t;
    for (int kc = 0; kc < KC; ++kc) {
      const int r = route[(((size_t)c * NW + w) * KC + kc) * kChunk + t];
      float4 e = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      if (r >= 0) {
        const size_t g = (size_t)(r >> 8) * Np + src;
        e = make_float4(gx[g], gy[g], gz[g], __int_as_float(r & 255));
      }
      ent[t] = e;
      if (!__syncthreads_or(r >= 0)) break;
      for (int q = 0; q < kChunk; ++q) {
        const float4 v = ent[q];
        if (__float_as_int(v.w) == t) {
          rx += v.x;
          ry += v.y;
          rz += v.z;
        }
      }
      __syncthreads();
    }
  }
  const size_t i = (size_t)c * kChunk + t;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)k * Np + i;
    sx += gx[e];
    sy += gy[e];
    sz += gz[e];
  }
  out[3 * i + 0] = sx - rx;
  out[3 * i + 1] = sy - ry;
  out[3 * i + 2] = sz - rz;
}

}  // namespace

// gx/gy/gz: [K, Np] with Np = 128 * nch; rblocks: [nch, NW] int32;
// route: [nch, NW, KC, 128] int32; out: [Np, 3].
extern "C" int lpt_react_combine(const float* gx, const float* gy,
                                 const float* gz, const int* rblocks,
                                 const int* route, float* out, int K, int Np,
                                 int NW, int KC, void* stream) {
  react_combine_kernel<<<Np / kChunk, kChunk, 0, (cudaStream_t)stream>>>(
      gx, gy, gz, rblocks, route, out, K, Np, NW, KC);
  return (int)cudaGetLastError();
}
