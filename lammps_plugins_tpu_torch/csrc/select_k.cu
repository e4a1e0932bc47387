// Smallest-K selection per row, with payloads at the chosen columns.
//
// Replaces: lammps_plugins_tpu/ops/select_k_pallas.py::select_k (body
// _make_kernel), which compacts each atom's ~650-768 cell-window
// candidates to its K nearest in the device neighbor rebuild.
// Semantics: per row, the column positions of the K smallest keys in
// ascending order; ties go to the lowest column, one extraction per round
// (duplicates survive as in a stable sort); exhausted rounds (only +inf
// left) give pos = W and payload 0.
//
// What bounds it on the H100: reading the [N, W] keys once (~300 MB at
// 98k atoms, W = 768) plus K rounds of warp-wide reductions.
//
// Design: one warp per row.  Each lane holds PL = W/32 keys in registers
// (column j*32 + lane, so the load is coalesced); each round is a lane-local
// argmin then a __shfl_xor_sync butterfly on (value, column) with the lower
// column winning ties; the winning lane sets its key to +inf and lane 0
// writes the position and reads the payloads at that column.  PL is a
// template parameter (4..32, W <= 1024); the wrapper rejects wider rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int PL>
__global__ void select_k_kernel(const float* __restrict__ keys,
                                const float* __restrict__ pay0,
                                const float* __restrict__ pay1, int npay,
                                int* __restrict__ pos, float* __restrict__ out0,
                                float* __restrict__ out1, int N, int W,
                                int K) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;                  // warp-uniform exit
  const size_t rbase = (size_t)row * W;
  float v[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int col = j * 32 + lane;
    v[j] = col < W ? keys[rbase + col] : INFINITY;
  }
  for (int k = 0; k < K; ++k) {
    float bv = INFINITY;
    int bc = W;
#pragma unroll
    for (int j = 0; j < PL; ++j) {       // ascending columns: keeps lowest
      if (v[j] < bv) {
        bv = v[j];
        bc = j * 32 + lane;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ov < bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    const bool found = bv < INFINITY;
    if (found && (bc & 31) == lane) {
#pragma unroll
      for (int j = 0; j < PL; ++j)
        if (j == (bc >> 5)) v[j] = INFINITY;
    }
    if (lane == 0) {
      const size_t o = (size_t)row * K + k;
      pos[o] = found ? bc : W;
      if (npay > 0) out0[o] = found ? pay0[rbase + bc] : 0.f;
      if (npay > 1) out1[o] = found ? pay1[rbase + bc] : 0.f;
    }
  }
}

template <int PL>
int launch(const float* keys, const float* p0, const float* p1, int npay,
           int* pos, float* o0, float* o1, int N, int W, int K,
           cudaStream_t s) {
  const int threads = 256;               // 8 rows per block
  const int blocks = (int)(((size_t)N * 32 + threads - 1) / threads);
  select_k_kernel<PL><<<blocks, threads, 0, s>>>(keys, p0, p1, npay, pos, o0,
                                                 o1, N, W, K);
  return (int)cudaGetLastError();
}

}  // namespace

// W must be a multiple of 128 and at most 1024; returns -1 otherwise.
extern "C" int lpt_select_k(const float* keys, const float* pay0,
                            const float* pay1, int npay, int* pos,
                            float* out0, float* out1, int N, int W, int K,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (W / 32) {
    case 4: return launch<4>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 8: return launch<8>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 12: return launch<12>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 16: return launch<16>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 20: return launch<20>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 24: return launch<24>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 28: return launch<28>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    case 32: return launch<32>(keys, pay0, pay1, npay, pos, out0, out1, N, W, K, s);
    default: return -1;
  }
}
