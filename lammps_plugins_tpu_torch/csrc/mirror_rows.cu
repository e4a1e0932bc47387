// Mirror combine from gathered rows:
//   F_i = sum_k G[k, i] - sum_k mirv[k, i] * gmir4[k, i, 0:3].
//
// Replaces: lammps_plugins_tpu/ops/mirror_pallas.py::mirror_combine_rows
// (the LPT_MIR=pk consumer).  On the TPU this kernel existed so that XLA's
// K-reduction could not re-fuse the row gather of the REBO kernel's
// interleaved [K, Np, 4] table (emit_rows) into slow element gathers; the
// gather itself (gmir4 = rows[mirT]) stays a torch index, as it stayed in
// XLA.
//
// What bounds it on the H100: HBM bandwidth, 9 x 4 bytes per edge slot
// (three planes, one float4 row, the validity plane: ~56 MB a step at 98k
// atoms, K = 16).
//
// Design: one thread per atom, a loop over the K edge slots; each gathered
// row is one 16-byte load, and across a warp consecutive atoms read
// consecutive rows.  No atomics: every force is written by one thread in a
// fixed order, so reruns are bit-identical.  Output rows are [Np, 3].

#include <cuda_runtime.h>

namespace {

__global__ void mirror_combine_rows_kernel(const float* __restrict__ gx,
                                           const float* __restrict__ gy,
                                           const float* __restrict__ gz,
                                           const float4* __restrict__ gmir4,
                                           const float* __restrict__ mirv,
                                           float* __restrict__ out, int K,
                                           int Np) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Np) return;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)k * Np + i;
    const float4 m = gmir4[e];
    const float mv = mirv[e];
    fx += gx[e] - m.x * mv;
    fy += gy[e] - m.y * mv;
    fz += gz[e] - m.z * mv;
  }
  out[3 * (size_t)i + 0] = fx;
  out[3 * (size_t)i + 1] = fy;
  out[3 * (size_t)i + 2] = fz;
}

}  // namespace

// gmir4: [K, Np, 4], 16-byte aligned.
extern "C" int lpt_mirror_combine_rows(const float* gx, const float* gy,
                                       const float* gz, const float* gmir4,
                                       const float* mirv, float* out, int K,
                                       int Np, void* stream) {
  const int threads = 256;
  const int blocks = (Np + threads - 1) / threads;
  mirror_combine_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gx, gy, gz, (const float4*)gmir4, mirv, out, K, Np);
  return (int)cudaGetLastError();
}
