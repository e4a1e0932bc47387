// Mirror combine: F_i = sum_k G[k, i] - sum_k mirv[k, i] * G_flat[mirT[k, i]].
//
// Replaces: lammps_plugins_tpu/ops/mirror_pallas.py::mirror_combine_rowfetch
// together with the layout pin ops/pin_rows.py::_pin_call it relies on.
// On the TPU the reverse-edge cotangents were fetched as whole rows of a
// layout-pinned atom-major [Np, Wr] table and the slot selected in the
// kernel; here the kernel reads the cotangent planes at mirT directly, so
// no pinned table exists.
//
// What bounds it on the H100: random 4-byte gathers, 3 x K x Np of them
// (~4.7M a step at 98k atoms, K=16), plus the coalesced plane reads.
//
// Design: one thread per atom, a loop over the K edge slots.  mirT keeps
// the JAX encoding slot*Np + atom.  No atomics: every force is written by
// one thread in a fixed order, so reruns are bit-identical.  Output rows
// are [Np, 3] (x, y, z per atom).

#include <cuda_runtime.h>

namespace {

__global__ void mirror_combine_kernel(const float* __restrict__ gx,
                                      const float* __restrict__ gy,
                                      const float* __restrict__ gz,
                                      const int* __restrict__ mirT,
                                      const float* __restrict__ mirv,
                                      float* __restrict__ out, int K,
                                      int Np) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Np) return;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int k = 0; k < K; ++k) {
    const size_t e = (size_t)k * Np + i;
    const size_t m = (size_t)mirT[e];
    const float mv = mirv[e];
    fx += gx[e] - mv * gx[m];
    fy += gy[e] - mv * gy[m];
    fz += gz[e] - mv * gz[m];
  }
  out[3 * (size_t)i + 0] = fx;
  out[3 * (size_t)i + 1] = fy;
  out[3 * (size_t)i + 2] = fz;
}

}  // namespace

extern "C" int lpt_mirror_combine(const float* gx, const float* gy,
                                  const float* gz, const int* mirT,
                                  const float* mirv, float* out, int K,
                                  int Np, void* stream) {
  const int threads = 256;
  const int blocks = (Np + threads - 1) / threads;
  mirror_combine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      gx, gy, gz, mirT, mirv, out, K, Np);
  return (int)cudaGetLastError();
}
