// Identity copy of a contiguous 2-D float32 array [R, L].
//
// Replaces: lammps_plugins_tpu/ops/pin_rows.py::_pin_call (used by
// pin_rows3, and standalone for the row-fetch table) and ::_pin2_call (used
// by pin_rows3_v2).  On the TPU the copy was a Pallas custom call whose
// only job was to pin its operand to a dense row-major layout, so that the
// downstream mirror gather ran in XLA's fast row-gather class.  A CUDA
// tensor has one layout already; the copy is kept as a kernel so that the
// port's pin configurations run the same data flow as the JAX package.
//
// What bounds it on the H100: HBM bandwidth, 8 bytes moved per element
// (~38 MB read + write at 98k atoms, K = 16, for [K, 3 Np]).
//
// Design: a flat grid-stride copy of R * L elements, 16 bytes a thread per
// iteration when both pointers are 16-byte aligned, then a scalar tail.

#include <cuda_runtime.h>

namespace {

__global__ void pin_copy_vec4(const float4* __restrict__ in,
                              float4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride)
    out[i] = in[i];
}

__global__ void pin_copy_scalar(const float* __restrict__ in,
                                float* __restrict__ out, long long start,
                                long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = in[i];
}

}  // namespace

extern "C" int lpt_pin_copy(const float* in, float* out, int R, int L,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)R * L;
  const int threads = 256;
  const int max_blocks = 132 * 16;
  long long done = 0;
  if ((((size_t)in | (size_t)out) & 15) == 0) {
    const long long n4 = n / 4;
    if (n4 > 0) {
      const long long want = (n4 + threads - 1) / threads;
      const int blocks = (int)(want < max_blocks ? want : max_blocks);
      pin_copy_vec4<<<blocks, threads, 0, s>>>((const float4*)in,
                                                 (float4*)out, n4);
    }
    done = n4 * 4;
  }
  if (done < n) {
    const long long want = (n - done + threads - 1) / threads;
    const int blocks = (int)(want < max_blocks ? want : max_blocks);
    pin_copy_scalar<<<blocks, threads, 0, s>>>(in, out, done, n);
  }
  return (int)cudaGetLastError();
}
