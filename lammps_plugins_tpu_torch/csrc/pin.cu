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
// (19-25 MB read and as much written at 98k atoms, K = 16-20).
//
// Design: Hopper bulk copies.  Each block is one warp whose lane 0 moves
// kTile-byte tiles with cp.async.bulk, global -> shared completing on an
// mbarrier, then shared -> global as a bulk group, through kStages
// buffers; a buffer is reloaded once the store that read it has read it
// (cp.async.bulk.wait_group.read), so up to kStages - 1 loads and a store
// are in flight per block, kBlocksPerSM blocks on each SM.  The
// destination starts on a 16-byte boundary after a head of up to 3
// elements.  A source that is then not 16-byte aligned (an offset view)
// cannot be read by a bulk copy: its tiles are read by the warp's lanes
// into shared memory and written by the same bulk store.  Head and tail
// (at most 3 elements each) are copied by block 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// 8 KB tiles, 4 stages, 6 blocks on each SM (6 x 32 KB of shared memory):
// the fastest of 8/16/32 KB tiles at 3-6 stages and 2-6 blocks per SM on
// the [K, 3 Np], [R, 128] and [Np, Wr] shapes of the bench scene
constexpr int kStages = 4;
constexpr int kTile = 8192;         // bytes
constexpr int kThreads = 32;
constexpr int kBlocksPerSM = 6;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

template <bool kBulkIn>
__global__ void __launch_bounds__(kThreads) pin_copy_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long head,
    long long nbytes, long long n) {
  extern __shared__ __align__(128) char buf[];
  __shared__ __align__(8) unsigned long long bar[kStages];
  const int lane = threadIdx.x;
  if (blockIdx.x == 0) {
    if (lane < head) out[lane] = in[lane];
    const long long tail = head + nbytes / 4 + lane;
    if (lane < 4 && tail < n) out[tail] = in[tail];
  }
  const char* src = reinterpret_cast<const char*>(in + head);
  char* dst = reinterpret_cast<char*>(out + head);
  const long long ntiles = (nbytes + kTile - 1) / kTile;
  const long long stride = gridDim.x;
  auto bytes_of = [&](long long t) -> uint32_t {
    const long long rem = nbytes - t * kTile;
    return (uint32_t)(rem < kTile ? rem : kTile);
  };
  if (!kBulkIn) {
    // lanes read the tile (4-byte loads), the bulk store writes it
    for (long long t = blockIdx.x; t < ntiles; t += stride) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
      const float* s = reinterpret_cast<const float*>(src + t * kTile);
      float* b = reinterpret_cast<float*>(buf);
      for (uint32_t q = lane; q < bytes_of(t) / 4; q += kThreads) b[q] = s[q];
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) bulk_store(dst + t * kTile, smem(buf), bytes_of(t));
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }
  if (lane != 0) return;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem(&bar[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int s = 0; s < kStages; ++s) {
    const long long t = blockIdx.x + s * stride;
    if (t < ntiles)
      bulk_load(smem(buf + s * kTile), src + t * kTile, bytes_of(t),
                smem(&bar[s]));
  }
  for (long long it = 0;; ++it) {
    const long long t = blockIdx.x + it * stride;
    if (t >= ntiles) break;
    const int s = (int)(it % kStages);
    wait_parity(smem(&bar[s]), (uint32_t)((it / kStages) & 1));
    bulk_store(dst + t * kTile, smem(buf + s * kTile), bytes_of(t));
    // reload the previous iteration's buffer once its store has read it
    if (it > 0) {
      const long long nt = blockIdx.x + (it - 1 + kStages) * stride;
      if (nt < ntiles) {
        const int ps = (int)((it - 1) % kStages);
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        bulk_load(smem(buf + ps * kTile), src + nt * kTile, bytes_of(nt),
                  smem(&bar[ps]));
      }
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <bool kBulkIn>
int launch(const float* in, float* out, long long head, long long nbytes,
           long long n, cudaStream_t s) {
  // the shared-memory attribute and the SM count are the current
  // device's: both kept a device
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        pin_copy_kernel<kBulkIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStages * kTile);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  int& sms = sm_count[dev];
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  long long blocks = (nbytes + kTile - 1) / kTile;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms * kBlocksPerSM;
  if (blocks < 1) blocks = 1;
  pin_copy_kernel<kBulkIn><<<(int)blocks, kThreads, kStages * kTile, s>>>(
      in, out, head, nbytes, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lpt_pin_copy(const float* in, float* out, int R, int L,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)R * L;
  if (n <= 0) return 0;
  // elements before `out` reaches a 16-byte boundary (floats are 4-aligned)
  long long head = (long long)((16 - ((size_t)out & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long nbytes = (n - head) / 4 * 16;
  if ((((size_t)(in + head)) & 15) == 0)
    return launch<true>(in, out, head, nbytes, n, s);
  return launch<false>(in, out, head, nbytes, n, s);
}
