// lj/cut and lj/cut/coul/cut forces from each atom's own full-list row
// (kernel I).
//
// Replaces: the [N, K] edge sweep of potentials/ljcut.py in torch ops
// (the x_all[idx] gather, dx/dy/dz/rsq and the masks as [N, K] tensors,
// the type-pair table gathers) and neighbor.mirror_combine (the stacked
// [N*K, 3] cotangents, a zero row concatenated, the mirror-edge gather).
// No TPU kernel precedes it: the JAX package's lj/cut is XLA ops.
//
// Physics: F_i = sum_k 2 e'(r^2) (x_j - x_i) over the live slots of row
// i, e' = r2inv r6inv (3 lj4 - 6 lj3 r6inv), live = mask && r^2 <
// cutsq[ti * T + tj]; with kCoul the Coulomb term -qqr2e q_i q_j /
// (2 r^3) where r^2 < cut_coul^2.  This is LAMMPS's `newton off` sum
// over a full list; in exact arithmetic it equals the mirror combine
// sum_k G[i,k] - sum_k G[mirror(i,k)], since each mirror edge carries -G.
//
// What bounds it on the H100: reading the list once (idx int64 and mask,
// 9 bytes a slot: ~0.93 GB at in.lj's 864,000 atoms and K = 120) and the
// neighbour positions, gathered as float4 from a table of ~16 MB that
// stays in L2.  The arithmetic is ~25 flops a live slot.
//
// Design:
//   * a first pass writes the [N + Mg] float4 table (x, y, z, type bits):
//     the owned rows, then each ghost g at x[owner[g]] + shift[g] @ h, each
//     product and sum rounded on its own (no fused multiply-add), so the
//     table equals the torch ops' x_all bit for bit; with kCoul also the
//     [N + Mg] charges;
//   * the sweep gives each atom kLanes = 8 lanes, lane l taking slots l,
//     l + 8, ... of the row [N, K]: eight consecutive int64 of idx are
//     read together, so the list is read once and coalesced without the
//     [K, Np] transposes.  The lane count is fixed, not sized from K: the
//     order of the sums then depends on the row's slots alone, so a list
//     re-sized to another K (which the graph and the eager loops may do at
//     different steps) gives the same bits.  At in.lj's 864,000 atoms and
//     K = 120 on an H100, 4, 8, 16 and 32 lanes took 0.438, 0.407, 0.491
//     and 0.608 ms;
//   * the three [T*T] coefficient tables sit in shared memory (any T that
//     fits; the wrapper refuses more);
//   * each slot's r^2, e' and e' d are the twin's floats (round-to-nearest
//     intrinsics in the twin's order, no contraction), so the cut-off test
//     decides as the twin's does; the lanes' partial sums meet in a fixed
//     xor tree of shuffles.
// No atomics and a fixed order: reruns, and the graph and eager loops,
// agree bit for bit.  Both passes launch on the caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                  // lanes an atom

template <bool kCoul>
__global__ void ljcut_table_kernel(const float* __restrict__ x,
                                   const int64_t* __restrict__ types,
                                   const int64_t* __restrict__ owner,
                                   const float* __restrict__ shift,
                                   const float* __restrict__ h,
                                   const float* __restrict__ q,
                                   float4* __restrict__ table,
                                   float* __restrict__ q_all, int N,
                                   int Mg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N + Mg) return;
  int o = r;
  float p[3];
  if (r < N) {
    for (int a = 0; a < 3; ++a) p[a] = x[3 * (size_t)r + a];
  } else {
    const size_t g = r - N;
    o = (int)owner[g];
    const float s0 = shift[3 * g], s1 = shift[3 * g + 1],
                s2 = shift[3 * g + 2];
    for (int a = 0; a < 3; ++a) {
      const float c = __fadd_rn(
          __fadd_rn(__fmul_rn(s0, h[a]), __fmul_rn(s1, h[3 + a])),
          __fmul_rn(s2, h[6 + a]));
      p[a] = __fadd_rn(x[3 * (size_t)o + a], c);
    }
  }
  table[r] = make_float4(p[0], p[1], p[2], __int_as_float((int)types[o]));
  if (kCoul) q_all[r] = q[o];
}

template <bool kCoul>
__global__ void __launch_bounds__(kThreads) ljcut_kernel(
    const float4* __restrict__ table, const float* __restrict__ q_all,
    const int64_t* __restrict__ idx, const bool* __restrict__ mask,
    const float* __restrict__ lj3, const float* __restrict__ lj4,
    const float* __restrict__ cutsq, float* __restrict__ out, int N, int K,
    int T, float cut_coulsq, float qqr2e) {
  extern __shared__ float s_tab[];          // lj3 | lj4 | cutsq
  const int TT = T * T;
  for (int t = threadIdx.x; t < TT; t += kThreads) {
    s_tab[t] = lj3[t];
    s_tab[TT + t] = lj4[t];
    s_tab[2 * TT + t] = cutsq[t];
  }
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (i < N) {
    const float4 xi = table[i];
    const int ti = __float_as_int(xi.w) * T;
    const float qi = kCoul ? q_all[i] : 0.f;
    const int64_t* row = idx + (size_t)i * K;
    const bool* live = mask + (size_t)i * K;
    for (int k = lane; k < K; k += kLanes) {
      if (!live[k]) continue;
      const int64_t j = row[k];
      const float4 xj = __ldg(table + j);
      const float dx = __fsub_rn(xj.x, xi.x), dy = __fsub_rn(xj.y, xi.y),
                  dz = __fsub_rn(xj.z, xi.z);
      const float rsq = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
      const int flat = ti + __float_as_int(xj.w);
      float de = 0.f;
      if (rsq < s_tab[2 * TT + flat]) {
        const float r2inv = __fdiv_rn(1.f, rsq);
        const float r6inv = __fmul_rn(__fmul_rn(r2inv, r2inv), r2inv);
        de = __fmul_rn(
            __fmul_rn(r2inv, r6inv),
            __fsub_rn(__fmul_rn(3.f, s_tab[TT + flat]),
                      __fmul_rn(__fmul_rn(6.f, s_tab[flat]), r6inv)));
      }
      if (kCoul && rsq < cut_coulsq) {
        const float ecoul = __fdiv_rn(
            __fmul_rn(qqr2e, __fmul_rn(qi, q_all[j])), __fsqrt_rn(rsq));
        de = __fadd_rn(de, __fdiv_rn(__fmul_rn(-0.5f, ecoul), rsq));
      }
      fx = __fadd_rn(fx, __fmul_rn(de, dx));
      fy = __fadd_rn(fy, __fmul_rn(de, dy));
      fz = __fadd_rn(fz, __fmul_rn(de, dz));
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    fx += __shfl_xor_sync(0xffffffffu, fx, off);
    fy += __shfl_xor_sync(0xffffffffu, fy, off);
    fz += __shfl_xor_sync(0xffffffffu, fz, off);
  }
  if (i < N && lane == 0) {
    out[3 * (size_t)i + 0] = 2.f * fx;
    out[3 * (size_t)i + 1] = 2.f * fy;
    out[3 * (size_t)i + 2] = 2.f * fz;
  }
}

template <bool kCoul>
int launch(const float* x, const int64_t* types, const int64_t* owner,
           const float* shift, const float* h, const int64_t* idx,
           const bool* mask, const float* lj3, const float* lj4,
           const float* cutsq, const float* q, float* out, float4* table,
           float* q_all, int N, int Mg, int K, int T, float cut_coulsq,
           float qqr2e, cudaStream_t s) {
  const int rows = N + Mg;
  if (rows > 0)
    ljcut_table_kernel<kCoul><<<(rows + kThreads - 1) / kThreads, kThreads,
                                0, s>>>(x, types, owner, shift, h, q, table,
                                        q_all, N, Mg);
  if (N == 0) return (int)cudaGetLastError();
  const size_t shared = 3 * (size_t)T * T * sizeof(float);
  const int atoms = kThreads / kLanes;
  if (shared > 48 * 1024)
    cudaFuncSetAttribute(ljcut_kernel<kCoul>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shared);
  ljcut_kernel<kCoul><<<(N + atoms - 1) / atoms, kThreads, shared, s>>>(
      table, q_all, idx, mask, lj3, lj4, cutsq, out, N, K, T, cut_coulsq,
      qqr2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lpt_ljcut_forces(const float* x, const int64_t* types,
                                const int64_t* owner, const float* shift,
                                const float* h, const int64_t* idx,
                                const bool* mask, const float* lj3,
                                const float* lj4, const float* cutsq,
                                const float* q, float* out, float* table,
                                float* q_all, int N, int Mg, int K, int T,
                                float cut_coulsq, float qqr2e,
                                void* stream) {
  auto* t4 = reinterpret_cast<float4*>(table);
  auto s = (cudaStream_t)stream;
  return q != nullptr
             ? launch<true>(x, types, owner, shift, h, idx, mask, lj3, lj4,
                            cutsq, q, out, t4, q_all, N, Mg, K, T,
                            cut_coulsq, qqr2e, s)
             : launch<false>(x, types, owner, shift, h, idx, mask, lj3, lj4,
                             cutsq, q, out, t4, q_all, N, Mg, K, T,
                             cut_coulsq, qqr2e, s);
}
