// Smallest-K selection per row (D), and the neighbor rebuild's candidate
// selection fused with the making of its keys (D').
//
// Replaces: lammps_plugins_tpu/ops/select_k_pallas.py::select_k (body
// _make_kernel), which compacts each atom's cell-window candidates to its
// K nearest in the device neighbor rebuild.  The TPU kernel read keys that
// the rebuild had built in device memory; D keeps that interface, D' takes
// the rebuild's fine-cell table instead and never writes a key.
// Semantics: per row, the column positions of the K smallest keys in
// ascending order; ties go to the lowest column (a stable sort); exhausted
// slots (only +inf left) give pos = W and payload 0.
//
// What bounds them on the H100.  D: reading the [N, W] keys once (~200 MB
// at 98k atoms, W = 512).  D': its outputs (the [n, K] int64 index and
// type lists); its inputs are the fine-cell table and the positions, a few
// MB, read once per neighbouring cell from L2.
//
// The selection core (select_row), shared: a warp counts the row's hits
// (finite keys; for D' the candidates inside the cutoff window) with a
// ballot per step and puts the first kBuf = 256 into a per-warp buffer in
// shared memory at their prefix popcount.  A row of at most 32 hits (every
// row of the REBOMOS bench rebuild: at most 12-20 of 432 candidates) is
// sorted by (key, column) in one bitonic sort over the lanes' shuffles, and
// lane k writes output k.  A row of 33 to 256 hits (the AEAM rebuild: ~115
// hits inside 7.7 A among ~1,000 staged candidates, K = 144) is sorted in
// the buffer by one bitonic sort over the next power of two of its hit
// count, the warp's lanes taking the compare-exchanges of each step, and
// lane k % 32 writes output k.  A row of more hits than the buffer holds
// (only when kmax > K, a rebuild the Engine discards) takes K rounds of a
// warp argmin, each taking the least pair after the previous round's from
// the row itself (D: the keys still in registers; D': the staged
// candidates, recomputed), round k's column staying in lane k % 32.  Every
// way, the lanes write their outputs and read their payloads at once: the
// stores are coalesced and no lane walks the K outputs alone.  No list of W
// entries is kept: a block's buffers take 8 KB of shared memory.
//
// D: one warp per row, each lane loading W/128 float4 of keys.  D': one
// 128-thread block per fine cell; the real atoms among its 27 neighbour
// cells' slots (ids, then x, y, z, type by cp.async from the position
// table) are staged in shared memory, compacted by a ballot and one shared
// atomic per warp step, each with its column o * Cf + s (offset o of
// offs27, (a, b, c) lexicographic over {-1, 0, 1}, and slot s) packed into
// a tag beside its index; out-of-range cells are empty.  One warp per
// owned atom of the cell (taken from an owned-atoms-by-cell order, so an
// atom that the capped cell table dropped still gets its row) computes
// rsq = ((0 + dx^2) + dy^2) + dz^2 with dx = x_cand - x_centre in
// round-to-nearest intrinsics (no FMA contraction, so rsq and its ties are
// those of the PyTorch twin bit for bit), tests valid (id < m_all and
// id != own id) and rsq < cut * cut, and selects.  Nothing [n, W]-sized
// exists.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;               // rows (D) or atoms (D') at once
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 256;              // outputs per row: kMaxK / 32 a lane
constexpr int kBuf = 256;               // per-warp buffer of a row's hits
constexpr int kMaxTypes = 16;           // D': cutoff table (T + 1)^2

// (a, ca) comes before (b, cb): by key, ties to the lower column
__device__ __forceinline__ bool before(float a, int ca, float b, int cb) {
  return a < b || (a == b && ca < cb);
}

// ascending bitonic sort of one (key, column) pair per lane
__device__ __forceinline__ void bitonic32(float& k, int& c, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ok = __shfl_xor_sync(kFull, k, stride);
      const int oc = __shfl_xor_sync(kFull, c, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      if (keep_min == before(ok, oc, k, c)) {
        k = ok;
        c = oc;
      }
    }
  }
}

// Fold (v, c) into (bk, bc) if it comes after (lk, lc) and before (bk, bc).
__device__ __forceinline__ void take_if_next(float v, int c, float lk,
                                             int lc, float& bk, int& bc) {
  if (before(lk, lc, v, c) && before(v, c, bk, bc)) {
    bk = v;
    bc = c;
  }
}

// Ascending bitonic sort of the n2 (a power of two, 64 <= n2 <= kBuf)
// (key, tag) pairs of a warp's buffer: each step's n2 / 2 compare-exchanges
// (i, i + stride) shared among the lanes, a __syncwarp between steps.
__device__ __forceinline__ void bitonic_buffer(float* bk, int* bc, int n2,
                                               int lane) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float ki = bk[i], kj = bk[j];
        const int ci = bc[i], cj = bc[j];
        if (before(kj, cj, ki, ci) == ((i & size) == 0)) {
          bk[i] = kj;
          bc[i] = cj;
          bk[j] = ki;
          bc[j] = ci;
        }
      }
      __syncwarp();
    }
  }
}

// The K smallest (key, tag) pairs of a row in order: emit(k, tag) for
// k < K, tag -1 once the row's hits are spent (tags distinct, >= 0).  nh:
// the row's hit count; the warp's kBuf-entry buffer (bk, bc) holds its
// first kBuf hits.  nh <= 32: lane q takes entry q, one bitonic sort over
// the lanes orders them and lane k emits output k.  nh <= kBuf: the buffer,
// padded to a power of two, is sorted in place and lane k % 32 emits output
// k.  Otherwise K rounds of a warp argmin, each taking the least pair after
// the previous round's: scan(lk, lc, best_k, best_c) folds the lane's share
// of the row's hits, read again from the row, into (best_k, best_c); round
// k's tag stays in lane k % 32, and the lanes emit together at the end.
// Warp-uniform; the buffer is free again when it returns.
template <typename Scan, typename Emit>
__device__ __forceinline__ void select_row(float* bk, int* bc, int nh, int K,
                                           int lane, Scan scan, Emit emit) {
  if (nh <= 32) {
    float k = INFINITY;
    int c = INT_MAX;
    if (lane < nh) {
      k = bk[lane];
      c = bc[lane];
    }
    bitonic32(k, c, lane);
    for (int q = lane; q < K; q += 32) emit(q, q < nh ? c : -1);
    __syncwarp();
    return;
  }
  if (nh <= kBuf) {
    int n2 = 64;
    while (n2 < nh) n2 <<= 1;
    for (int q = nh + lane; q < n2; q += 32) {
      bk[q] = INFINITY;
      bc[q] = INT_MAX;
    }
    __syncwarp();
    bitonic_buffer(bk, bc, n2, lane);
    for (int q = lane; q < K; q += 32) emit(q, q < nh ? bc[q] : -1);
    __syncwarp();
    return;
  }
  int sel[kMaxK / 32];
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s) sel[s] = -1;
  float lk = -INFINITY;
  int lc = -1;
  for (int r = 0; r < K; ++r) {
    float best_k = INFINITY;
    int best_c = INT_MAX;
    scan(lk, lc, best_k, best_c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best_k, off);
      const int oc = __shfl_xor_sync(kFull, best_c, off);
      if (before(ov, oc, best_k, best_c)) {
        best_k = ov;
        best_c = oc;
      }
    }
    if (best_c == INT_MAX) break;       // the row's hits are spent
    lk = best_k;
    lc = best_c;
#pragma unroll
    for (int s = 0; s < kMaxK / 32; ++s)
      if (s == (r >> 5) && lane == (r & 31)) sel[s] = best_c;
  }
#pragma unroll
  for (int s = 0; s < kMaxK / 32; ++s)
    if (s * 32 + lane < K) emit(s * 32 + lane, sel[s]);
}

// count this lane's hit and, among the row's first kBuf, put it in the
// warp's buffer (ballot + prefix popcount)
__device__ __forceinline__ void push_hit(bool hit, float key, int tag,
                                         float* bk, int* bc, int& nh,
                                         unsigned lanes_below) {
  const unsigned m = __ballot_sync(kFull, hit);
  if (hit) {
    const int p = nh + __popc(m & lanes_below);
    if (p < kBuf) {
      bk[p] = key;
      bc[p] = tag;
    }
  }
  nh += __popc(m);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

// ---- D: rows of keys in device memory -----------------------------------

template <int V>   // float4 of keys per lane: W = 128 V
__global__ void __launch_bounds__(kThreads)
select_k_kernel(const float* __restrict__ keys,
                const float* __restrict__ pay0,
                const float* __restrict__ pay1, int npay,
                int* __restrict__ pos, float* __restrict__ out0,
                float* __restrict__ out1, int N, int K) {
  constexpr int W = 128 * V;
  __shared__ float buf_k[kWarps][kBuf];
  __shared__ int buf_c[kWarps][kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;                  // warp-uniform; no block barrier
  const size_t rbase = (size_t)row * W;
  const float4* k4 = reinterpret_cast<const float4*>(keys + rbase);
  float4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __ldcs(k4 + j * 32 + lane);
  const unsigned below = (1u << lane) - 1u;
  float* bk = buf_k[warp];
  int* bc = buf_c[warp];
  int nh = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c0 = 4 * (j * 32 + lane);
    push_hit(v[j].x < INFINITY, v[j].x, c0 + 0, bk, bc, nh, below);
    push_hit(v[j].y < INFINITY, v[j].y, c0 + 1, bk, bc, nh, below);
    push_hit(v[j].z < INFINITY, v[j].z, c0 + 2, bk, bc, nh, below);
    push_hit(v[j].w < INFINITY, v[j].w, c0 + 3, bk, bc, nh, below);
  }
  __syncwarp();
  // a finite key is a hit; +inf and NaN never are (the twin's rule)
  auto scan = [&](float lk, int lc, float& best_k, int& best_c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c0 = 4 * (j * 32 + lane);
      if (v[j].x < INFINITY)
        take_if_next(v[j].x, c0 + 0, lk, lc, best_k, best_c);
      if (v[j].y < INFINITY)
        take_if_next(v[j].y, c0 + 1, lk, lc, best_k, best_c);
      if (v[j].z < INFINITY)
        take_if_next(v[j].z, c0 + 2, lk, lc, best_k, best_c);
      if (v[j].w < INFINITY)
        take_if_next(v[j].w, c0 + 3, lk, lc, best_k, best_c);
    }
  };
  select_row(bk, bc, nh, K, lane, scan, [&](int k, int col) {
    const size_t o = (size_t)row * K + k;
    pos[o] = col >= 0 ? col : W;
    if (npay > 0) out0[o] = col >= 0 ? pay0[rbase + col] : 0.f;
    if (npay > 1) out1[o] = col >= 0 ? pay1[rbase + col] : 0.f;
  });
}

template <int V>
int launch_d(const float* keys, const float* p0, const float* p1, int npay,
             int* pos, float* o0, float* o1, int N, int K, cudaStream_t s) {
  const int blocks = (N + kWarps - 1) / kWarps;
  select_k_kernel<V><<<blocks, kThreads, 0, s>>>(keys, p0, p1, npay, pos, o0,
                                                 o1, N, K);
  return (int)cudaGetLastError();
}

// ---- D': candidates from the fine-cell table ----------------------------

// D': candidate q of the staged list against the centre (ci, own id i):
// (hit, rsq) with rsq = ((0 + dx^2) + dy^2) + dz^2 rounded as the twin's
// separate torch ops round it, and hit = id != i and rsq < cut * cut.
__device__ __forceinline__ bool candidate_hit(const float4* xs,
                                              const int* ids, int q, int i,
                                              float4 ci, const float* crow,
                                              float& rsq) {
  if (ids[q] == i) return false;
  const float4 p = xs[q];
  const float dx = __fsub_rn(p.x, ci.x);
  const float dy = __fsub_rn(p.y, ci.y);
  const float dz = __fsub_rn(p.z, ci.z);
  rsq = __fadd_rn(__fadd_rn(__fadd_rn(0.f, __fmul_rn(dx, dx)),
                            __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
  const float ct = crow[(int)p.w];
  return rsq < __fmul_rn(ct, ct);
}

__global__ void __launch_bounds__(kThreads)
select_candidates_kernel(const float4* __restrict__ xt,
                         const int* __restrict__ table,
                         const int* __restrict__ order,
                         const int* __restrict__ starts,
                         const float* __restrict__ cut, int nt,
                         long long* __restrict__ idx,
                         long long* __restrict__ jtype,
                         bool* __restrict__ mask, int* __restrict__ cnt,
                         int d0, int d1, int d2, int Cf, int m_all, int K) {
  extern __shared__ float4 stage[];
  __shared__ float buf_k[kWarps][kBuf];
  __shared__ int buf_c[kWarps][kBuf];
  __shared__ int nreal;
  const int c = blockIdx.x;
  const int a0 = starts[c], a1 = starts[c + 1];
  if (a0 == a1) return;                  // no owned atom in this cell
  const int W = 27 * Cf;
  float4* xs = stage;                                // [W] x, y, z, type
  int* ids = reinterpret_cast<int*>(xs + W);         // [W]
  int* tags = ids + W;                               // [W] column << 16 | q
  float* cuts = reinterpret_cast<float*>(tags + W);  // [nt * nt]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) nreal = 0;
  for (int t = threadIdx.x; t < nt * nt; t += kThreads) cuts[t] = cut[t];
  __syncthreads();
  // stage the real atoms of the 27 cells, compacted (pads, ~2/3 of the
  // slots at the bench shapes, are dropped here); the list's order is
  // free, since the selection orders by (rsq, column)
  const int cz = c % d2, cy = (c / d2) % d1, cx = c / (d1 * d2);
  for (int c0 = 0; c0 < W; c0 += kThreads) {
    const int col = c0 + threadIdx.x;
    int id = m_all;
    if (col < W) {
      const int o = col / Cf, s = col - o * Cf;
      const int nx = cx + o / 9 - 1, ny = cy + (o / 3) % 3 - 1,
                nz = cz + o % 3 - 1;
      if (nx >= 0 && nx < d0 && ny >= 0 && ny < d1 && nz >= 0 && nz < d2)
        id = table[((size_t)(nx * d1 + ny) * d2 + nz) * Cf + s];
    }
    const bool real = id < m_all;
    const unsigned m = __ballot_sync(kFull, real);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&nreal, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (real) {
      const int q = base + __popc(m & below);
      ids[q] = id;
      tags[q] = (col << 16) | q;
      cp_async16(xs + q, xt + id);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int nc = nreal;

  float* bk = buf_k[warp];
  int* bc = buf_c[warp];
  for (int a = a0 + warp; a < a1; a += kWarps) {
    const int i = order[a];
    const float4 ci = xt[i];
    const float* crow = cuts + (int)ci.w * nt;
    int nh = 0;
    for (int j0 = 0; j0 < nc; j0 += 32) {
      const int q = j0 + lane;
      float rsq = 0.f;
      const bool hit = q < nc && candidate_hit(xs, ids, q, i, ci, crow, rsq);
      push_hit(hit, rsq, hit ? tags[q] : 0, bk, bc, nh, below);
    }
    __syncwarp();
    auto scan = [&](float lk, int lc, float& best_k, int& best_c) {
      for (int q = lane; q < nc; q += 32) {
        float rsq;
        if (candidate_hit(xs, ids, q, i, ci, crow, rsq))
          take_if_next(rsq, tags[q], lk, lc, best_k, best_c);
      }
    };
    // tags order by column (unique), so ties still go to the lowest column
    select_row(bk, bc, nh, K, lane, scan, [&](int k, int tag) {
      const size_t o = (size_t)i * K + k;
      const int q = tag & 0xffff;
      idx[o] = tag >= 0 ? (long long)ids[q] : 0;
      jtype[o] = tag >= 0 ? (long long)xs[q].w : 0;
      mask[o] = tag >= 0;
    });
    if (lane == 0) cnt[i] = nh;
  }
}

}  // namespace

// D.  W must be a multiple of 128 and at most 1024, K in [1, kMaxK], keys
// 16-byte aligned; returns -1 otherwise.
extern "C" int lpt_select_k(const float* keys, const float* pay0,
                            const float* pay1, int npay, int* pos,
                            float* out0, float* out1, int N, int W, int K,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > kMaxK || W % 128 || ((size_t)keys & 15)) return -1;
  if (N == 0) return 0;
  switch (W / 128) {
#define LPT_CASE(V) \
  case V:           \
    return launch_d<V>(keys, pay0, pay1, npay, pos, out0, out1, N, K, s);
    LPT_CASE(1) LPT_CASE(2) LPT_CASE(3) LPT_CASE(4)
    LPT_CASE(5) LPT_CASE(6) LPT_CASE(7) LPT_CASE(8)
#undef LPT_CASE
    default: return -1;
  }
}

// D'.  xt [m_all + 1, 4] (x, y, z, type; row m_all the pad), table
// [d0 d1 d2 + 2, Cf] int32 (m_all = empty), order [n] / starts [d0 d1 d2 + 1]
// the owned atoms by fine cell, cut [nt, nt] (cm + skin, squared here),
// outputs idx / jtype [n, K] int64, mask [n, K] bool, cnt [n] int32 (hits
// per row).  Returns -1 for K outside [1, kMaxK], nt outside [1, kMaxTypes],
// 27 Cf >= 32768 or more shared memory than a block can have.
extern "C" int lpt_select_candidates(const float* xt, const int* table,
                                     const int* order, const int* starts,
                                     const float* cut, int nt, void* idx,
                                     void* jtype, void* mask, int* cnt,
                                     int d0, int d1, int d2, int Cf,
                                     int m_all, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || K > kMaxK || nt < 1 || nt > kMaxTypes || Cf < 1) return -1;
  const long long ncells = (long long)d0 * d1 * d2;
  if (ncells == 0) return 0;
  const size_t W = 27 * (size_t)Cf;
  if (W >= 32768) return -1;             // a tag holds column and index
  const size_t bytes = W * (sizeof(float4) + 2 * sizeof(int)) +
                       (size_t)nt * nt * sizeof(float);
  static size_t allowed = 48 * 1024;     // the default dynamic limit
  if (bytes > allowed) {
    if (bytes > 216 * 1024) return -1;   // beside the 8 KB static buffers
    const cudaError_t err = cudaFuncSetAttribute(
        select_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  select_candidates_kernel<<<(unsigned)ncells, kThreads, bytes, s>>>(
      reinterpret_cast<const float4*>(xt), table, order, starts, cut, nt,
      static_cast<long long*>(idx), static_cast<long long*>(jtype),
      static_cast<bool*>(mask), cnt, d0, d1, d2, Cf, m_all, K);
  return (int)cudaGetLastError();
}
