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
// slots (only +inf left) give pos = W and payload 0.  Any K and any row
// width: the limits left are those of shared memory, which the wrappers
// (ops/select_k.py, ops/select_candidates.py) size and check before a
// launch.
//
// What bounds them on the H100.  D: reading the [N, W] keys once (~200 MB
// at 98k atoms, W = 512).  D': its outputs (the [n, K] int64 index and
// type lists); its inputs are the fine-cell table and the positions, a few
// MB, read once per neighbouring cell from L2.
//
// The selection core, shared.  A warp counts the row's hits (finite keys;
// for D' the candidates inside the cutoff window) with a ballot per step,
// visiting them in column order, and puts the first `cap` of them (key and
// an int r that orders like the column) into its hit buffer in shared
// memory; cap, the next power of two >= max(K, 64), is set at launch.
//  * At most 32 hits (every row of the REBOMOS bench rebuild: 12-20 of
//    ~430 candidates): one bitonic sort over the lanes' shuffles, lane k
//    writes output k.
//  * At most cap hits (the AEAM rebuild's ~115 at K = 144, the wide-cut
//    melt's ~330 at K = 336): the buffer, padded to a power of two, sorted
//    in place by a bitonic sort whose compare-exchanges the lanes share;
//    lane q writes outputs q, q + 32, ... straight from the buffer.
//  * More hits than the buffer holds (kmax > K, a rebuild that the Engine
//    discards, or D's dense rows): a radix select finds the K-th smallest
//    key.  Positive and negative float32s order as their sign-flipped
//    uint32 bits (-0 taken as +0), so four passes of a 256-bin histogram
//    over the row, each keeping the bin that holds the K-th, give it
//    exactly.  One more pass gathers the hits below it and the first ties
//    at it in column order, K in all, into the buffer, which is then sorted
//    as above.  Five reads of the row, whatever K.
// Every way, lanes write their outputs and read their payloads at once:
// the stores are coalesced and no lane walks the K outputs alone.
//
// D: one warp per row; the row is read in 1,024-column chunks (8 float4 a
// lane), so W is any multiple of 128.  D': one block per fine cell; the
// real atoms among its 27 neighbour cells' slots (ids, then x, y, z, type
// by cp.async from the position table) are staged in shared memory in
// column order (column o * Cf + s: offset o of offs27, (a, b, c)
// lexicographic over {-1, 0, 1}, and slot s), compacted by a ballot and a
// block-wide prefix of the warps' counts; out-of-range cells are empty.
// When the 27 cells do not fit beside the buffers, the block stages them
// in slices of 9, 3 or 1 cells, and each warp keeps its hit buffer across
// the slices (holding the column, from which the id is read again at the
// end); a row that overflows it then reads its candidates from the cell
// table directly for the radix passes.  One warp per owned atom of the
// cell (taken from an owned-atoms-by-cell order, so an atom that the
// capped cell table dropped still gets its row) computes rsq = ((0 + dx^2)
// + dy^2) + dz^2 with dx = x_cand - x_centre in round-to-nearest
// intrinsics (no FMA contraction, so rsq and its ties are those of the
// PyTorch twin bit for bit), tests valid (id < m_all and id != own id) and
// rsq < cut * cut against the [nt, nt] cut table, also in shared memory,
// and selects.  Nothing [n, W]-sized exists.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;            // rows (D) or atoms (D') at once
constexpr int kBins = 256;              // radix-select histogram
constexpr int kChunk = 1024;            // D: columns read per step
constexpr int kSmemLimit = 232448;      // the H100's opt-in block limit

// (a, ca) comes before (b, cb): by key, ties to the lower column
__device__ __forceinline__ bool before(float a, int ca, float b, int cb) {
  return a < b || (a == b && ca < cb);
}

// ascending bitonic sort of one (key, r) pair per lane
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

// Ascending bitonic sort of the n2 (a power of two, 64 <= n2 <= cap)
// (key, r) pairs of a warp's buffer: each step's n2 / 2 compare-exchanges
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

// A warp's hit buffer: cap keys, cap r values, the radix histogram.
struct HitBuf {
  float* k;
  int* r;
  int* hist;
  int cap;
};

// the buffers of `warps` warps laid out from `base`: keys, then r, then
// the histograms, each [warps][...]
__device__ __forceinline__ HitBuf warp_buf(void* base, int warp, int warps,
                                           int cap) {
  float* k = static_cast<float*>(base);
  int* r = reinterpret_cast<int*>(k + (size_t)warps * cap);
  int* hist = r + (size_t)warps * cap;
  return HitBuf{k + (size_t)warp * cap, r + (size_t)warp * cap,
                hist + warp * kBins, cap};
}

// count this lane's hit and, among the row's first cap, put it in the
// warp's buffer (ballot + prefix popcount)
__device__ __forceinline__ void push_hit(bool hit, float key, int r,
                                         const HitBuf& b, int& nh,
                                         unsigned lanes_below) {
  const unsigned m = __ballot_sync(kFull, hit);
  if (hit) {
    const int p = nh + __popc(m & lanes_below);
    if (p < b.cap) {
      b.k[p] = key;
      b.r[p] = r;
    }
  }
  nh += __popc(m);
}

// The K smallest of the nh <= cap (key, r) pairs in the buffer, in order:
// emit(q, r) for q < K, r = -1 once the hits are spent.  Warp-uniform; the
// buffer is free again when it returns.
template <typename Emit>
__device__ __forceinline__ void select_buffered(const HitBuf& b, int nh,
                                                int K, int lane, Emit emit) {
  if (nh <= 32) {
    float k = INFINITY;
    int c = INT_MAX;
    if (lane < nh) {
      k = b.k[lane];
      c = b.r[lane];
    }
    bitonic32(k, c, lane);
    for (int q = lane; q < K; q += 32) emit(q, q < nh ? c : -1);
    __syncwarp();
    return;
  }
  int n2 = 64;
  while (n2 < nh) n2 <<= 1;
  for (int q = nh + lane; q < n2; q += 32) {
    b.k[q] = INFINITY;
    b.r[q] = INT_MAX;
  }
  __syncwarp();
  bitonic_buffer(b.k, b.r, n2, lane);
  for (int q = lane; q < K; q += 32) emit(q, q < nh ? b.r[q] : -1);
  __syncwarp();
}

// float32 -> uint32 in the same order (-0 as +0, NaN never asked)
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The K smallest hits of a row of more than cap >= K hits.  item(q, key, r)
// returns whether item q in [0, n) is a hit (and its key and r); r must
// grow with q, so that the first ties in q order are the lowest columns.
// Four histogram passes fix the ordered bits of the K-th smallest key T;
// a fifth gathers the hits below T and the first ties at T, K in all.
template <typename Item, typename Emit>
__device__ __forceinline__ void select_radix(const HitBuf& b, int n, int K,
                                             int lane, Item item, Emit emit) {
  const unsigned below = (1u << lane) - 1u;
  unsigned prefix = 0u, pmask = 0u;
  int need = K;                          // rank of T among the bucket
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int t = lane; t < kBins; t += 32) b.hist[t] = 0;
    __syncwarp();
    for (int q = lane; q < n; q += 32) {
      float key;
      int r;
      if (item(q, key, r)) {
        const unsigned u = ordered(key);
        if ((u & pmask) == prefix)
          atomicAdd(&b.hist[(u >> shift) & 255u], 1);
      }
    }
    __syncwarp();
    // lane L holds bins 8L .. 8L + 7; the lane whose range holds rank
    // `need` finds the bin
    int c[8], s = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      c[t] = b.hist[8 * lane + t];
      s += c[t];
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = incl - s;
    const int src =
        __ffs(__ballot_sync(kFull, excl < need && need <= incl)) - 1;
    int bin = 0, run = excl;
    if (lane == src) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (need <= run + c[t]) {
          bin = 8 * lane + t;
          break;
        }
        run += c[t];
      }
    }
    bin = __shfl_sync(kFull, bin, src);
    run = __shfl_sync(kFull, run, src);
    prefix |= (unsigned)bin << shift;
    pmask |= 255u << shift;
    need -= run;
    __syncwarp();
  }
  int taken = 0, ties = 0;
  for (int q0 = 0; q0 < n; q0 += 32) {
    const int q = q0 + lane;
    float key = 0.f;
    int r = 0;
    bool lt = false, eq = false;
    if (q < n && item(q, key, r)) {
      const unsigned u = ordered(key);
      lt = u < prefix;
      eq = u == prefix;
    }
    const unsigned me = __ballot_sync(kFull, eq);
    const bool take = lt || (eq && ties + __popc(me & below) < need);
    ties += __popc(me);
    const unsigned mt = __ballot_sync(kFull, take);
    if (take) {
      const int p = taken + __popc(mt & below);
      b.k[p] = key;
      b.r[p] = r;
    }
    taken += __popc(mt);
  }
  __syncwarp();
  select_buffered(b, taken, K, lane, emit);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

// Let the kernel take up to the block limit of dynamic shared memory.
// Done once, at the entry point's first call (the Engine's first rebuild
// runs eagerly), so that a later call, which a CUDA graph may be
// capturing after a K re-size, makes no call but the launch.
template <typename Kernel>
int opt_in(Kernel kernel, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

// ---- D: rows of keys in device memory -----------------------------------

__global__ void __launch_bounds__(32 * kMaxWarps)
select_k_kernel(const float* __restrict__ keys,
                const float* __restrict__ pay0,
                const float* __restrict__ pay1, int npay,
                int* __restrict__ pos, float* __restrict__ out0,
                float* __restrict__ out1, int N, int W, int K, int cap) {
  extern __shared__ float4 smem_d[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= N) return;                  // warp-uniform; no block barrier
  const HitBuf b = warp_buf(smem_d, warp, warps, cap);
  const size_t rbase = (size_t)row * W;
  const float* krow = keys + rbase;
  const float4* k4 = reinterpret_cast<const float4*>(krow);
  const unsigned below = (1u << lane) - 1u;
  int nh = 0;
  for (int c0 = 0; c0 < W; c0 += kChunk) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = c0 + 128 * j < W ? __ldcs(k4 + c0 / 4 + j * 32 + lane)
                              : make_float4(INFINITY, INFINITY, INFINITY,
                                            INFINITY);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 4 * (j * 32 + lane);
      // a finite key is a hit; +inf and NaN never are (the twin's rule)
      push_hit(v[j].x < INFINITY, v[j].x, c + 0, b, nh, below);
      push_hit(v[j].y < INFINITY, v[j].y, c + 1, b, nh, below);
      push_hit(v[j].z < INFINITY, v[j].z, c + 2, b, nh, below);
      push_hit(v[j].w < INFINITY, v[j].w, c + 3, b, nh, below);
    }
  }
  __syncwarp();
  auto emit = [&](int k, int col) {
    const size_t o = (size_t)row * K + k;
    pos[o] = col >= 0 ? col : W;
    if (npay > 0) out0[o] = col >= 0 ? pay0[rbase + col] : 0.f;
    if (npay > 1) out1[o] = col >= 0 ? pay1[rbase + col] : 0.f;
  };
  if (nh <= cap) {
    select_buffered(b, nh, K, lane, emit);
  } else {
    select_radix(b, W, K, lane, [&](int q, float& key, int& r) {
      key = krow[q];
      r = q;
      return key < INFINITY;
    }, emit);
  }
}

// ---- D': candidates from the fine-cell table ----------------------------

// (hit, rsq) of a candidate at p (x, y, z, type) against the centre ci:
// rsq = ((0 + dx^2) + dy^2) + dz^2 rounded as the twin's separate torch
// ops round it, and hit = rsq < cut * cut.
__device__ __forceinline__ bool in_window(float4 p, float4 ci,
                                          const float* crow, float& rsq) {
  const float dx = __fsub_rn(p.x, ci.x);
  const float dy = __fsub_rn(p.y, ci.y);
  const float dz = __fsub_rn(p.z, ci.z);
  rsq = __fadd_rn(__fadd_rn(__fadd_rn(0.f, __fmul_rn(dx, dx)),
                            __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
  const float ct = crow[(int)p.w];
  return rsq < __fmul_rn(ct, ct);
}

// The fine-cell geometry of one block: its cell (cx, cy, cz), the grid and
// the table; col -> the id in the table's slot (m_all: empty or outside).
struct Cells {
  const int* table;
  int cx, cy, cz, d0, d1, d2, Cf, m_all;

  __device__ __forceinline__ int id_at(int col) const {
    const int o = col / Cf, s = col - o * Cf;
    const int nx = cx + o / 9 - 1, ny = cy + (o / 3) % 3 - 1,
              nz = cz + o % 3 - 1;
    if (nx < 0 || nx >= d0 || ny < 0 || ny >= d1 || nz < 0 || nz >= d2)
      return m_all;
    return table[((size_t)(nx * d1 + ny) * d2 + nz) * Cf + s];
  }
};

// Stage the real atoms of the columns [col0, col0 + width) in column
// order: ids, columns and (by cp.async) x, y, z, type.  Block-wide, with a
// prefix of the warps' ballot counts per step (wcount: two rows of
// `warps`); returns the count.
__device__ int stage_columns(const Cells& g, const float4* __restrict__ xt,
                             int col0, int width, float4* xs, int* ids,
                             int* cols, int* wcount) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int running = 0;
  for (int c0 = 0, it = 0; c0 < width; c0 += blockDim.x, ++it) {
    const int l = c0 + threadIdx.x;
    const int id = l < width ? g.id_at(col0 + l) : g.m_all;
    const bool real = id < g.m_all;
    const unsigned m = __ballot_sync(kFull, real);
    int* wc = wcount + (it & 1) * warps;
    if (lane == 0) wc[warp] = __popc(m);
    __syncthreads();
    int base = running, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int v = wc[w];
      base += w < warp ? v : 0;
      total += v;
    }
    if (real) {
      const int q = base + __popc(m & below);
      ids[q] = id;
      cols[q] = col0 + l;
      cp_async16(xs + q, xt + id);
    }
    running += total;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  return running;
}

// cps: neighbour cells staged at once (27: all of them; 9, 3 or 1: slices
// in column order); cap: each warp's hit buffer.  Shared memory: xs
// [cps Cf] float4, the warps' buffers, ids and cols [cps Cf], the cut
// table [nt, nt], the staging counts [2, warps].
__global__ void __launch_bounds__(32 * kMaxWarps)
select_candidates_kernel(const float4* __restrict__ xt,
                         const int* __restrict__ table,
                         const int* __restrict__ order,
                         const int* __restrict__ starts,
                         const float* __restrict__ cut, int nt,
                         long long* __restrict__ idx,
                         long long* __restrict__ jtype,
                         bool* __restrict__ mask, int* __restrict__ cnt,
                         int d0, int d1, int d2, int Cf, int m_all, int K,
                         int cap, int cps) {
  extern __shared__ float4 smem_c[];
  const int c = blockIdx.x;
  const int a0 = starts[c], a1 = starts[c + 1];
  if (a0 == a1) return;                  // no owned atom in this cell
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int Ws = cps * Cf;
  float4* xs = smem_c;                               // [Ws]
  const HitBuf b = warp_buf(xs + Ws, warp, warps, cap);
  int* ids = reinterpret_cast<int*>(xs + Ws) +
             (size_t)warps * (2 * cap + kBins);      // [Ws]
  int* cols = ids + Ws;                              // [Ws]
  float* cuts = reinterpret_cast<float*>(cols + Ws); // [nt * nt]
  int* wcount = reinterpret_cast<int*>(cuts + nt * nt);
  for (int t = threadIdx.x; t < nt * nt; t += blockDim.x) cuts[t] = cut[t];
  const Cells g{table, c / (d1 * d2), (c / d2) % d1, c % d2,
                d0, d1, d2, Cf, m_all};

  if (cps == 27) {
    // every candidate staged once; each warp takes its atoms alone.  r is
    // the staged index, which grows with the column.
    const int nc = stage_columns(g, xt, 0, Ws, xs, ids, cols, wcount);
    for (int a = a0 + warp; a < a1; a += warps) {
      const int i = order[a];
      const float4 ci = xt[i];
      const float* crow = cuts + (int)ci.w * nt;
      auto item = [&](int q, float& rsq, int& r) {
        r = q;
        return ids[q] != i && in_window(xs[q], ci, crow, rsq);
      };
      int nh = 0;
      for (int j0 = 0; j0 < nc; j0 += 32) {
        const int q = j0 + lane;
        float rsq = 0.f;
        int r = q;
        const bool hit = q < nc && item(q, rsq, r);
        push_hit(hit, rsq, r, b, nh, below);
      }
      __syncwarp();
      auto emit = [&](int k, int r) {
        const size_t o = (size_t)i * K + k;
        idx[o] = r >= 0 ? (long long)ids[r] : 0;
        jtype[o] = r >= 0 ? (long long)xs[r].w : 0;
        mask[o] = r >= 0;
      };
      if (nh <= cap)
        select_buffered(b, nh, K, lane, emit);
      else
        select_radix(b, nc, K, lane, item, emit);
      if (lane == 0) cnt[i] = nh;
    }
    return;
  }

  // sliced: the block's warps take `warps` atoms at a time through every
  // slice; r is the column, and the buffers outlive the slices
  for (int a_base = a0; a_base < a1; a_base += warps) {
    const int a = a_base + warp;
    const bool active = a < a1;           // warp-uniform
    const int i = active ? order[a] : 0;
    const float4 ci = xt[i];
    const float* crow = cuts + (int)ci.w * nt;
    int nh = 0;
    for (int col0 = 0; col0 < 27 * Cf; col0 += Ws) {
      __syncthreads();                    // the last slice is read
      const int nc = stage_columns(g, xt, col0, Ws, xs, ids, cols, wcount);
      if (!active) continue;
      for (int j0 = 0; j0 < nc; j0 += 32) {
        const int q = j0 + lane;
        float rsq = 0.f;
        const bool hit = q < nc && ids[q] != i &&
                         in_window(xs[q], ci, crow, rsq);
        push_hit(hit, rsq, q < nc ? cols[q] : 0, b, nh, below);
      }
    }
    if (!active) continue;
    __syncwarp();
    auto emit = [&](int k, int col) {
      const size_t o = (size_t)i * K + k;
      const int id = col >= 0 ? g.id_at(col) : 0;
      idx[o] = id;
      jtype[o] = col >= 0 ? (long long)xt[id].w : 0;
      mask[o] = col >= 0;
    };
    if (nh <= cap) {
      select_buffered(b, nh, K, lane, emit);
    } else {
      select_radix(b, 27 * Cf, K, lane, [&](int q, float& rsq, int& r) {
        r = q;
        const int id = g.id_at(q);
        return id < m_all && id != i && in_window(xt[id], ci, crow, rsq);
      }, emit);
    }
    if (lane == 0) cnt[i] = nh;
  }
}

// the pow2 hit buffer, a histogram and (D') the staging of one block
size_t select_k_bytes(int warps, int cap) {
  return (size_t)warps * (2 * (size_t)cap + kBins) * 4;
}

size_t candidates_bytes(int warps, int cap, int cps, int Cf, int nt) {
  return (size_t)cps * Cf * (16 + 4 + 4) + select_k_bytes(warps, cap) +
         (size_t)nt * nt * 4 + 2 * (size_t)warps * 4;
}

bool valid_cap(int cap, int K) {
  return cap >= 64 && cap >= K && (cap & (cap - 1)) == 0;
}

}  // namespace

// D.  W a positive multiple of 128, K >= 1, keys 16-byte aligned; warps
// (1, 2 or 4) rows a block and cap (a power of two >= max(K, 64)) the hit
// buffer, whose shared memory (ops/select_k.py::select_k_plan) must fit a
// block.  Returns -1 otherwise.
extern "C" int lpt_select_k(const float* keys, const float* pay0,
                            const float* pay1, int npay, int* pos,
                            float* out0, float* out1, int N, int W, int K,
                            int warps, int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || W < 128 || W % 128 || ((size_t)keys & 15)) return -1;
  if (warps < 1 || warps > kMaxWarps || !valid_cap(cap, K)) return -1;
  if (N == 0) return 0;
  static bool opted = false;
  const int err = opt_in(select_k_kernel, opted);
  if (err) return err;
  const size_t bytes = select_k_bytes(warps, cap);
  if (bytes > (size_t)kSmemLimit) return -1;
  const int blocks = (N + warps - 1) / warps;
  select_k_kernel<<<blocks, 32 * warps, bytes, s>>>(
      keys, pay0, pay1, npay, pos, out0, out1, N, W, K, cap);
  return (int)cudaGetLastError();
}

// D'.  xt [m_all + 1, 4] (x, y, z, type; row m_all the pad), table
// [d0 d1 d2 + 2, Cf] int32 (m_all = empty), order [n] / starts [d0 d1 d2 + 1]
// the owned atoms by fine cell, cut [nt, nt] (cm + skin, squared here),
// outputs idx / jtype [n, K] int64, mask [n, K] bool, cnt [n] int32 (hits
// per row).  warps (1, 2 or 4) atoms a block at once, cap the hit buffer,
// cps (27, 9, 3 or 1) the neighbour cells staged at once, as
// ops/select_candidates.py::candidates_plan sizes them.  Returns -1 for
// arguments outside these ranges or more shared memory than a block has.
extern "C" int lpt_select_candidates(const float* xt, const int* table,
                                     const int* order, const int* starts,
                                     const float* cut, int nt, void* idx,
                                     void* jtype, void* mask, int* cnt,
                                     int d0, int d1, int d2, int Cf,
                                     int m_all, int K, int warps, int cap,
                                     int cps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || nt < 1 || Cf < 1 || warps < 1 || warps > kMaxWarps ||
      !valid_cap(cap, K) || (cps != 27 && cps != 9 && cps != 3 && cps != 1))
    return -1;
  if ((long long)27 * Cf >= INT_MAX) return -1;   // a column is an int
  const long long ncells = (long long)d0 * d1 * d2;
  if (ncells == 0) return 0;
  static bool opted = false;
  const int err = opt_in(select_candidates_kernel, opted);
  if (err) return err;
  const size_t bytes = candidates_bytes(warps, cap, cps, Cf, nt);
  if (bytes > (size_t)kSmemLimit) return -1;
  select_candidates_kernel<<<(unsigned)ncells, 32 * warps, bytes, s>>>(
      reinterpret_cast<const float4*>(xt), table, order, starts, cut, nt,
      static_cast<long long*>(idx), static_cast<long long*>(jtype),
      static_cast<bool*>(mask), cnt, d0, d1, d2, Cf, m_all, K, cap, cps);
  return (int)cudaGetLastError();
}
