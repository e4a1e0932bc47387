// Smallest-K selection per row (D), and the neighbor rebuild's candidate
// selection fused with the making of its keys (D').
//
// Replaces: lammps_plugins_tpu/ops/select_k_pallas.py::select_k (body
// _make_kernel), which compacts each atom's cell-window candidates to its
// K nearest in the device neighbor rebuild.  The TPU kernel read keys that
// the rebuild had built in device memory; D keeps that interface, D' takes
// the rebuild's fine cells instead and never writes a key.
// Semantics: per row, the column positions of the K smallest keys in
// ascending order; ties go to the lowest column (a stable sort); exhausted
// slots (only +inf left) give pos = W and payload 0.  Any K and any row
// width: the limits left are those of shared memory, which the wrappers
// (ops/select_k.py, ops/select_candidates.py) size and check before a
// launch.
//
// What bounds them on the H100.  D: reading the [N, W] keys once (~200 MB
// at 98k atoms, W = 512).  D': its outputs (the [n, K] int64 index and
// type lists); its inputs, the positions in cell order and the cells' run
// starts, are a few MB.
//
// The selection core.  A warp counts the row's hits (finite keys; for D'
// the candidates inside the cutoff window) with a ballot per step,
// visiting them in column order, and puts the first `cap` of them (key and
// an int r that orders like the column) into its hit buffer in shared
// memory; cap, the next power of two >= max(K, 64), is set at launch.
//  * At most 32 hits (every row of the REBOMOS bench rebuild: 12-20 of
//    ~270 candidates): one bitonic sort over the lanes' shuffles, lane k
//    writes output k.
//  * At most cap hits: D sorts the buffer, padded to a power of two, in
//    place by a bitonic sort whose compare-exchanges the lanes share (a
//    __syncwarp a step: 45 steps at 512).  D' takes a bucket sort where
//    shared memory leaves room for a second buffer: each hit's bucket
//    (256 ranges of rsq, cut^2 / 256 wide) counted, the hits scattered by
//    bucket in push order, each hit's rank its bucket's start plus the
//    hits of its bucket before it; every lane busy, a few steps whatever
//    the count.  Lane q writes outputs q, q + 32, ... from the buffer.
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
// lane), so W is any multiple of 128.
//
// D': the rebuild bins every row by fine cell with one stable sort
// (neighbor/device_build.py::_bin_dense); the kernel reads that sort's order
// and each cell's run start, so a cell's atoms are one contiguous run of the
// order.  A block takes a brick, an x-column of bx cells (bx = 1 to 8, by cell
// size), and stages the real atoms of the brick's (bx + 2) x 3 x 3 cells once,
// their rows and then their positions by cp.async, where the one-block-a-cell
// design staged each cell again for each of its 27 neighbours; several blocks
// share an SM, so one block's copies overlap another's selection.  The union
// is x-major, so an atom's 27 cells in column order (column o * Cf + s: offset
// o of offs27, (a, b, c) lexicographic over {-1, 0, 1}, and slot s) are one
// contiguous run of the staging, three planes of nine cells, and the staged
// index orders like the column; cells too large to stage are read in place
// (bricks of one cell).  From each plane the leading and trailing rows and
// cells whose nearest point lies past the atom's largest cut are not tested:
// at most ~15 % of the 27-cell cube lies inside the window.  rsq = ((0 + dx^2)
// + dy^2) + dz^2 with dx = x_cand - x_centre in round-to-nearest intrinsics
// (no FMA contraction, so rsq and its ties are those of the PyTorch twin bit
// for bit), hit = not the atom's own slot and rsq < cut * cut against the [nt,
// nt] table of squared cuts in shared memory.  Rows of at most 16 hits sort
// within 16 lanes.  Each output element is written once, the rows in no cell
// included, and kmax is one atomicMax a block at most.  Nothing [n, W]-sized
// exists.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;            // D: rows a block
constexpr int kBins = 256;              // radix-select histogram
constexpr int kChunk = 1024;            // D: columns read per step
constexpr int kSmemLimit = 232448;      // the H100's opt-in block limit

// (a, ca) comes before (b, cb): by key, ties to the lower column
__device__ __forceinline__ bool before(float a, int ca, float b, int cb) {
  return a < b || (a == b && ca < cb);
}

// ascending bitonic sort of one (key, r) pair per lane, within each group
// of kWidth lanes (a power of two up to 32)
template <int kWidth>
__device__ __forceinline__ void bitonic(float& k, int& c, int lane) {
#pragma unroll
  for (int size = 2; size <= kWidth; size <<= 1) {
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

// A warp's hit buffer: cap keys, cap r values, the radix histogram (D'
// also sorts with it); D''s bucket sort adds cap keys and r values more
// (k2, r2; null for D).
struct HitBuf {
  float* k;
  int* r;
  int* hist;
  int cap;
  float* k2;
  int* r2;
};

// the buffers of `warps` warps laid out from `base`: keys, then r, then
// the histograms, each [warps][...]
__device__ __forceinline__ HitBuf warp_buf(void* base, int warp, int warps,
                                           int cap) {
  float* k = static_cast<float*>(base);
  int* r = reinterpret_cast<int*>(k + (size_t)warps * cap);
  int* hist = r + (size_t)warps * cap;
  return HitBuf{k + (size_t)warp * cap, r + (size_t)warp * cap,
                hist + warp * kBins, cap, nullptr, nullptr};
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
    bitonic<32>(k, c, lane);
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

// The K smallest hits of a row of more than cap >= K hits, gathered into
// the buffer in column order; returns their count (K).  item(q, key, r)
// returns whether item q in [0, n) is a hit (and its key and r); r must
// grow with q, so that the first ties in q order are the lowest columns.
// Four histogram passes fix the ordered bits of the K-th smallest key T;
// a fifth gathers the hits below T and the first ties at T, K in all.
template <typename Item>
__device__ __forceinline__ int radix_gather(const HitBuf& b, int n, int K,
                                            int lane, Item item) {
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
  return taken;
}

// D's rows of more than cap hits: radix_gather, then select_buffered
template <typename Item, typename Emit>
__device__ __forceinline__ void select_radix(const HitBuf& b, int n, int K,
                                             int lane, Item item, Emit emit) {
  select_buffered(b, radix_gather(b, n, K, lane, item), K, lane, emit);
}


// Let the kernel take up to the block limit of dynamic shared memory.
// Done once a device (the attribute is the calling thread's current
// device's), at the entry point's first call there (the Engine's first
// rebuild runs eagerly), so that a later call, which a CUDA graph may be
// capturing after a K re-size, makes no call but the device query and the
// launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int opt_in(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (done[dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
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

// ---- D': candidates from the positions in fine-cell order ----------------

constexpr int kMaxCandWarps = 16;       // D': warps a block
constexpr int kMinCandBlocks = 2;       // D': blocks an SM (64 registers)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// (hit, rsq) of a candidate at p (x, y, z, type) against the centre ci:
// rsq = ((0 + dx^2) + dy^2) + dz^2 rounded as the twin's separate torch
// ops round it, and hit = rsq < cut * cut (row2: the centre type's row of
// squared cuts, each squared once in round-to-nearest).
__device__ __forceinline__ bool in_window(float4 p, float4 ci,
                                          const float* row2, float& rsq) {
  const float dx = __fsub_rn(p.x, ci.x);
  const float dy = __fsub_rn(p.y, ci.y);
  const float dz = __fsub_rn(p.z, ci.z);
  rsq = __fadd_rn(__fadd_rn(__fadd_rn(0.f, __fmul_rn(dx, dx)),
                            __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
  return rsq < row2[(int)p.w];
}

// the bucket of a key in [0, kmax2): monotone in the key (a rounded product
// and a truncation), so a bucket holds a range of keys
__device__ __forceinline__ int bucket_of(float key, float inv) {
  return min((int)__fmul_rn(key, inv), kBins - 1);
}

// Sort the warp's nh (33 <= nh <= cap) hits by (key, r), all lanes at once:
// count the keys of each of 256 buckets, scatter the hits by bucket
// (stable: in the order they were pushed, which is column order), then
// each hit's rank is its bucket's start plus the hits of its bucket before
// it, by key and then by position.  The sorted r values end in b.r.
__device__ void bucket_sort(const HitBuf& b, int nh, float inv, int lane) {
  const unsigned below = (1u << lane) - 1u;
  for (int t = lane; t < kBins; t += 32) b.hist[t] = 0;
  __syncwarp();
  for (int h = lane; h < nh; h += 32)
    atomicAdd(&b.hist[bucket_of(b.k[h], inv)], 1);
  __syncwarp();
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
  int run = incl - s;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    b.hist[8 * lane + t] = run;
    run += c[t];
  }
  __syncwarp();
  for (int h0 = 0; h0 < nh; h0 += 32) {
    const int h = h0 + lane;
    const bool on = h < nh;
    const int bk = on ? bucket_of(b.k[h], inv) : -1 - lane;
    const unsigned peers = __match_any_sync(kFull, bk);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (on && lane == leader) base = atomicAdd(&b.hist[bk], __popc(peers));
    base = __shfl_sync(kFull, base, leader);
    if (on) {
      const int q = base + __popc(peers & below);
      b.k2[q] = b.k[h];
      b.r2[q] = b.r[h];
    }
  }
  __syncwarp();
  // hist[bk] is now the end of bucket bk
  for (int q = lane; q < nh; q += 32) {
    const float key = b.k2[q];
    const int bk = bucket_of(key, inv);
    const int lo = bk ? b.hist[bk - 1] : 0, hi = b.hist[bk];
    int rank = lo;
    for (int t = lo; t < hi; ++t) {
      const float kt = b.k2[t];
      rank += (kt < key || (kt == key && t < q)) ? 1 : 0;
    }
    b.r[rank] = b.r2[q];
  }
  __syncwarp();
}

// Everything a launch of D' reads and writes.  xt [m_all + 1, 4] (x, y,
// z, type of each row); order [m_all] the rows sorted by fine cell and xs
// [m_all, 4] their xt rows in that order (read in place: without staging
// only); starts [ncells + 1] each cell's first position (positions past
// starts[ncells]: rows in no cell); cut [nt, nt]; origin [3] and size the
// fine grid's; outputs idx, jtype [n, K] int64, mask [n, K] bool and kmax
// (int64, zero at entry).
struct CandArgs {
  const float4* __restrict__ xt;
  const float4* __restrict__ xs;
  const int* __restrict__ order;
  const int* __restrict__ starts;
  const float* __restrict__ cut;
  const float* __restrict__ origin;
  long long* __restrict__ idx;
  long long* __restrict__ jtype;
  bool* __restrict__ mask;
  unsigned long long* kmax;
  float size;
  int nt, d0, d1, d2, Cf, n, m_all, K, cap, bx;
};

// Byte offsets of one block's shared memory: the staging of the brick's
// union of cells (staged: S = U Cf slots, x, y, z, type, then the row),
// its table (staged offsets off[U + 1], run starts gst[U], staged counts
// occ[U], run ends lst[U], the brick's own cells' entry prefix opre[bx +
// 1]), the squared cut table, the warps' buffers (keys, r, [bucket sort:
// keys, r,] histogram), the block's kmax.
struct CandLayout {
  size_t xs, ids, meta, cut, bufs, kmax, total;
  int U, S, meta_ints;
};

__host__ __device__ inline CandLayout cand_layout(int warps, int cap,
                                                  int bucket, int bx,
                                                  int staged, int Cf,
                                                  int nt) {
  CandLayout L;
  L.U = (bx + 2) * 9;
  L.S = staged ? L.U * Cf : 0;
  L.meta_ints = (4 * L.U + bx + 2 + 3) & ~3;
  const size_t per_warp =
      (size_t)cap * (bucket ? 16 : 8) + (size_t)kBins * 4;
  L.xs = 0;
  L.ids = L.xs + (size_t)L.S * 16;
  L.meta = L.ids + (((size_t)L.S * 4 + 15) & ~(size_t)15);
  L.cut = L.meta + (size_t)L.meta_ints * 4;
  L.bufs = L.cut + (((size_t)nt * nt * 4 + 15) & ~(size_t)15);
  L.kmax = L.bufs + (size_t)warps * per_warp;
  L.total = L.kmax + 16;
  return L;
}

// D''s rows of at most 16 hits sort within 16 lanes (10 steps, not 15);
// others go to select_buffered
template <typename Emit>
__device__ __forceinline__ void select_small(const HitBuf& b, int nh, int K,
                                             int lane, Emit emit) {
  if (nh > 16) {
    select_buffered(b, nh, K, lane, emit);
    return;
  }
  float k = INFINITY;
  int c = INT_MAX;
  if (lane < nh) {
    k = b.k[lane];
    c = b.r[lane];
  }
  bitonic<16>(k, c, lane);
  for (int q = lane; q < K; q += 32) emit(q, q < nh ? c : -1);
  __syncwarp();
}

// A brick is bx fine cells along x (an x-column, cells X0 ..  X0 + bx - 1 at
// Y0, Z0); its union of cells is the (bx + 2) x 3 x 3 block around it,
// x-major, so the 27 cells of an atom in own cell k, in column order, are the
// union's cells 9 k ..  9 k + 26: one contiguous run of the staging, in three
// planes of nine cells (a = -1, 0, 1).  One block a brick: warp 0 reads the
// brick's table, then (kStaged) the block copies the real atoms of the union
// by cp.async, each cell's first Cf rows of the order (at most Cf, as in the
// cell table: past Cf the table's last slot holds the run's last row), then
// their xt rows.  Several blocks share an SM, so one block's copies overlap
// another's selection.  Without staging (cells too large; bricks of one cell)
// the warps read the candidates from xs in device memory, cell by cell.  Each
// warp takes the brick's owned atoms in turn; for one atom it walks its three
// planes in column order, trimming from each plane the leading and trailing
// rows and cells whose nearest point lies past the atom's largest cut (plus a
// margin for the rounding of the binning), and selects: the hits pushed in
// column order, sorted (kBucket: bucket_sort past 32 hits), the K nearest
// written.  The rows in no cell get their empty lists from the same launch;
// kmax is each warp's most hits, a block max, then an atomicMax where it is
// larger than the one already there.
template <bool kStaged, bool kBucket>
__global__ void __launch_bounds__(32 * kMaxCandWarps, kMinCandBlocks)
select_candidates_kernel(const CandArgs a) {
  extern __shared__ float4 smem_c[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const CandLayout L =
      cand_layout(warps, a.cap, kBucket, a.bx, kStaged, a.Cf, a.nt);
  char* base = reinterpret_cast<char*>(smem_c);
  float4* xd = reinterpret_cast<float4*>(base + L.xs);
  int* idd = reinterpret_cast<int*>(base + L.ids);
  float* cut2 = reinterpret_cast<float*>(base + L.cut);
  int* blk_kmax = reinterpret_cast<int*>(base + L.kmax);
  const int nt = a.nt, Cf = a.Cf, K = a.K, bx = a.bx, U = L.U;
  // the brick's table: off (staged offsets), gst, occ, lst (each union
  // cell's run start, staged count and run end), opre (the own cells'
  // entry prefix)
  int* off = reinterpret_cast<int*>(base + L.meta);
  int* gst = off + U + 1;
  int* occ = gst + U;
  int* lst = occ + U;
  int* opre = lst + U;
  HitBuf hb;
  {
    const size_t per_warp = (size_t)a.cap * (kBucket ? 16 : 8) + kBins * 4;
    char* w = base + L.bufs + warp * per_warp;
    hb.k = reinterpret_cast<float*>(w);
    hb.r = reinterpret_cast<int*>(hb.k + a.cap);
    hb.k2 = kBucket ? reinterpret_cast<float*>(hb.r + a.cap) : nullptr;
    hb.r2 = kBucket ? reinterpret_cast<int*>(hb.r + 2 * a.cap) : nullptr;
    hb.hist = reinterpret_cast<int*>(hb.r + (kBucket ? 3 : 1) * a.cap);
    hb.cap = a.cap;
  }
  const int brick = blockIdx.x;
  const int X0 = brick / (a.d1 * a.d2) * bx, Y0 = brick / a.d2 % a.d1,
            Z0 = brick % a.d2;
  for (int t = threadIdx.x; t < nt * nt; t += blockDim.x) {
    const float c = a.cut[t];
    cut2[t] = __fmul_rn(c, c);
  }
  if (warp == 0) {
    int carry = 0;
    for (int u0 = 0; u0 < U; u0 += 32) {
      const int u = u0 + lane;
      int g = 0, e = 0;
      if (u < U) {
        const int ux = u / 9, uy = (u - 9 * ux) / 3, uz = u % 3;
        const int gx = X0 + ux - 1, gy = Y0 + uy - 1, gz = Z0 + uz - 1;
        if (gx >= 0 && gx < a.d0 && gy >= 0 && gy < a.d1 && gz >= 0 &&
            gz < a.d2) {
          const int c = (gx * a.d1 + gy) * a.d2 + gz;
          g = a.starts[c];
          e = a.starts[c + 1];
        }
        gst[u] = g;
        lst[u] = e - 1;
        if (uy == 1 && uz == 1 && ux >= 1 && ux <= bx) opre[ux] = e - g;
      }
      const int v = min(e - g, Cf);
      if (u < U) occ[u] = v;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int w = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += w;
      }
      if (u < U) off[u] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      off[U] = carry;
      opre[0] = 0;
      for (int k = 0; k < bx; ++k) opre[k + 1] += opre[k];
      *blk_kmax = 0;
    }
  }
  __syncthreads();
  const int nA = opre[bx];              // entries of the own cells' runs
  if (kStaged && nA > 0) {
    // slot t of the staging: the cell u whose range [off[u], off[u + 1])
    // holds it (a binary search), its slot s in that cell; the rows first,
    // then their positions
    const int T = off[U];
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      int lo = 0, hi = U;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= t) lo = mid; else hi = mid;
      }
      const int s = t - off[lo];
      cp_async4(idd + t, a.order + (s == Cf - 1 ? lst[lo] : gst[lo] + s));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      cp_async16(xd + t, a.xt + idd[t]);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  const float size = a.size;
  const float ox = a.origin[0], oy = a.origin[1], oz = a.origin[2];
  // the trimming keeps a cell unless its nearest point is past cut +
  // slack: slack covers the rounding of (x - origin) / size in the binning
  const float slack =
      1e-3f * size +
      ldexpf(fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) +
                 (float)max(max(a.d0, a.d1), a.d2) * size + size,
             -16);
  const float y0 = oy + (float)Y0 * size, z0 = oz + (float)Z0 * size;
  int kw = 0;                           // this warp's most hits
  for (int t0 = 0; t0 < nA; t0 += 32 * warps) {
    // lane l of warp w reads entry t0 + w + warps l of the own cells'
    // runs; the warp then takes its owned atoms (rows < n) one by one
    const int q = t0 + warp + warps * lane;
    int p = 0, i = a.n, k = 0;
    float4 cq = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < nA) {
      while (opre[k + 1] <= q) ++k;
      p = gst[9 * k + 13] + (q - opre[k]);
      i = a.order[p];
      if (i < a.n) cq = a.xt[i];
    }
    unsigned todo = __ballot_sync(kFull, i < a.n);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int ai = __shfl_sync(kFull, i, src);
      const int ap = __shfl_sync(kFull, p, src);
      const int ak = __shfl_sync(kFull, k, src);
      float4 ci;
      ci.x = __shfl_sync(kFull, cq.x, src);
      ci.y = __shfl_sync(kFull, cq.y, src);
      ci.z = __shfl_sync(kFull, cq.z, src);
      ci.w = __shfl_sync(kFull, cq.w, src);
      const float* row2 = cut2 + (int)ci.w * nt;
      float rmax2 = 0.f;
      for (int t = 0; t < nt; ++t) rmax2 = fmaxf(rmax2, row2[t]);
      const float lim = sqrtf(rmax2) + slack;
      const float lim2 = lim * lim;
      // squared distances from the atom to the low and high faces of its
      // own cell along each axis
      float lx2, hx2, ly2, hy2, lz2, hz2;
      {
        const float x0 = ox + (float)(X0 + ak) * size;
        const float lo_x = fmaxf(ci.x - x0, 0.f),
                    hi_x = fmaxf(x0 + size - ci.x, 0.f);
        const float lo_y = fmaxf(ci.y - y0, 0.f),
                    hi_y = fmaxf(y0 + size - ci.y, 0.f);
        const float lo_z = fmaxf(ci.z - z0, 0.f),
                    hi_z = fmaxf(z0 + size - ci.z, 0.f);
        lx2 = lo_x * lo_x; hx2 = hi_x * hi_x;
        ly2 = lo_y * lo_y; hy2 = hi_y * hi_y;
        lz2 = lo_z * lo_z; hz2 = hi_z * hi_z;
      }
      // the atom's own staged slot (-1: past Cf, not staged), which the
      // scan leaves out
      int self = -1;
      if (kStaged) {
        const int ou = 9 * ak + 13, s = ap - gst[ou];
        self = s < Cf - 1 ? off[ou] + s
                          : (ap == lst[ou] ? off[ou] + Cf - 1 : -1);
      }
      int nh = 0;
#pragma unroll 1
      for (int oa = 0; oa < 3; ++oa) {
        // plane a = oa - 1: cells c0 .. c1 - 1 of its nine, the leading
        // and trailing rows (b) and cells (c) out of reach trimmed
        const float fx = oa == 0 ? lx2 : (oa == 2 ? hx2 : 0.f);
        if (fx > lim2) continue;
        int c0 = fx + ly2 > lim2 ? 3 : 0;
        int c1 = fx + hy2 > lim2 ? 6 : 9;
        if (fx + (c0 ? 0.f : ly2) + lz2 > lim2) ++c0;
        if (fx + (c1 == 9 ? hy2 : 0.f) + hz2 > lim2) --c1;
        const int pb = 9 * (ak + oa);             // the plane's first cell
        if (kStaged) {
          // r is the staged index, which grows with the column
          const int s0 = off[pb + c0], s1 = off[pb + c1];
          for (int j0 = s0; j0 < s1; j0 += 32) {
            const int j = j0 + lane;
            float rsq = 0.f;
            const bool hit =
                j < s1 && j != self && in_window(xd[j], ci, row2, rsq);
            push_hit(hit, rsq, j, hb, nh, below);
          }
        } else {
          // r is the column o Cf + s
          for (int cc = c0; cc < c1; ++cc) {
            const int u = pb + cc;
            const int g = gst[u], c = occ[u], last = lst[u];
            const int col0 = (9 * oa + cc) * Cf;
            for (int s0 = 0; s0 < c; s0 += 32) {
              const int s = s0 + lane;
              const int gp = s == Cf - 1 ? last : g + s;
              float rsq = 0.f;
              const bool hit = s < c && gp != ap &&
                               in_window(a.xs[gp], ci, row2, rsq);
              push_hit(hit, rsq, col0 + s, hb, nh, below);
            }
          }
        }
      }
      __syncwarp();
      kw = max(kw, nh);
      auto emit = [&](int q, int r) {
        const size_t o = (size_t)ai * K + q;
        long long id = 0, jt = 0;
        if (r >= 0) {
          if (kStaged) {
            id = idd[r];
            jt = (long long)xd[r].w;
          } else {
            const int oo = r / Cf, s = r - oo * Cf;
            const int u = 9 * ak + oo;
            const int gp = s == Cf - 1 ? lst[u] : gst[u] + s;
            id = a.order[gp];
            jt = (long long)a.xs[gp].w;
          }
        }
        a.idx[o] = id;
        a.jtype[o] = jt;
        a.mask[o] = r >= 0;
      };
      int nsel = nh;
      if (nh > a.cap) {
        // past the buffer: the radix select gathers the K nearest, over
        // the atom's 27 cells again
        if (kStaged) {
          const int s0 = off[9 * ak];
          nsel = radix_gather(hb, off[9 * ak + 27] - s0, K, lane,
                              [&](int q, float& rsq, int& r) {
            r = s0 + q;
            return r != self && in_window(xd[r], ci, row2, rsq);
          });
        } else {
          nsel = radix_gather(hb, 27 * Cf, K, lane,
                              [&](int col, float& rsq, int& r) {
            r = col;
            const int o = col / Cf, s = col - o * Cf;
            const int u = 9 * ak + o;
            if (s >= occ[u]) return false;
            const int gp = s == Cf - 1 ? lst[u] : gst[u] + s;
            return gp != ap && in_window(a.xs[gp], ci, row2, rsq);
          });
        }
      }
      if (kBucket && nsel > 32) {
        bucket_sort(hb, nsel, rmax2 > 0.f ? 256.f / rmax2 : 0.f, lane);
        for (int q = lane; q < K; q += 32) emit(q, q < nsel ? hb.r[q] : -1);
        __syncwarp();
      } else {
        select_small(hb, nsel, K, lane, emit);
      }
    }
  }

  // the rows in no cell (a pad row of a sharded block): empty lists
  const int tail0 = a.starts[a.d0 * a.d1 * a.d2];
  const int gw = blockIdx.x * warps + warp, tw = gridDim.x * warps;
  for (int p0 = tail0 + gw * 32; p0 < a.m_all; p0 += tw * 32) {
    const int p = p0 + lane;
    const int i = p < a.m_all ? a.order[p] : a.n;
    unsigned todo = __ballot_sync(kFull, i < a.n);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int ai = __shfl_sync(kFull, i, src);
      for (int q = lane; q < K; q += 32) {
        const size_t o = (size_t)ai * K + q;
        a.idx[o] = 0;
        a.jtype[o] = 0;
        a.mask[o] = false;
      }
    }
  }
  if (lane == 0 && kw > 0) atomicMax(blk_kmax, kw);
  __syncthreads();
  if (threadIdx.x == 0 && *blk_kmax > 0 &&
      (unsigned long long)*blk_kmax > *(volatile unsigned long long*)a.kmax)
    atomicMax(a.kmax, (unsigned long long)*blk_kmax);
}

// the pow2 hit buffer and a histogram of each warp of D
size_t select_k_bytes(int warps, int cap) {
  return (size_t)warps * (2 * (size_t)cap + kBins) * 4;
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
  static bool opted[kMaxDevices] = {};
  const int err = opt_in(select_k_kernel, opted);
  if (err) return err;
  const size_t bytes = select_k_bytes(warps, cap);
  if (bytes > (size_t)kSmemLimit) return -1;
  const int blocks = (N + warps - 1) / warps;
  select_k_kernel<<<blocks, 32 * warps, bytes, s>>>(
      keys, pay0, pay1, npay, pos, out0, out1, N, W, K, cap);
  return (int)cudaGetLastError();
}

// D'.  xt [m_all + 1, 4] (x, y, z, type of each row), order [m_all] the
// rows in fine-cell order and xs their xt rows in that order (read only
// without staging; null otherwise), starts [d0 d1 d2 + 1] each cell's
// first position,
// cut [nt, nt] (cm + skin), origin [3] and size the fine grid's; outputs
// idx / jtype [n, K] int64, mask [n, K] bool, kmax a zeroed int64.  warps
// (1-16) a block, cap (a power of two >= max(K, 64)) each warp's hit
// buffer, bucket (1: room for the bucket sort), bx the brick's cells along
// x and staged (0: read in place, bricks of one cell) as
// ops/select_candidates.py::candidates_plan sizes them; one block a brick.
// Returns -1 for arguments outside these ranges or more shared memory
// than a block has.
extern "C" int lpt_select_candidates(
    const float* xt, const float* xs, const int* order, const int* starts,
    const float* cut,
    const float* origin, void* idx, void* jtype, void* mask, void* kmax,
    float size, int nt, int d0, int d1, int d2, int Cf, int n, int m_all,
    int K, int warps, int cap, int bucket, int bx, int staged,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K < 1 || nt < 1 || Cf < 1 || n < 1 || m_all < n || warps < 1 ||
      warps > kMaxCandWarps || !valid_cap(cap, K) ||
      (bucket != 0 && bucket != 1) || bx < 1 || bx > 16 ||
      (staged != 0 && staged != 1) || !(size > 0.f))
    return -1;
  if (!staged && (bx != 1 || xs == nullptr)) return -1;
  if ((long long)27 * Cf >= INT_MAX) return -1;   // a column is an int
  if ((long long)(bx + 2) * 9 * Cf >= INT_MAX) return -1;
  if ((long long)d0 * d1 * d2 >= INT_MAX) return -1;
  const long long grid = (long long)((d0 + bx - 1) / bx) * d1 * d2;
  if (grid < 1 || grid >= INT_MAX) return -1;
  const CandLayout L = cand_layout(warps, cap, bucket, bx, staged, Cf, nt);
  if (L.total > (size_t)kSmemLimit) return -1;
  const CandArgs a{reinterpret_cast<const float4*>(xt),
                   reinterpret_cast<const float4*>(xs), order, starts, cut,
                   origin, static_cast<long long*>(idx),
                   static_cast<long long*>(jtype), static_cast<bool*>(mask),
                   static_cast<unsigned long long*>(kmax), size, nt, d0, d1,
                   d2, Cf, n, m_all, K, cap, bx};
  // all four kernels opt in at the first call, so that a later one that a
  // graph captures (a re-sized plan may take another) only launches
  static bool opted[4][kMaxDevices] = {};
  int err = opt_in(select_candidates_kernel<true, true>, opted[0]);
  if (!err) err = opt_in(select_candidates_kernel<true, false>, opted[1]);
  if (!err) err = opt_in(select_candidates_kernel<false, true>, opted[2]);
  if (!err) err = opt_in(select_candidates_kernel<false, false>, opted[3]);
  if (err) return err;
  const dim3 blocks((unsigned)grid), threads(32 * warps);
  if (staged && bucket)
    select_candidates_kernel<true, true><<<blocks, threads, L.total, s>>>(a);
  else if (staged)
    select_candidates_kernel<true, false><<<blocks, threads, L.total, s>>>(a);
  else if (bucket)
    select_candidates_kernel<false, true><<<blocks, threads, L.total, s>>>(a);
  else
    select_candidates_kernel<false, false><<<blocks, threads, L.total, s>>>(
        a);
  return (int)cudaGetLastError();
}
