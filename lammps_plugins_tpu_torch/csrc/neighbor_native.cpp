// Native cell-binned pair search for the host neighbor build (the port's
// own copy of lammps_plugins_tpu/ops/neighbor_native.cpp; built with g++
// by ops/native.py, never by nvcc).  The CPU parity tests use it; the
// card's path is the on-device rebuild.
//
// Algorithm: uniform grid at cell size >= cutoff over owned+ghost
// positions, CSR bucketing by cell, then for every owned atom scan the 27
// surrounding cells.  Threaded over owned atoms with per-thread output
// buffers (deterministic order: results are concatenated thread-major,
// then re-sorted by center on the Python side).
//
// C ABI for ctypes:
//   npairs = lpt_find_pairs(x_own, n_own, x_all, n_all, rcut, nthreads,
//                           &pi, &pj, &rsq)     // buffers malloc'd here
//   lpt_free(ptr)                               // caller frees all three

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Grid {
  double mn[3];
  double inv_cell;
  int64_t dims[3];

  int64_t cell_of(const double* p) const {
    int64_t c[3];
    for (int d = 0; d < 3; ++d) {
      int64_t v = (int64_t)std::floor((p[d] - mn[d]) * inv_cell);
      c[d] = std::max<int64_t>(0, std::min(dims[d] - 1, v));
    }
    return (c[0] * dims[1] + c[1]) * dims[2] + c[2];
  }
};

}  // namespace

extern "C" {

int64_t lpt_find_pairs(const double* x_own, int64_t n_own,
                       const double* x_all, int64_t n_all, double rcut,
                       int nthreads, int32_t** out_i, int32_t** out_j,
                       double** out_rsq) {
  Grid g;
  for (int d = 0; d < 3; ++d) {
    double lo = 1e300, hi = -1e300;
    for (int64_t i = 0; i < n_all; ++i) {
      lo = std::min(lo, x_all[3 * i + d]);
      hi = std::max(hi, x_all[3 * i + d]);
    }
    g.mn[d] = lo - 1e-9;
    g.dims[d] = std::max<int64_t>(1, (int64_t)((hi - lo) / rcut) + 1);
  }
  g.inv_cell = 1.0 / rcut;

  const int64_t ncells = g.dims[0] * g.dims[1] * g.dims[2];

  // CSR bucket of all atoms by cell
  std::vector<int64_t> cell_id(n_all);
  std::vector<int64_t> counts(ncells + 1, 0);
  for (int64_t i = 0; i < n_all; ++i) {
    cell_id[i] = g.cell_of(x_all + 3 * i);
    counts[cell_id[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  std::vector<int32_t> bucket(n_all);
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n_all; ++i)
      bucket[cursor[cell_id[i]]++] = (int32_t)i;
  }

  const double rcut_sq = rcut * rcut;
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));

  struct Out {
    std::vector<int32_t> pi, pj;
    std::vector<double> rsq;
  };
  std::vector<Out> outs(nthreads);

  auto worker = [&](int t) {
    Out& o = outs[t];
    o.pi.reserve(4096);
    const int64_t chunk = (n_own + nthreads - 1) / nthreads;
    const int64_t beg = t * chunk, end = std::min<int64_t>(n_own, beg + chunk);
    for (int64_t i = beg; i < end; ++i) {
      const double* xi = x_own + 3 * i;
      int64_t ci[3];
      for (int d = 0; d < 3; ++d) {
        int64_t v = (int64_t)std::floor((xi[d] - g.mn[d]) * g.inv_cell);
        ci[d] = std::max<int64_t>(0, std::min(g.dims[d] - 1, v));
      }
      for (int64_t a = std::max<int64_t>(0, ci[0] - 1);
           a <= std::min(g.dims[0] - 1, ci[0] + 1); ++a)
        for (int64_t b = std::max<int64_t>(0, ci[1] - 1);
             b <= std::min(g.dims[1] - 1, ci[1] + 1); ++b)
          for (int64_t c = std::max<int64_t>(0, ci[2] - 1);
               c <= std::min(g.dims[2] - 1, ci[2] + 1); ++c) {
            const int64_t cid = (a * g.dims[1] + b) * g.dims[2] + c;
            for (int64_t k = counts[cid]; k < counts[cid + 1]; ++k) {
              const int32_t j = bucket[k];
              if ((int64_t)j == i) continue;
              const double* xj = x_all + 3 * j;
              const double dx = xi[0] - xj[0];
              const double dy = xi[1] - xj[1];
              const double dz = xi[2] - xj[2];
              const double r2 = dx * dx + dy * dy + dz * dz;
              if (r2 < rcut_sq) {
                o.pi.push_back((int32_t)i);
                o.pj.push_back(j);
                o.rsq.push_back(r2);
              }
            }
          }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& o : outs) total += (int64_t)o.pi.size();

  *out_i = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(total, 1));
  *out_j = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(total, 1));
  *out_rsq = (double*)std::malloc(sizeof(double) * std::max<int64_t>(total, 1));
  int64_t off = 0;
  for (auto& o : outs) {
    std::memcpy(*out_i + off, o.pi.data(), o.pi.size() * sizeof(int32_t));
    std::memcpy(*out_j + off, o.pj.data(), o.pj.size() * sizeof(int32_t));
    std::memcpy(*out_rsq + off, o.rsq.data(), o.rsq.size() * sizeof(double));
    off += (int64_t)o.pi.size();
  }
  return total;
}

void lpt_free(void* p) { std::free(p); }

}  // extern "C"
