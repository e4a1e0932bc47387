"""Piecewise-Chebyshev refits of tabulated pair functions (AEAM fast mode).

The port's own copy of lammps_plugins_tpu/potentials/polyfit.py (numpy
only); the text below is the original's.

The AEAM hot step is gather-bound: the per-edge cubic-spline lookups
(pair_aeam.cpp:196-201 turned into fused 21-wide table-row gathers) cost
~1/3 of the step plus the layout copies of the gathered [N, K, 21] tensor.
This module refits each tabulated f(r) / phi(r) with NSEG piecewise
Chebyshev polynomials on a segment grid SHARED across tables in the
normalized coordinate u = r / cut_ij, so the hot path can evaluate value
and derivative IN REGISTERS from compile-time constants — no table gather
at all.  Forces become the exact analytic gradient of the refitted
(smooth, C^0-between-segments) Hamiltonian.

Fidelity (measured against the reference spline on the shipped AlSi.aeam,
r >= 2.0 A — stored in PolyTables.err for any file):
  * f (density) tables: value ~6e-8 (the table's own quantization),
    derivative ~3e-4 (the spline derivative's quantization jitter, which a
    smooth fit averages instead of following).
  * phi tables: value <= 5e-6 and derivative <= 3e-3 everywhere EXCEPT a
    genuinely noisy patch of the AlAl table (broadband ~1e-4 wiggles in
    r in [2.11, 2.43], far below the 2.86 A first-neighbor shell) where
    the derivative deviation reaches ~2e-2 eV/A.
This mode is therefore OPT-IN (AEAM(..., poly_mode=True)): the default
path reproduces the table spline to float precision.  Below r = U0 * cut the polynomial argument is clamped (the
repulsive wall there is physically unreachable; the default path remains
exact).
"""

from __future__ import annotations

import numpy as np
import numpy.polynomial.chebyshev as _cheb

U0 = 0.28          # fit domain in u = r/cut: [U0, 1.0]
NSEG = 8
DEG = 12           # coefficients per segment = DEG + 1


class PolyTables:
    """Power-basis segment coefficients for all (i, j) pair tables.

    Attributes:
      f_coef:   [nel*nel, NSEG, DEG+1] density-spline refit (direction
                (center_el, neighbor_el) like rhor).
      phi_coef: [nel*nel, NSEG, DEG+1] pair-potential refit (symmetric;
                stored per directed code for uniform indexing).
      err:      {"f": (val, deriv), "phi": (val, deriv)} max deviations
                vs the table spline, measured on r in [2.0, cut].
    """

    def __init__(self, f_coef, phi_coef, err):
        self.f_coef = f_coef
        self.phi_coef = phi_coef
        self.err = err


def _spline_eval_np(coef, nr, dr, r):
    """Reference spline evaluation (matches aeam._spline_eval, float64)."""
    p_raw = r / dr + 1.0
    m = np.minimum(np.floor(p_raw).astype(np.int64), nr - 1)
    m = np.maximum(m, 1)
    p = np.minimum(p_raw - m, 1.0)
    c = coef[m]
    val = ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]
    der = (c[..., 0] * p + c[..., 1]) * p + c[..., 2]
    return val, der


def _fit_one(spline_coef, nr, dr, cut, rphys_lo=2.0, samples=24000):
    """Fit one table; returns ([NSEG, DEG+1], max_val_err, max_der_err)."""
    out = np.zeros((NSEG, DEG + 1))
    wv = wd = 0.0
    uedges = np.linspace(U0, 1.0, NSEG + 1)
    for s, (a, b) in enumerate(zip(uedges[:-1], uedges[1:])):
        ra, rb = a * cut, b * cut
        r = np.linspace(ra, rb, samples)
        v, d = _spline_eval_np(spline_coef, nr, dr, r)
        xi = 2.0 * (r - ra) / (rb - ra) - 1.0
        c = _cheb.chebfit(xi, v, DEG)
        # power basis in the local coordinate v in [-1, 1] (Horner-able);
        # cheb2poly is well-conditioned at DEG=12 in float64
        out[s] = _cheb.cheb2poly(c)
        vv = _cheb.chebval(xi, c)
        dd = _cheb.chebval(xi, _cheb.chebder(c)) * 2.0 / (rb - ra)
        msk = r >= rphys_lo
        if msk.any():
            wv = max(wv, float(np.abs(vv - v)[msk].max()))
            wd = max(wd, float(np.abs(dd - d)[msk].max()))
    return out, wv, wd


def fit_aeam_polys(tables, rhor_splines, z2r_splines, z2r_map) -> PolyTables:
    """Fit every (i, j) density table and every unordered phi table.

    Args:
      tables: AEAMTables (for nr/dr/cut).
      rhor_splines: [nel*nel, nrmax+1, 7] spline coefficients (f64).
      z2r_splines: [nz2r, nrmax+1, 7] spline coefficients (f64).
      z2r_map: [nel, nel] -> z2r row.
    Requires symmetric r grids / cuts (true for the AEAM file format,
    which defines one grid per unordered pair).
    """
    nel = tables.nelements
    f_coef = np.zeros((nel * nel, NSEG, DEG + 1))
    phi_coef = np.zeros((nel * nel, NSEG, DEG + 1))
    err = {"f": [0.0, 0.0], "phi": [0.0, 0.0]}
    for i in range(nel):
        for j in range(nel):
            k = i * nel + j
            nr, dr, cut = (int(tables.nr[i, j]), float(tables.dr[i, j]),
                           float(tables.cut[i, j]))
            c, wv, wd = _fit_one(rhor_splines[k], nr, dr, cut)
            f_coef[k] = c
            err["f"] = [max(err["f"][0], wv), max(err["f"][1], wd)]
            c, wv, wd = _fit_one(z2r_splines[int(z2r_map[i, j])], nr, dr,
                                 cut)
            phi_coef[k] = c
            err["phi"] = [max(err["phi"][0], wv), max(err["phi"][1], wd)]
    return PolyTables(f_coef, phi_coef,
                      {k: tuple(v) for k, v in err.items()})
