"""AEAM tabulated-spline coefficients (the port's own copy of
make_spline from lammps_plugins_tpu/potentials/spline.py, numpy only).

Reproduces PairAEAM::interpolate (pair_aeam.cpp:915-942) in float64: a
7-coefficient cubic-Hermite representation per knot where

  spline[m][6] = f(m)                       (table value)
  spline[m][5] = 4th-order finite-difference derivative (interior),
                 one-sided at the ends
  spline[m][4], spline[m][3] = Hermite cubic coefficients
  spline[m][0..2] = derivative-polynomial coefficients / delta

Lookup (pair_aeam.cpp:196-203): p = r/dr + 1; m = int(p) clamped; p -= m;
value  = ((c3*p + c4)*p + c5)*p + c6
deriv  =  (c0*p + c1)*p + c2
"""

from __future__ import annotations

import numpy as np


def make_spline(f: np.ndarray, n: int, delta: float) -> np.ndarray:
    """Build [n+1, 7] coefficients from a 1-indexed table f[1..n].

    Mirrors pair_aeam.cpp:915-942 line-for-line in semantics (not code):
    row 0 is unused padding to keep LAMMPS's 1-based index arithmetic.
    """
    s = np.zeros((n + 1, 7), dtype=np.float64)
    s[1:, 6] = f[1:n + 1]

    s[1, 5] = s[2, 6] - s[1, 6]
    s[2, 5] = 0.5 * (s[3, 6] - s[1, 6])
    s[n - 1, 5] = 0.5 * (s[n, 6] - s[n - 2, 6])
    s[n, 5] = s[n, 6] - s[n - 1, 6]

    m = np.arange(3, n - 1)
    s[m, 5] = ((s[m - 2, 6] - s[m + 2, 6])
               + 8.0 * (s[m + 1, 6] - s[m - 1, 6])) / 12.0

    m = np.arange(1, n)
    s[m, 4] = 3.0 * (s[m + 1, 6] - s[m, 6]) - 2.0 * s[m, 5] - s[m + 1, 5]
    s[m, 3] = s[m, 5] + s[m + 1, 5] - 2.0 * (s[m + 1, 6] - s[m, 6])
    s[n, 4] = 0.0
    s[n, 3] = 0.0

    s[1:, 2] = s[1:, 5] / delta
    s[1:, 1] = 2.0 * s[1:, 4] / delta
    s[1:, 0] = 3.0 * s[1:, 3] / delta
    return s
