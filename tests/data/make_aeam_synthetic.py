#!/usr/bin/env python3
"""Write the synthetic AEAM parameter files of the tests and the chip smoke.

    python3 tests/data/make_aeam_synthetic.py

writes, beside this script:

  AlSi.synthetic.aeam       symmetric r-grids (dr[i, j] == dr[j, i]), so
                            the fast force path runs
  AlSi.synthetic.asym.aeam  the Si-Al grid differs from the Al-Si one, so
                            forces take the autograd / mirror fallback

The layout is the one read_aeam parses (the published AlSi.aeam's): 11
comment lines, the element line `2 1 1 Al Si` (two elements, one
non-angular, one angular), per element `nrho drho mass`, per ordered pair
`nr dr cut`, then F(rho) per element, rho_ij(r) per ordered pair and
phi_ij(r) per unordered pair (j <= i), 1-indexed from r = 0 and rho = 0.
The cutoffs are the published ones: 6.5 A Al-Al, 4.18 A Al-Si and 5.28 A
Si-Si, with masses 26.98 and 28.0855.

The functions are analytic with smooth cutoffs, fc(r) = x^4 / (1 + x^4),
x = (rc - r) / w for r < rc and 0 beyond: Morse pair terms (Al-Al after
Girifalco and Weizer, r0 set so that fcc Al rests near a = 4.045 A),
exponential densities, and smooth embeddings (Al: -sqrt(rho / 12); Si,
whose argument is sqrt(rho_angular): -0.8 y + 0.02 y^2).  The Si-Si
density is zero beyond cut - 1.5 = 3.78 A, as the published file's is,
so the reference's force-pass inconsistency has no effect.  They stand in
for the published parameters (not in the repository): the neighbour
geometry and K depend only on the cutoffs and positions.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NR = 2000
NRHO = 2000
CUT = np.array([[6.5, 4.18], [4.18, 5.28]])
MASS = (26.98, 28.0855)
DRHO = (0.02, 0.01)          # Al: rho up to 40; Si: sqrt(rho) up to 20


def fc(r, rc, w):
    x = np.clip((rc - r) / w, 0.0, None)
    return x ** 4 / (1.0 + x ** 4)


def morse(r, d, a, r0):
    return d * (np.exp(-2.0 * a * (r - r0)) - 2.0 * np.exp(-a * (r - r0)))


#: rho_ij(r): density at a centre of element i from a neighbour of j
DENSITY = {
    (0, 0): lambda r: np.exp(-1.5 * (r - 2.86)) * fc(r, 6.5, 1.0),
    (0, 1): lambda r: 1.2 * np.exp(-1.5 * (r - 2.86)) * fc(r, 4.18, 0.5),
    (1, 0): lambda r: 0.8 * np.exp(-1.8 * (r - 2.86)) * fc(r, 4.18, 0.5),
    (1, 1): lambda r: np.exp(-2.0 * (r - 2.35)) * fc(r, 3.78, 0.5),
}
#: phi_ij(r), stored unscaled (pair_aeam.cpp:369)
PAIR = {
    (0, 0): lambda r: morse(r, 0.2703, 1.1646, 3.283) * fc(r, 6.5, 1.0),
    (1, 0): lambda r: morse(r, 0.30, 1.30, 2.90) * fc(r, 4.18, 0.5),
    (1, 1): lambda r: morse(r, 0.50, 1.40, 2.40) * fc(r, 5.28, 0.8),
}
EMBED = (lambda rho: -np.sqrt(rho / 12.0),
         lambda y: -0.8 * y + 0.02 * y * y)


def write(path, dr):
    """dr [2, 2]: the r spacing per ordered pair (NR knots from r = 0)."""
    lines = [f"# synthetic AEAM parameters for Al-Si ({os.path.basename(path)})",
             "# written by tests/data/make_aeam_synthetic.py; analytic",
             "# functions with smooth cutoffs, not fitted to any data"]
    lines += ["#"] * (11 - len(lines))
    lines.append("2 1 1 Al Si")
    for i in range(2):
        lines.append(f"{NRHO} {DRHO[i]:.16e} {MASS[i]}")
    for i in range(2):
        for j in range(2):
            lines.append(f"{NR} {dr[i][j]:.16e} {CUT[i, j]}")
    values = []
    for i in range(2):
        values.append(EMBED[i](np.arange(NRHO) * DRHO[i]))
    for i in range(2):
        for j in range(2):
            values.append(DENSITY[(i, j)](np.arange(NR) * dr[i][j]))
    for i in range(2):
        for j in range(i + 1):
            values.append(PAIR[(i, j)](np.arange(NR) * dr[i][j]))
    flat = np.concatenate(values)
    for k in range(0, len(flat), 5):
        lines.append(" ".join(f"{v:.10e}" for v in flat[k:k + 5]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def main():
    sym = CUT / (NR - 1)
    write(os.path.join(HERE, "AlSi.synthetic.aeam"), sym)
    asym = sym.copy()
    asym[1, 0] = 4.20 / (NR - 1)
    write(os.path.join(HERE, "AlSi.synthetic.asym.aeam"), asym)


if __name__ == "__main__":
    main()
