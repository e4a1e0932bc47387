"""Potential-file parsers (the port's own copy of the REBOMOS and AEAM
parts of lammps_plugins_tpu/potentials/tables.py, which the port does not
import).

REBOMOS, PotentialFileReader semantics: one value per line (first
whitespace token), '#' comments skipped, 61 doubles in fixed order
(pair_rebomos.cpp:884-948).  AEAM: the setfl-like AlSi.aeam layout
(read_aeam).  Parsed tables are float64 numpy; device placement and dtype
happen in the pair style.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


#: Parameter order in the file (pair_rebomos.cpp:884-948).
_REBO_PARAM_ORDER = (
    ["rcmin_MM", "rcmin_MS", "rcmin_SS",
     "rcmax_MM", "rcmax_MS", "rcmax_SS",
     "Q_MM", "Q_MS", "Q_SS",
     "alpha_MM", "alpha_MS", "alpha_SS",
     "A_MM", "A_MS", "A_SS",
     "BIJc_MM", "BIJc_MS", "BIJc_SS",
     "Beta_MM", "Beta_MS", "Beta_SS"]
    + [f"M_b{i}" for i in range(7)]
    + [f"M_bg{i}" for i in range(7)]
    + [f"S_b{i}" for i in range(7)]
    + [f"S_bg{i}" for i in range(7)]
    + [f"M_a{i}" for i in range(4)]
    + [f"S_a{i}" for i in range(4)]
    + ["epsilon_MM", "epsilon_SS", "sigma_MM", "sigma_SS"]
)


@dataclasses.dataclass
class REBOMoSTables:
    """All REBOMOS parameters as [2,2] / [2,k] float64 arrays (0=Mo, 1=S)."""

    rcmin: np.ndarray     # [2,2]
    rcmax: np.ndarray
    Q: np.ndarray
    alpha: np.ndarray
    A: np.ndarray
    BIJc: np.ndarray
    Beta: np.ndarray
    b: np.ndarray         # [2,7] g-polynomial b0..b6 per element
    bg: np.ndarray        # [2,7] second g-polynomial bg0..bg6
    a: np.ndarray         # [2,4] P(N) coefficients a0..a3
    epsilon: np.ndarray   # [2,2] mixed (pair_rebomos.cpp:1053-1056)
    sigma: np.ndarray     # [2,2] mixed (pair_rebomos.cpp:1048-1051)
    rcLJmin: np.ndarray   # [2,2] = rcmin (pair_rebomos.cpp:1058-1061)
    rcLJmax: np.ndarray   # [2,2] = 2.5*sigma (pair_rebomos.cpp:1063-1066)
    lj1: np.ndarray       # 48 eps sig^12   (pair_rebomos.cpp:262)
    lj2: np.ndarray       # 24 eps sig^6
    lj3: np.ndarray       # 4 eps sig^12
    lj4: np.ndarray       # 4 eps sig^6

    @property
    def cut3rebo(self) -> float:
        """Master-list cutoff: 3 * rcmax_MoMo (pair_rebomos.cpp:257)."""
        return 3.0 * float(self.rcmax[0, 0])


def _sym22(mm, ms, ss):
    return np.array([[mm, ms], [ms, ss]], dtype=np.float64)


def read_rebomos(path: str) -> REBOMoSTables:
    vals: List[float] = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            vals.append(float(line.split()[0]))
    if len(vals) < len(_REBO_PARAM_ORDER):
        raise ValueError(
            f"{path}: expected {len(_REBO_PARAM_ORDER)} parameters, "
            f"got {len(vals)}")
    p = dict(zip(_REBO_PARAM_ORDER, vals))

    sigma = _sym22(p["sigma_MM"],
                   0.5 * (p["sigma_MM"] + p["sigma_SS"]),
                   p["sigma_SS"])
    epsilon = _sym22(p["epsilon_MM"],
                     np.sqrt(p["epsilon_MM"] * p["epsilon_SS"]),
                     p["epsilon_SS"])

    return REBOMoSTables(
        rcmin=_sym22(p["rcmin_MM"], p["rcmin_MS"], p["rcmin_SS"]),
        rcmax=_sym22(p["rcmax_MM"], p["rcmax_MS"], p["rcmax_SS"]),
        Q=_sym22(p["Q_MM"], p["Q_MS"], p["Q_SS"]),
        alpha=_sym22(p["alpha_MM"], p["alpha_MS"], p["alpha_SS"]),
        A=_sym22(p["A_MM"], p["A_MS"], p["A_SS"]),
        BIJc=_sym22(p["BIJc_MM"], p["BIJc_MS"], p["BIJc_SS"]),
        Beta=_sym22(p["Beta_MM"], p["Beta_MS"], p["Beta_SS"]),
        b=np.array([[p[f"M_b{i}"] for i in range(7)],
                    [p[f"S_b{i}"] for i in range(7)]]),
        bg=np.array([[p[f"M_bg{i}"] for i in range(7)],
                     [p[f"S_bg{i}"] for i in range(7)]]),
        a=np.array([[p[f"M_a{i}"] for i in range(4)],
                    [p[f"S_a{i}"] for i in range(4)]]),
        epsilon=epsilon,
        sigma=sigma,
        rcLJmin=_sym22(p["rcmin_MM"], p["rcmin_MS"], p["rcmin_SS"]),
        rcLJmax=2.5 * sigma,
        lj1=48.0 * epsilon * sigma ** 12,
        lj2=24.0 * epsilon * sigma ** 6,
        lj3=4.0 * epsilon * sigma ** 12,
        lj4=4.0 * epsilon * sigma ** 6,
    )


# ---------------------------------------------------------------------------
# AEAM setfl
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AEAMTables:
    """Parsed AlSi.aeam contents; tabulated arrays are 1-indexed like the
    reference (index 0 unused) to keep the spline index arithmetic identical
    (pair_aeam.cpp:196-201)."""

    nelements: int
    nnonangular: int
    nangular: int
    elements: List[str]
    mass: np.ndarray          # [nel]
    nrho: np.ndarray          # [nel] int
    drho: np.ndarray          # [nel]
    nr: np.ndarray            # [nel,nel] int
    dr: np.ndarray            # [nel,nel]
    cut: np.ndarray           # [nel,nel]
    frho: List[np.ndarray]        # per element, [nrho+1]
    rhor: List[List[np.ndarray]]  # [i][j] -> [nr+1]
    z2r: dict                     # (i,j) j<=i -> [nr+1]  (phi(r), unscaled)


class _NumberStream:
    """Sequential float reader over the remaining lines of a file."""

    def __init__(self, lines: List[str]):
        self._tokens = []
        for line in lines:
            self._tokens.extend(line.split())
        self._pos = 0

    def take(self, n: int) -> np.ndarray:
        out = np.array([float(t) for t in
                        self._tokens[self._pos:self._pos + n]])
        if len(out) != n:
            raise ValueError(f"AEAM table truncated: wanted {n} values, "
                             f"got {len(out)}")
        self._pos += n
        return out


def read_aeam(path: str) -> AEAMTables:
    with open(path) as fh:
        lines = fh.read().splitlines()

    # reference skips 12 header lines and parses the 12th as the element
    # line: "nelements nnonangular nangular names..." (pair_aeam.cpp:645-663)
    header = lines[11].split()
    nel = int(header[0])
    nnon = int(header[1])
    nang = int(header[2])
    elements = header[3:3 + nel]

    pos = 12
    mass = np.zeros(nel)
    nrho = np.zeros(nel, dtype=np.int64)
    drho = np.zeros(nel)
    for i in range(nel):
        toks = lines[pos].split()
        nrho[i] = int(float(toks[0]))
        drho[i] = float(toks[1])
        mass[i] = float(toks[2])
        pos += 1

    nr = np.zeros((nel, nel), dtype=np.int64)
    dr = np.zeros((nel, nel))
    cut = np.zeros((nel, nel))
    for i in range(nel):
        for j in range(nel):
            toks = lines[pos].split()
            nr[i, j] = int(float(toks[0]))
            dr[i, j] = float(toks[1])
            cut[i, j] = float(toks[2])
            pos += 1

    stream = _NumberStream(lines[pos:])

    def one_indexed(vals: np.ndarray) -> np.ndarray:
        out = np.zeros(len(vals) + 1)
        out[1:] = vals
        return out

    frho = [one_indexed(stream.take(int(nrho[i]))) for i in range(nel)]
    rhor = [[one_indexed(stream.take(int(nr[i, j]))) for j in range(nel)]
            for i in range(nel)]
    z2r = {}
    for i in range(nel):
        for j in range(i + 1):
            z2r[(i, j)] = one_indexed(stream.take(int(nr[i, j])))

    return AEAMTables(nelements=nel, nnonangular=nnon, nangular=nang,
                      elements=elements, mass=mass, nrho=nrho, drho=drho,
                      nr=nr, dr=dr, cut=cut, frho=frho, rhor=rhor, z2r=z2r)
