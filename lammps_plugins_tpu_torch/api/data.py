"""LAMMPS data files: read_data and write_data (port of
lammps_plugins_tpu/api/data.py; the same parsing and the same text).

The reference examples build their systems with lattice/create_atoms, but
the standard LAMMPS workflow for bringing external configurations is data
files — any user switching from the reference stack needs them.  Format
follows LAMMPS read_data docs for the atom styles this framework supports:

  header:   first line is a comment; then `N atoms`, `T atom types`,
            `xlo xhi` / `ylo yhi` / `zlo zhi`, optional `xy xz yz`
  sections: Masses, Atoms (# atomic | charge), Velocities

Atom lines: `id type [q] x y z [ix iy iz]` (charge column present exactly
for atom_style charge).  Atom ids may appear in any order; arrays are
returned id-sorted (ids must be 1..N, LAMMPS "must be contiguous" rule for
the styles supported here).  Topology sections (bonds/angles/...) are not
part of the reference's capability set and raise a precise error.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import Box
from ..core.device import resolve
from ..core.state import State

_HEADER_KEYS = ("atoms", "atom types", "xlo xhi", "ylo yhi", "zlo zhi",
                "xy xz yz")
_UNSUPPORTED_COUNTS = ("bonds", "angles", "dihedrals", "impropers",
                       "bond types", "angle types", "dihedral types",
                       "improper types", "ellipsoids", "lines",
                       "triangles", "bodies")
_SECTIONS = ("Masses", "Atoms", "Velocities")
_UNSUPPORTED_SECTIONS = ("Bonds", "Angles", "Dihedrals", "Impropers",
                         "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs",
                         "Angle Coeffs", "Dihedral Coeffs",
                         "Improper Coeffs", "Atoms # bond",
                         "Atoms # molecular", "Atoms # full")


def _strip(line: str) -> str:
    return line.split("#", 1)[0].strip()


def read_data(path: str, atom_style: str = "atomic",
              periodic=(True, True, True), dtype=torch.float32,
              device="cuda") -> State:
    """Parse a LAMMPS data file into a State (velocities zero if absent)
    on `device` (the card unless the caller asks for the CPU)."""
    resolve(device)
    with open(path) as fh:
        lines = fh.readlines()
    i = 1                                   # first line is always a comment
    n = ntypes = None
    lo = np.zeros(3)
    hi = np.ones(3)
    tilt = np.zeros(3)

    # ---- header: until the first section keyword ----
    section = None
    while i < len(lines):
        raw = lines[i]
        line = _strip(raw)
        i += 1
        if not line:
            continue
        tok = line.split()
        if tok[0][0].isalpha() or tok[0][0] == '_':
            section = raw.strip()     # keep any "# style" comment
            break
        # numeric-led header line
        key = " ".join(t for t in tok if not _is_number(t))
        nums = [float(t) for t in tok if _is_number(t)]
        if key == "atoms":
            n = int(nums[0])
        elif key == "atom types":
            ntypes = int(nums[0])
        elif key in ("xlo xhi", "ylo yhi", "zlo zhi"):
            d = {"x": 0, "y": 1, "z": 2}[key[0]]
            lo[d], hi[d] = nums
        elif key == "xy xz yz":
            tilt[:] = nums
        elif key in _UNSUPPORTED_COUNTS:
            if nums[0] != 0:
                raise ValueError(
                    f"read_data: '{key}' topology is not supported "
                    f"(this framework covers the reference's atomic/charge "
                    f"styles); got {int(nums[0])} in {path}")
        else:
            raise ValueError(f"read_data: unknown header line {line!r}")
    if n is None or ntypes is None:
        raise ValueError("read_data: header missing atoms / atom types")

    box = Box.triclinic(hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2],
                        xy=tilt[0], xz=tilt[1], yz=tilt[2],
                        lo=tuple(lo), periodic=tuple(periodic), dtype=dtype,
                        device=device)

    mass = np.zeros(ntypes + 1)
    x = np.zeros((n, 3))
    v = np.zeros((n, 3))
    q = np.zeros(n)
    types = np.zeros(n, np.int64)
    image = np.zeros((n, 3), np.int64)
    seen_atoms = False

    # ---- sections ----
    while section is not None:
        name = section.split("#")[0].strip()
        style = (section.split("#", 1)[1].strip()
                 if "#" in section else None)
        rows = []
        nxt = None
        while i < len(lines):
            line = _strip(lines[i])
            raw = lines[i]
            i += 1
            if not line:
                continue
            if line.split()[0][0].isalpha():
                nxt = raw.strip()    # next section header (keep its
                break                # "# style" comment)
            rows.append(line.split())
        if name == "Masses":
            for r in rows:
                mass[int(r[0])] = float(r[1])
        elif name == "Atoms":
            st = style or atom_style
            if st not in ("atomic", "charge"):
                raise ValueError(f"read_data: atom style {st!r} not "
                                 "supported (atomic/charge only)")
            ncol = {"atomic": 5, "charge": 6}[st]
            for r in rows:
                if len(r) not in (ncol, ncol + 3):
                    raise ValueError(
                        f"read_data: bad Atoms ({st}) line width "
                        f"{len(r)}: {' '.join(r)}")
                aid = int(r[0]) - 1
                if not 0 <= aid < n:
                    raise ValueError(f"read_data: atom id {aid+1} out of "
                                     f"1..{n}")
                types[aid] = int(r[1])
                c = 2
                if st == "charge":
                    q[aid] = float(r[c]); c += 1
                x[aid] = [float(r[c]), float(r[c + 1]), float(r[c + 2])]
                if len(r) == ncol + 3:
                    image[aid] = [int(r[ncol]), int(r[ncol + 1]),
                                  int(r[ncol + 2])]
            seen_atoms = True
        elif name == "Velocities":
            for r in rows:
                v[int(r[0]) - 1] = [float(r[1]), float(r[2]), float(r[3])]
        else:
            raise ValueError(
                f"read_data: section {name!r} not supported (this "
                "framework covers Masses/Atoms/Velocities for the "
                "reference's atomic/charge styles)")
        section = nxt
        nxt = None
        if section is not None and not section:
            section = None
    if not seen_atoms:
        raise ValueError("read_data: no Atoms section")
    if (types < 1).any() or (types > ntypes).any():
        raise ValueError("read_data: atom type out of range (or an atom "
                         "id missing from the Atoms section)")
    return State.create(x=x, type=types, box=box, mass=mass, v=v, q=q,
                        image=image)


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def write_data(path: str, state: State, atom_style: str = "atomic",
               comment: str = "LAMMPS data file (lammps_plugins_tpu)"):
    """Write a State as a LAMMPS data file (readable by LAMMPS itself)."""
    if atom_style not in ("atomic", "charge"):
        raise ValueError(f"write_data: atom style {atom_style!r} not "
                         "supported (atomic/charge only)")
    h = state.box.h_np()
    lo = state.box.lo_np()
    x, v, q, t, im, mass = (a.detach().cpu().numpy() for a in (
        state.x, state.v, state.q, state.type, state.image, state.mass))
    n = x.shape[0]
    ntypes = len(mass) - 1
    with open(path, "w") as fh:
        fh.write(f"{comment}\n\n")
        fh.write(f"{n} atoms\n{ntypes} atom types\n\n")
        fh.write(f"{lo[0]:.16g} {lo[0]+h[0,0]:.16g} xlo xhi\n")
        fh.write(f"{lo[1]:.16g} {lo[1]+h[1,1]:.16g} ylo yhi\n")
        fh.write(f"{lo[2]:.16g} {lo[2]+h[2,2]:.16g} zlo zhi\n")
        if h[1, 0] or h[2, 0] or h[2, 1]:
            fh.write(f"{h[1,0]:.16g} {h[2,0]:.16g} {h[2,1]:.16g} "
                     "xy xz yz\n")
        fh.write("\nMasses\n\n")
        for i in range(1, ntypes + 1):
            fh.write(f"{i} {mass[i]:.16g}\n")
        fh.write(f"\nAtoms # {atom_style}\n\n")
        for i in range(n):
            qcol = f" {q[i]:.16g}" if atom_style == "charge" else ""
            fh.write(f"{i+1} {t[i]}{qcol} "
                     f"{x[i,0]:.16g} {x[i,1]:.16g} {x[i,2]:.16g} "
                     f"{im[i,0]} {im[i,1]} {im[i,2]}\n")
        fh.write("\nVelocities\n\n")
        for i in range(n):
            fh.write(f"{i+1} {v[i,0]:.16g} {v[i,1]:.16g} {v[i,2]:.16g}\n")
