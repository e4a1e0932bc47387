"""Scenes (port of lammps_plugins_tpu/api/scenes.py): the REBOMOS bulk
and monolayer, the AEAM sample.in cell, and the two LJ decks of the JAX
package's tests (tests/test_ljcut.py: LAMMPS's bench/in.lj melt and the
charged LJ/Coulomb melt under fix bfield).

Same constructions as the JAX package (its scene functions and its
`Script` on the decks' text), so both packages build identical atom
orders, positions, types, charges, masses and velocities from the same
arguments.  The scenes are built on the card (float32) unless the caller
passes device="cpu".  lj_melt and charged_melt return a Deck: the state
with the deck's pair style, fixes, units and skin.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core import units as units_mod
from ..core.box import Box
from ..core.lattice import Lattice, create_atoms_box
from ..core.state import State
from ..fixes.base import Fix
from ..fixes.bfield import FixBfield
from ..fixes.nve import FixNVE
from ..fixes.velocity import set_type_fraction, velocity_create
from ..potentials.base import PairStyle
from ..potentials.ljcut import PairLJCut, PairLJCutCoulCut

#: MoS2 2H lattice from USER-REBOMOS/in.rebomos-bulk:3-12.
MOS2_A1 = (3.1903157234, 0.0, 0.0)
MOS2_A2 = (-1.5964590311, 2.7651481541, 0.0)
MOS2_A3 = (0.0, 0.0, 13.9827680588)
MOS2_BASIS = (
    (0.0, 0.0, 3.0 / 4.0),
    (0.0, 0.0, 1.0 / 4.0),
    (2.0 / 3.0, 1.0 / 3.0, 0.862008989),
    (1.0 / 3.0, 2.0 / 3.0, 0.137990996),
    (1.0 / 3.0, 2.0 / 3.0, 0.362008989),
    (2.0 / 3.0, 1.0 / 3.0, 0.637991011),
)
MOS2_BASIS_TYPES = (1, 1, 2, 2, 2, 2)      # Mo Mo S S S S
MOS2_MASSES = (95.95, 32.065)              # in.rebomos-bulk:24-25


def mos2_lattice(origin=(0.1, 0.1, 0.1)) -> Lattice:
    return Lattice.custom(1.0, MOS2_A1, MOS2_A2, MOS2_A3, MOS2_BASIS,
                          origin=origin)


def spatial_sort(pos: np.ndarray, types: np.ndarray, cell: float = 4.8):
    """Order atoms by (z, y, x) spatial cells (stable) — the analogue of
    LAMMPS `atom_modify sort`.  rebomos_bulk_commensurate(sort=True)
    applies it (the JAX package's LPT_SORT_SCENE=1)."""
    mn = pos.min(axis=0)
    c3 = ((pos - mn) / cell).astype(np.int64)
    dims = c3.max(axis=0) + 1
    key = (c3[:, 2] * dims[1] + c3[:, 1]) * dims[0] + c3[:, 0]
    order = np.argsort(key, kind="stable")
    return pos[order], types[order]


def alsi_sample(nc: int = 20, si_fraction: float = 0.0075,
                seed: int = 7683797, a: float = 4.045, dtype=torch.float32,
                device="cuda") -> State:
    """The USER-AEAM/sample.in scene: an nc^3-cell fcc Al box with a
    random Si substitution fraction (sample.in:8-19); nc=20 gives 32,000
    atoms.  The Si sites come from set_type_fraction's coordinate hash, in
    the scene's float type (statistically equivalent to LAMMPS `set
    type/fraction`)."""
    lat = Lattice.fcc(a)
    box = Box.orthogonal([a * nc] * 3, dtype=dtype, device=device)
    pos, types = create_atoms_box(lat, box, [1, 1, 1, 1])
    mass = np.array([0.0, 27.0, 28.0])     # AlSi.aeam per-element masses
    state = State.create(x=pos, type=types, box=box, mass=mass)
    return set_type_fraction(state, 2, si_fraction, seed)


def rebomos_bulk_commensurate(nx: int = 34, ny: int = 48, nz: int = 10,
                              dtype=torch.float32, device="cuda",
                              sort: bool = False) -> State:
    """Defect-free MoS2 bulk whose box vectors are integer combinations of
    the lattice vectors (A = nx a1, B = ny/2 a1 + ny a2, C = nz a3).
    Defaults give the 97,920-atom bench scene.  sort=True orders the atoms
    spatially (spatial_sort), which the combine="react" route tables
    need."""
    if ny % 2:
        raise ValueError("ny must be even (B = ny/2 a1 + ny a2)")
    a1, a2, a3 = (np.asarray(v) for v in (MOS2_A1, MOS2_A2, MOS2_A3))
    A = nx * a1
    B = (ny // 2) * a1 + ny * a2
    C = nz * a3
    box = Box.triclinic(lx=A[0], ly=B[1], lz=C[2], xy=B[0], xz=C[0],
                        yz=C[1], dtype=dtype, device=device)
    basis = np.asarray(MOS2_BASIS)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cells = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], 1).astype(float)
    frac = cells[:, None, :] + basis[None, :, :]
    pos = frac.reshape(-1, 3) @ np.stack([a1, a2, a3])
    types = np.tile(np.asarray(MOS2_BASIS_TYPES, np.int32), len(cells))
    h = box.h_np()
    f = pos @ np.linalg.inv(h)
    pos = (f - np.floor(f)) @ h
    if sort:
        pos, types = spatial_sort(pos, types)
    mass = np.array([0.0, *MOS2_MASSES])
    return State.create(x=pos, type=types, box=box, mass=mass)


def rebomos_monolayer(nx: int = 34, ny: int = 48, vacuum: float = 20.0,
                      sort: bool = False, dtype=torch.float32,
                      device="cuda") -> State:
    """One MoS2 layer in a vacuum slab; nx=577, ny=578 gives the 1,000,518
    atoms of the monolayer configuration.

    The in-plane tiling is rebomos_bulk_commensurate's (A = nx a1, B =
    ny/2 a1 + ny a2); the slab keeps one of the 2H cell's two layers (the
    z = 1/4 Mo plane with its two S planes) centred in `vacuum` of empty
    z.  The box stays z-periodic: the vacuum exceeds the interaction
    cutoff plus any reasonable skin, so the layer never sees its z-images.
    sort=True orders the atoms spatially (spatial_sort; the JAX package's
    LPT_SORT_SCENE=1)."""
    if ny % 2:
        raise ValueError("ny must be even (B = ny/2 a1 + ny a2)")
    a1 = np.asarray(MOS2_A1)
    a2 = np.asarray(MOS2_A2)
    c_bulk = MOS2_A3[2]
    basis = np.array([(0.0, 0.0, 0.25),                      # Mo
                      (1.0 / 3.0, 2.0 / 3.0, 0.137990996),   # S below
                      (1.0 / 3.0, 2.0 / 3.0, 0.362008989)])  # S above
    z = basis[:, 2] * c_bulk
    thick = z.max() - z.min()
    z = z - z.min() + 0.5 * vacuum
    A = nx * a1
    B = (ny // 2) * a1 + ny * a2
    box = Box.triclinic(lx=A[0], ly=B[1], lz=thick + vacuum, xy=B[0],
                        dtype=dtype, device=device)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    cells = np.stack([ii.ravel(), jj.ravel()], 1).astype(float)
    frac2 = cells[:, None, :] + basis[None, :, :2]
    xy = frac2.reshape(-1, 2) @ np.stack([a1[:2], a2[:2]])
    pos = np.concatenate([xy, np.tile(z, len(cells))[:, None]], axis=1)
    h = box.h_np()
    f = pos @ np.linalg.inv(h)
    pos = (f - np.floor(f)) @ h
    types = np.tile(np.asarray((1, 2, 2), np.int32), len(cells))
    if sort:
        pos, types = spatial_sort(pos, types)
    mass = np.array([0.0, *MOS2_MASSES])
    return State.create(x=pos, type=types, box=box, mass=mass)


@dataclasses.dataclass
class Deck:
    """A scene with the pair style, fixes, units and skin of its deck."""

    state: State
    pair: PairStyle
    fixes: List[Fix]
    units: units_mod.UnitSystem
    skin: float

    def engine(self, **kw):
        """An Engine over the deck (kw: dt, check_every)."""
        from ..run.simulation import Engine
        return Engine(self.state, self.pair, self.fixes, self.units,
                      skin=self.skin, **kw)


def _lattice_block(lat: Lattice, n: int, nbasis: int, masses,
                   dtype, device) -> State:
    """`region box block 0 n 0 n 0 n`, `create_box`, `create_atoms 1 box`
    and the masses, as the JAX Script runs them."""
    s = lat.spacings()
    hi = [n * float(s[d]) for d in range(3)]
    box = Box.triclinic(hi[0], hi[1], hi[2], lo=(0.0, 0.0, 0.0),
                        dtype=dtype, device=device)
    pos, types = create_atoms_box(lat, box, [1] * nbasis)
    return State.create(x=pos, type=types, box=box,
                        mass=np.array([0.0, *masses]))


def lj_melt(n: int = 20, dtype=torch.float32, device="cuda") -> Deck:
    """The LJ melt deck of tests/test_ljcut.py with `region box block 0 n
    0 n 0 n`; at n = 20 LAMMPS's bench/in.lj (32,000 atoms): lj units,
    `lattice fcc 0.8442` (a = (4 / 0.8442)^(1/3)), mass 1, `velocity all
    create 1.44 87287`, `pair_style lj/cut 2.5`, `pair_coeff 1 1 1.0 1.0
    2.5`, `neighbor 0.3`, `fix nve`."""
    u = units_mod.LJ
    lat = Lattice.fcc((4 / 0.8442) ** (1.0 / 3.0))
    st = _lattice_block(lat, n, 4, (1.0,), dtype, device)
    st = velocity_create(st, u, 1.44, 87287)
    pair = PairLJCut(2.5, ntypes=1, dtype=dtype, device=device)
    pair.set_coeff(1, 1, 1.0, 1.0, 2.5)
    return Deck(state=st, pair=pair, fixes=[FixNVE()], units=u, skin=0.3)


def charged_melt(n: int = 32, bz: float = 200.0, dtype=torch.float32,
                 device="cuda") -> Deck:
    """The charged LJ/Coulomb melt deck of tests/test_ljcut.py with `region
    box block 0 n 0 n 0 n`: metal units, `lattice bcc 4.2`, `set group all
    type/fraction 2 0.5 777` (the coordinate hash in the scene's float
    type), charges +1 (type 1) and -1 (type 2), masses 22.99 and 35.45,
    `velocity all create 300.0 4928459`, `pair_style lj/cut/coul/cut 6.0
    8.0` with `pair_coeff 1 1 0.01 2.5` and `2 2 0.01 3.4`, `neighbor 1.0`,
    `fix bfield 0 0 bz` then `fix nve`.  The deck's field is 200 T; n = 32
    gives 65,536 ions in a 134.4 A box."""
    u = units_mod.METAL
    st = _lattice_block(Lattice.bcc(4.2), n, 2, (22.99, 35.45), dtype,
                        device)
    st = set_type_fraction(st, 2, 0.5, 777)
    st = st.replace(q=torch.where(st.type == 1, 1.0, -1.0).to(dtype))
    st = velocity_create(st, u, 300.0, 4928459)
    pair = PairLJCutCoulCut(6.0, 8.0, ntypes=2, qqr2e=u.qqr2e, dtype=dtype,
                            device=device)
    pair.set_coeff(1, 1, 0.01, 2.5)
    pair.set_coeff(2, 2, 0.01, 3.4)
    return Deck(state=st, pair=pair, fixes=[FixBfield(0.0, 0.0, bz),
                                            FixNVE()], units=u, skin=1.0)


def rebomos_bulk(nx: int = 4, ny: int = 8, nz: int = 1,
                 tilt_xy: float = -2.0, dtype=torch.float32,
                 device="cuda") -> State:
    """The in.rebomos-bulk scene; defaults give the golden 288-atom cell."""
    lat = mos2_lattice()
    sx, sy, sz = lat.spacings()
    box = Box.triclinic(lx=nx * sx, ly=ny * sy, lz=nz * sz,
                        xy=tilt_xy * sx, dtype=dtype, device=device)
    pos, types = create_atoms_box(lat, box, MOS2_BASIS_TYPES)
    mass = np.array([0.0, *MOS2_MASSES])
    return State.create(x=pos, type=types, box=box, mass=mass)
