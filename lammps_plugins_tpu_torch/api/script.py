"""LAMMPS input-script interpreter (port of lammps_plugins_tpu/api/script.py).

Runs input decks as text, command for command as the JAX package's
interpreter: command dispatch, `&` line continuation, `#` comments, `$(...)`
immediate expressions, lattice/region/create_atoms geometry, pair and fix
set-up, per-atom computes, dumps, restarts, data files, FIRE minimization
and thermo-printing runs.  Each command translates to the port's scene
builders and its Engine, whose device loop runs the deck's steps as CUDA
graphs on the card.

Script(log=print, dtype=torch.float32, device="cuda") runs on the card
and raises without one; a CPU run passes device="cpu" (and
dtype=torch.float64 for the parity checks).  n_devices > 1 runs the deck
on the spatially sharded engine (parallel/sharded_engine.py, `mpirun -np
N`), one shard per entry of `devices` (e.g. ["cuda:0"] * 4 or ["cpu"] *
4, stacked on one device; ["cuda:0", "cuda:1", ...], each shard on its
own card; placement="per_device" places them per device on one device
too); as in the JAX package only the timestep and the skin reach it, so
`neigh_modify every` does not, and per-atom computes and minimize stay
single-device.  `plugin load` registers into the port's own registry
(lammps_plugins_tpu_torch/registry.py).

Differences of mechanism, not of result: a ramped fix (nvt, langevin) is
re-anchored at every `run` as in the JAX package, and the device loop
captures anew when the window changes (Fix.capture_key); compute
stress/atom computes the per-atom virial once per frame for its six
columns.

Usage:
    from lammps_plugins_tpu_torch.api.script import Script
    Script().run_file("in.rebomos-bulk")       # prints thermo like LAMMPS
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import units as units_mod
from ..core.box import Box
from ..core.device import resolve
from ..core.lattice import Lattice, create_atoms_box
from ..core.region import Block, Prism, Region, Sphere, BIG
from ..core.state import State
from ..fixes.base import Fix
from ..fixes.bfield import FixBfield
from ..fixes.langevin import FixLangevin
from ..fixes.nve import FixNVE
from ..fixes.nvt import FixNVT
from ..fixes.velocity import set_type_fraction, velocity_create
from ..potentials.aeam import AEAM
from ..potentials.rebomos import REBOMoS
from ..potentials import ljcut as _ljcut   # noqa: F401  (registers lj/cut*)
from ..potentials import none as _none     # noqa: F401  (registers none/zero)
from ..parallel.sharded_engine import ShardedEngine
from ..run.dump import DumpWriter
from ..run.simulation import Engine

_NOOP_COMMANDS = {"dump_modify", "log", "echo",
                  "atom_modify", "processors", "suffix", "package",
                  "info", "write_data", "undump"}


class ScriptError(ValueError):
    pass


class Script:
    """Stateful command interpreter (one LAMMPS 'input deck')."""

    def __init__(self, log: Callable[[str], None] = print,
                 dtype=torch.float32, device="cuda", n_devices: int = 1,
                 devices=None, placement: str | None = None):
        """The deck runs on `device` in `dtype` (the card and float32
        unless the caller asks otherwise).  n_devices > 1 runs it on the
        sharded engine with one shard per entry of `devices`, which the
        caller names (["cuda:0"] * 4 stacks the shards on one card,
        ["cuda:0", "cuda:1", "cuda:2", "cuda:3"] puts each on its own);
        placement is the engine's (ShardedEngine)."""
        if n_devices > 1 and (devices is None or len(devices) != n_devices):
            raise ScriptError(
                f"n_devices={n_devices} needs devices, one per shard "
                f"(devices=['cuda:0'] * {n_devices} on one card); got "
                f"{devices}")
        self.dtype = dtype
        self.device = resolve(device)
        self.log = log
        self.n_devices = n_devices
        self.devices = devices
        self.placement = placement
        self.units = units_mod.METAL
        self.atom_style = "atomic"
        self.dimension = 3
        self.boundary = (True, True, True)
        self.lattice: Optional[Lattice] = None
        self.regions: Dict[str, Region] = {}
        self.region_cmds: Dict[str, tuple] = {}
        self.box: Optional[Box] = None
        self.ntypes = 0
        self.positions: Optional[np.ndarray] = None
        self.types: Optional[np.ndarray] = None
        self.masses: Dict[int, float] = {}
        self.pair_style_name: Optional[str] = None
        self.pair = None
        self.fixes: List[Fix] = []
        self.variables: Dict[str, str] = {}
        self.dt: Optional[float] = None
        self.skin: Optional[float] = None
        self.thermo_every = 0
        self.thermo_cols = ["step", "temp", "epair", "emol", "etotal",
                            "press"]
        self.check_every = 10
        self.engine: Optional[Engine] = None
        self._velocity_cmds: List[tuple] = []

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def run_file(self, path: str):
        with open(path) as fh:
            self.run_text(fh.read())

    def run_text(self, text: str):
        logical = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if line.endswith("&"):
                logical += line[:-1] + " "
                continue
            logical += line
            if logical.strip():
                self.command(logical.strip())
            logical = ""
        if logical.strip():
            self.command(logical.strip())

    def command(self, line: str):
        line = self._substitute(line)
        toks = line.split()
        cmd, args = toks[0], toks[1:]
        handler = getattr(self, f"cmd_{cmd}", None)
        if handler is None:
            if cmd in _NOOP_COMMANDS:
                warnings.warn(f"Ignoring unsupported command: {cmd}")
                return
            raise ScriptError(f"Unknown command: {cmd}")
        handler(args)

    def _substitute(self, line: str) -> str:
        """$(expr) immediate math + ${var} / $x substitution."""
        out = []
        i = 0
        while i < len(line):
            if line[i] == "$" and i + 1 < len(line):
                nxt = line[i + 1]
                if nxt == "(":
                    depth, j = 1, i + 2
                    while j < len(line) and depth:
                        depth += {"(": 1, ")": -1}.get(line[j], 0)
                        j += 1
                    expr = line[i + 2:j - 1]
                    out.append(repr(self._eval(expr)))
                    i = j
                    continue
                if nxt == "{":
                    j = line.index("}", i)
                    out.append(self.variables[line[i + 2:j]])
                    i = j + 1
                    continue
                out.append(self.variables[nxt])
                i += 2
                continue
            out.append(line[i])
            i += 1
        return "".join(out)

    def _eval(self, expr: str) -> float:
        allowed = {"sqrt": math.sqrt, "exp": math.exp, "log": math.log,
                   "sin": math.sin, "cos": math.cos, "tan": math.tan,
                   "abs": abs, "floor": math.floor, "ceil": math.ceil,
                   "PI": math.pi}
        return float(eval(expr, {"__builtins__": {}}, allowed))  # noqa: S307

    # ------------------------------------------------------------------
    # setup commands
    # ------------------------------------------------------------------
    def cmd_units(self, args):
        self.units = units_mod.get(args[0])

    def cmd_atom_style(self, args):
        if args[0] not in ("atomic", "charge", "full"):
            raise ScriptError(f"Unsupported atom_style {args[0]}")
        self.atom_style = args[0]

    def cmd_dimension(self, args):
        if int(args[0]) != 3:
            raise ScriptError("Only 3d supported")

    def cmd_boundary(self, args):
        self.boundary = tuple(a.startswith("p") for a in args[:3])

    def cmd_variable(self, args):
        name, style = args[0], args[1]
        if style not in ("equal", "string", "index"):
            raise ScriptError(f"Unsupported variable style {style}")
        self.variables[name] = " ".join(args[2:])

    def cmd_lattice(self, args):
        style = args[0]
        if style == "custom":
            scale = float(args[1])
            vecs = {"a1": (1.0, 0.0, 0.0), "a2": (0.0, 1.0, 0.0),
                    "a3": (0.0, 0.0, 1.0)}
            basis, origin = [], (0.0, 0.0, 0.0)
            i = 2
            while i < len(args):
                key = args[i]
                if key in ("a1", "a2", "a3"):
                    vecs[key] = tuple(float(v) for v in args[i + 1:i + 4])
                    i += 4
                elif key == "basis":
                    basis.append(tuple(float(v) for v in args[i + 1:i + 4]))
                    i += 4
                elif key == "origin":
                    origin = tuple(float(v) for v in args[i + 1:i + 4])
                    i += 4
                else:
                    raise ScriptError(f"lattice custom keyword {key}")
            if not basis:
                basis = [(0.0, 0.0, 0.0)]
            self.lattice = Lattice.custom(scale, vecs["a1"], vecs["a2"],
                                          vecs["a3"], basis, origin)
        elif style in ("fcc", "bcc", "sc"):
            a = float(args[1])
            if self.units.name == "lj":
                # LAMMPS lattice.cpp: in lj units the scale argument is the
                # reduced density rho*; a = (basis_count / rho)^(1/3)
                nbasis = {"fcc": 4, "bcc": 2, "sc": 1}[style]
                a = (nbasis / a) ** (1.0 / 3.0)
            origin = (0.0, 0.0, 0.0)
            if "origin" in args:
                k = args.index("origin")
                origin = tuple(float(v) for v in args[k + 1:k + 4])
            self.lattice = getattr(Lattice, style)(a, origin=origin)
        elif style == "none":
            self.lattice = None
        else:
            raise ScriptError(f"Unsupported lattice style {style}")

    def _spacings(self) -> np.ndarray:
        if self.lattice is None:
            return np.ones(3)
        return self.lattice.spacings()

    def cmd_region(self, args):
        rid, style = args[0], args[1]
        s = self._spacings()
        if style == "block":
            lo, hi = [], []
            for d in range(3):
                a, b = args[2 + 2 * d], args[3 + 2 * d]
                lo.append(-BIG if a in ("INF", "EDGE") else float(a) * s[d])
                hi.append(BIG if b in ("INF", "EDGE") else float(b) * s[d])
            self.regions[rid] = Block(name=rid, lo=tuple(lo), hi=tuple(hi))
            self.region_cmds[rid] = ("block", tuple(lo), tuple(hi))
        elif style == "prism":
            xlo, xhi, ylo, yhi, zlo, zhi = (float(v) for v in args[2:8])
            xy, xz, yz = (float(v) for v in args[8:11])
            lo = (xlo * s[0], ylo * s[1], zlo * s[2])
            hi = (xhi * s[0], yhi * s[1], zhi * s[2])
            tilt = (xy * s[0], xz * s[0], yz * s[1])
            self.regions[rid] = Prism(name=rid, lo=lo, hi=hi, tilt=tilt)
            self.region_cmds[rid] = ("prism", lo, hi, tilt)
        elif style == "sphere":
            c = tuple(float(v) * s[d] for d, v in enumerate(args[2:5]))
            rad = float(args[5]) * s[0]
            self.regions[rid] = Sphere(name=rid, center=c, radius=rad)
            self.region_cmds[rid] = ("sphere", c, rad)
        else:
            raise ScriptError(f"Unsupported region style {style}")

    def cmd_create_box(self, args):
        self.ntypes = int(args[0])
        rid = args[1]
        kind = self.region_cmds[rid]
        if kind[0] == "block":
            _, lo, hi = kind
            self.box = Box.triclinic(hi[0] - lo[0], hi[1] - lo[1],
                                     hi[2] - lo[2], lo=lo,
                                     periodic=self.boundary,
                                     dtype=self.dtype, device=self.device)
        elif kind[0] == "prism":
            _, lo, hi, tilt = kind
            self.box = Box.triclinic(hi[0] - lo[0], hi[1] - lo[1],
                                     hi[2] - lo[2], xy=tilt[0], xz=tilt[1],
                                     yz=tilt[2], lo=lo,
                                     periodic=self.boundary,
                                     dtype=self.dtype, device=self.device)
        else:
            raise ScriptError("create_box needs a block or prism region")
        h = self.box.h_np()
        self.log(f"Created {'triclinic' if kind[0] == 'prism' else 'orthogonal'}"
                 f" box = ({lo[0]:g} {lo[1]:g} {lo[2]:g}) to"
                 f" ({hi[0]:g} {hi[1]:g} {hi[2]:g})")

    def cmd_create_atoms(self, args):
        type0 = int(args[0])
        mode = args[1]
        if mode == "single":
            # create_atoms <type> single x y z [units box|lattice]
            # LAMMPS default is LATTICE units, scaled per-axis by the
            # xlattice/ylattice/zlattice spacings (create_atoms doc)
            xyz = [float(v) for v in args[2:5]]
            units = "lattice"
            if "units" in args:
                units = args[args.index("units") + 1]
            if units == "lattice":
                if self.lattice is None:
                    raise ScriptError(
                        "Use of create_atoms with undefined lattice")
                sp = self.lattice.spacings()
                xyz = [c * sp[i] for i, c in enumerate(xyz)]
            elif units != "box":
                raise ScriptError(f"create_atoms units {units!r}")
            pos = np.asarray([xyz], dtype=np.float64)
            types = np.asarray([type0], dtype=np.int32)
            if self.positions is None:
                self.positions, self.types = pos, types
            else:
                self.positions = np.concatenate([self.positions, pos])
                self.types = np.concatenate([self.types, types])
            self.log("Created 1 atoms")
            self.engine = None
            return
        if self.lattice is None:
            raise ScriptError("create_atoms requires a lattice")
        basis_types = [type0] * len(self.lattice.basis)
        i = 2
        region_filter = None
        if mode == "region":
            region_filter = self.regions[args[2]]
            i = 3
        while i < len(args):
            if args[i] == "basis":
                basis_types[int(args[i + 1]) - 1] = int(args[i + 2])
                i += 3
            else:
                raise ScriptError(f"create_atoms keyword {args[i]}")
        pos, types = create_atoms_box(self.lattice, self.box, basis_types)
        if region_filter is not None:
            keep = region_filter.inside(torch.as_tensor(pos)).numpy()
            pos, types = pos[keep], types[keep]
        if self.positions is None:
            self.positions, self.types = pos, types
        else:
            self.positions = np.concatenate([self.positions, pos])
            self.types = np.concatenate([self.types, types])
        self.log(f"Created {len(pos)} atoms")
        self.engine = None

    def cmd_mass(self, args):
        self.masses[int(args[0])] = float(args[1])

    def cmd_group(self, args):
        """group ID style args: region <rid> | type <t...> | id <ranges>."""
        gid, style = args[0], args[1]
        if self.types is None:
            raise ScriptError("group before create_atoms")
        n = len(self.types)
        if style == "region":
            reg = self.regions[args[2]]
            mask = reg.inside(torch.as_tensor(self.positions)).numpy()
        elif style == "type":
            wanted = {int(a) for a in args[2:]}
            mask = np.isin(np.asarray(self.types), list(wanted))
        elif style == "id":
            mask = np.zeros(n, bool)
            for spec in args[2:]:
                if ":" in spec:
                    a, b = spec.split(":")
                    mask[int(a) - 1:int(b)] = True
                else:
                    mask[int(spec) - 1] = True
        else:
            raise ScriptError(f"Unsupported group style {style}")
        if not hasattr(self, "groups"):
            self.groups = {}
        self.groups[gid] = mask
        self.log(f"{int(mask.sum())} atoms in group {gid}")

    def _group_mask(self, gid: str):
        if gid == "all":
            return None
        groups = getattr(self, "groups", {})
        if gid not in groups:
            raise ScriptError(f"Unknown group {gid}")
        return groups[gid]

    def cmd_pair_style(self, args):
        from .. import registry
        if args[0] not in registry.PAIR_STYLES:
            raise ScriptError(f"Unsupported pair style {args[0]}")
        self.pair_style_name = args[0]
        self.pair_style_args = list(args[1:])
        if args[0] in ("lj/cut", "lj/cut/coul/cut"):
            self.pair = None        # built at first pair_coeff (needs ntypes)
            self.engine = None
        elif args[0] in ("none", "zero"):
            # pure-fix dynamics (e.g. the fix bfield cyclotron scene,
            # BASELINE.json config 2): no pair_coeff required
            from ..potentials.none import PairNone
            cut = float(args[1]) if len(args) > 1 else 1.0
            self.pair = PairNone(cut)
            self.engine = None

    def cmd_pair_coeff(self, args):
        if self.pair_style_name in ("none", "zero"):
            return      # pair_coeff * * accepted, no coefficients to set
        if self.pair_style_name in ("lj/cut", "lj/cut/coul/cut"):
            return self._ljcut_coeff(args)
        if args[0] != "*" or args[1] != "*":
            raise ScriptError("pair_coeff must be '* *' for these styles")
        path, elems = args[2], args[3:]
        kw = dict(dtype=self.dtype, device=self.device)
        if self.pair_style_name == "rebomos":
            self.pair = REBOMoS.from_file(path, elems, **kw)
        elif self.pair_style_name == "aeam":
            self.pair = AEAM.from_file(path, elems, **kw)
            for t, m in enumerate(self.pair.masses[1:], start=1):
                if m > 0:
                    self.masses.setdefault(t, float(m))
        else:
            raise ScriptError("pair_coeff before pair_style")
        self.engine = None

    def _ljcut_coeff(self, args):
        """pair_coeff i j eps sigma [cut] for the numeric-coefficient
        styles (i/j accept '*' wildcards, LAMMPS pair_lj_cut.cpp:coeff)."""
        from ..potentials.ljcut import PairLJCut, PairLJCutCoulCut
        if not self.ntypes:
            raise ScriptError("pair_coeff before create_box")
        if self.pair is None:
            a = [float(v) for v in self.pair_style_args]
            if not a:
                raise ScriptError(
                    f"pair_style {self.pair_style_name} needs a cutoff")
            if self.pair_style_name == "lj/cut":
                self.pair = PairLJCut(a[0], ntypes=self.ntypes,
                                      dtype=self.dtype, device=self.device)
            else:
                self.pair = PairLJCutCoulCut(
                    a[0], a[1] if len(a) > 1 else None,
                    ntypes=self.ntypes, qqr2e=self.units.qqr2e,
                    dtype=self.dtype, device=self.device)

        def trange(tok):
            if tok == "*":
                return range(1, self.ntypes + 1)
            return [int(tok)]

        vals = [float(v) for v in args[2:]]
        if len(vals) not in (2, 3):
            raise ScriptError("pair_coeff i j eps sigma [cut]")
        for i in trange(args[0]):
            for j in trange(args[1]):
                self.pair.set_coeff(i, j, *vals)
        self.engine = None

    def cmd_neighbor(self, args):
        self.skin = float(args[0])

    def cmd_neigh_modify(self, args):
        """`every N` sets how many steps pass between displacement checks
        (the Engine's check_every, 10 by default); delay/check are
        subsumed by the exact half-skin rule (run/simulation.py).  The
        JAX interpreter ignores the command: only the rebuild timing
        moves, not the physics."""
        if "every" in args:
            self.check_every = int(args[args.index("every") + 1])
            self.engine = None

    def cmd_set(self, args):
        if len(args) >= 4 and args[2] == "charge" \
                and args[0] in ("type", "group"):
            # set type I charge Q / set group G charge Q — static per-atom
            # charges (atom_style charge; consumed by fix bfield and the
            # coulomb pair styles)
            if not hasattr(self, "_charge_cmds"):
                self._charge_cmds = []
            self._charge_cmds.append((args[0], args[1], float(args[3])))
            self.engine = None
            return
        if args[0] == "region" and args[2] == "type/fraction":
            region = self.regions[args[1]]
            newtype, frac, seed = int(args[3]), float(args[4]), int(args[5])
        elif args[0] == "group" and args[1] == "all" \
                and args[2] == "type/fraction":
            region, newtype, frac, seed = None, int(args[3]), \
                float(args[4]), int(args[5])
        else:
            raise ScriptError(f"Unsupported set command: {' '.join(args)}")
        st = self._state()
        st = set_type_fraction(st, newtype, frac, seed, region=region)
        self.types = st.type.cpu().numpy()
        if getattr(self, "_restart_state", None) is not None:
            self._restart_state = st
        self.engine = None

    def cmd_replicate(self, args):
        """replicate nx ny nz — tile the system along the box vectors."""
        nx, ny, nz = (int(a) for a in args[:3])
        if self.positions is None:
            raise ScriptError("replicate before create_atoms")
        h = self.box.h_np()
        lo = self.box.lo_np()
        reps = []
        treps = []
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    shift = i * h[0] + j * h[1] + k * h[2]
                    reps.append(self.positions + shift)
                    treps.append(self.types)
        self.positions = np.concatenate(reps)
        self.types = np.concatenate(treps)
        self.box = Box.triclinic(
            nx * h[0, 0], ny * h[1, 1], nz * h[2, 2],
            xy=ny * h[1, 0], xz=nz * h[2, 0], yz=nz * h[2, 1],
            lo=lo, periodic=self.boundary, dtype=self.dtype,
            device=self.device)
        self.engine = None
        self.log(f"Replicated system: {len(self.positions)} atoms")

    def cmd_timestep(self, args):
        self.dt = float(args[0])
        self.engine = None

    def cmd_velocity(self, args):
        """velocity <group> create T seed [dist u|g] [mom y|n] [rot y|n]
        [units box] [loop geom] — LAMMPS Velocity::create keywords.
        Also: velocity <group> set vx vy vz [units box]."""
        if args[1] == "set":
            vals = [float(v) for v in args[2:5]]
            rest = list(args[5:])
            while rest:
                key = rest.pop(0)
                if key == "units" and rest and rest[0] == "box":
                    rest.pop(0)
                else:
                    raise ScriptError(
                        f"velocity set keyword {key!r} not supported "
                        f"(only 'units box')")
            self._velocity_cmds.append((args[0], "set", vals, {}))
            self.engine = None
            return
        if args[1] != "create":
            raise ScriptError(
                f"velocity style {args[1]!r} not supported "
                f"(only create/set)")
        group = args[0]
        kw = {"dist": "uniform", "zero_momentum": True,
              "zero_rotation": False}
        rest = list(args[4:])
        while rest:
            key = rest.pop(0)
            if key == "dist":
                val = rest.pop(0)
                kw["dist"] = {"uniform": "uniform",
                              "gaussian": "gaussian"}[val]
            elif key == "mom":
                kw["zero_momentum"] = rest.pop(0) == "yes"
            elif key == "rot":
                kw["zero_rotation"] = rest.pop(0) == "yes"
            elif key in ("units", "loop", "sum"):
                rest.pop(0)    # box/lattice, all/geom, yes/no: no-ops here
            else:
                raise ScriptError(f"Unknown velocity keyword {key!r}")
        self._velocity_cmds.append((group, float(args[2]), int(args[3]), kw))
        self.engine = None

    def cmd_fix(self, args):
        fid, group, style = args[0], args[1], args[2]
        rest = args[3:]
        gmask = self._group_mask(group)
        if style == "nve":
            self._add_fix(fid, FixNVE(group_mask=gmask))
        elif style == "nvt":
            if rest[0] != "temp":
                raise ScriptError("fix nvt requires `temp Tstart Tstop Tdamp`")
            self._add_fix(fid, FixNVT(float(rest[1]), float(rest[2]),
                                      float(rest[3]), fix_id=fid,
                                      group_mask=gmask))
        elif style == "langevin":
            if len(rest) > 4:
                # LAMMPS keywords (zero, tally, gjf, angmom, scale, ...)
                # change the physics; silently dropping them would run a
                # different simulation than the deck requests
                raise ScriptError(
                    f"Unsupported fix langevin keywords: {rest[4:]}")
            self._add_fix(fid, FixLangevin(float(rest[0]), float(rest[1]),
                                           float(rest[2]), int(rest[3]),
                                           group_mask=gmask, fix_id=fid))
        elif style == "bfield":
            # equal-style components compile to closures of the 0-d time
            # tensor (fix_bfield.cpp:62-81,513-519: Variable::compute_equal
            # every step), which the captured step evaluates on the card
            from .equalvar import compile_equal
            b = []
            for comp in rest[:3]:
                if comp.startswith("v_"):
                    name = comp[2:]
                    if name not in self.variables:
                        raise ScriptError(f"Undefined variable v_{name}")
                    fn = compile_equal(self.variables[name],
                                       self.variables)
                    bad = fn.keywords - {"time"}
                    if bad:
                        # the fix evaluates B inside the captured step,
                        # where only `time` is available
                        raise ScriptError(
                            f"fix bfield variable v_{name} uses thermo "
                            f"keyword(s) {sorted(bad)}; only `time` is "
                            f"available in a bfield variable")
                    # a time-free variable is a constant component
                    b.append(fn if fn.keywords else float(fn(0.0)))
                else:
                    b.append(float(comp))
            region = None
            if len(rest) > 3 and rest[3] == "region":
                region = self.regions[rest[4]]
            self._add_fix(fid, FixBfield(b[0], b[1], b[2], region=region,
                                         group_mask=gmask, fix_id=fid))
        else:
            raise ScriptError(f"Unsupported fix style {style}")
        self.engine = None

    def _add_fix(self, fid: str, fix):
        """Register a fix under its script ID (replacing an existing ID,
        like LAMMPS Modify::add_fix replace semantics)."""
        if not hasattr(self, "_fix_ids"):
            self._fix_ids = []
        if fid in self._fix_ids:
            i = self._fix_ids.index(fid)
            self.fixes[i] = fix
        else:
            self._fix_ids.append(fid)
            self.fixes.append(fix)

    def cmd_plugin(self, args):
        """plugin load <file.py|module> | list | clear.

        The runtime-registration analogue of the reference's
        `plugin load <lib.so>` (aeamplugin.cpp:14-28 lammpsplugin_init):
        importing the module runs its @register_pair_style /
        @register_fix_style decorators of the port's registry
        (lammps_plugins_tpu_torch.registry), after which the new styles
        are listed and known to pair_style."""
        from .. import registry
        sub = args[0]
        if sub == "list":
            self.log(f"pair styles: {sorted(registry.PAIR_STYLES)}")
            self.log(f"fix styles: {sorted(registry.FIX_STYLES)}")
            return
        if sub == "clear":
            # LAMMPS `plugin clear` unloads all plugins; builtin styles
            # (this package's own modules) stay registered
            return
        if sub != "load":
            raise ScriptError(f"Unknown plugin subcommand {sub}")
        import importlib
        import importlib.util
        import os
        target = args[1]
        before = (set(registry.PAIR_STYLES), set(registry.FIX_STYLES))
        if target.endswith(".py") or os.path.sep in target:
            name = os.path.splitext(os.path.basename(target))[0]
            spec = importlib.util.spec_from_file_location(name, target)
            if spec is None:
                raise ScriptError(f"Cannot load plugin {target}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        else:
            importlib.import_module(target)
        new_pair = set(registry.PAIR_STYLES) - before[0]
        new_fix = set(registry.FIX_STYLES) - before[1]
        self.log(f"Loaded plugin {target}: pair styles {sorted(new_pair)}, "
                 f"fix styles {sorted(new_fix)}")

    def cmd_unfix(self, args):
        """unfix <ID> — remove a previously defined fix."""
        fid = args[0]
        ids = getattr(self, "_fix_ids", [])
        if fid not in ids:
            raise ScriptError(f"Unknown fix ID {fid} in unfix")
        i = ids.index(fid)
        del self._fix_ids[i]
        del self.fixes[i]
        self.engine = None

    def _single_engine(self, style: str) -> Engine:
        """The Engine whose lists a per-atom compute reads; the sharded
        engine's lists are per shard, so a sharded deck refuses (the JAX
        Script cannot run them either)."""
        if isinstance(self.engine, ShardedEngine):
            raise ScriptError(f"compute {style} is single-device: the "
                              "sharded engine's lists are per shard")
        return self.engine

    def cmd_compute(self, args):
        """compute ID group style — pe/atom and ke/atom supported."""
        cid, group, style = args[0], args[1], args[2]
        gmask = self._group_mask(group)     # None for "all"
        if style == "pe/atom":
            def raw(state):
                eng = self._single_engine("pe/atom")
                return eng.pair.energy_peratom(state.x, state.type, eng.nbr,
                                               state.box.h)
        elif style == "ke/atom":
            def raw(state):
                m = state.per_atom_mass
                return 0.5 * self.units.mvv2e * m \
                    * torch.sum(state.v ** 2, dim=1)
        elif style == "stress/atom":
            # compute ID group stress/atom NULL — per-atom stress tensor
            # in pressure*volume units (LAMMPS ComputeStressAtom):
            # S_i = -(m v⊗v + vatom_i) * nktv2p, six components
            # xx yy zz xy xz yz accessed as c_ID[1..6].  vatom comes from
            # the pair style's edge-cotangent per-atom virial
            # (potentials/base.py edge_virial_peratom; the v_tally family,
            # pair_rebomos.cpp:710,725, pair_aeam.cpp:472).  Only the
            # kinetic + pair virial terms exist here (no bond/angle/
            # kspace styles in this framework); the optional temp-ID
            # argument must be NULL.  The six columns of a frame share one
            # evaluation of the per-atom virial (cached on the frame's
            # State object).
            if len(args) > 3 and args[3] not in ("NULL",):
                raise ScriptError(
                    "compute stress/atom: only `NULL` temp-ID supported")
            cache = {"state": None, "value": None}

            def raw6(state):
                if cache["state"] is state:
                    return cache["value"]
                eng = self._single_engine("stress/atom")
                vat = eng.pair.virial_peratom(state.x, state.type,
                                              eng.nbr, state.box.h)
                m = state.per_atom_mass
                v = state.v
                kin = self.units.mvv2e * torch.stack(
                    [m * v[:, 0] * v[:, 0], m * v[:, 1] * v[:, 1],
                     m * v[:, 2] * v[:, 2], m * v[:, 0] * v[:, 1],
                     m * v[:, 0] * v[:, 2], m * v[:, 1] * v[:, 2]],
                    dim=1)
                out = -(kin + vat) * self.units.nktv2p
                if gmask is not None:
                    out = torch.where(self._group_tensor(gmask, out)[:, None],
                                      out, 0.0)
                cache.update(state=state, value=out)
                return out

            if not hasattr(self, "computes"):
                self.computes = {}

            for k in range(1, 7):
                def comp_k(state, _k=k):
                    return raw6(state)[:, _k - 1]
                self.computes[f"c_{cid}[{k}]"] = comp_k
            return
        elif style == "msd":
            # compute msd — global 4-vector (dx2, dy2, dz2, total), averaged
            # over the group, from UNWRAPPED displacements since the compute
            # was defined (LAMMPS ComputeMSD reference-at-creation
            # semantics, image-flag unmapped)
            ref = {"x0": None}

            def vec(state, _g=gmask, _ref=ref):
                h = state.box.h_np()
                xu = (state.x.detach().cpu().double().numpy()
                      + state.image.cpu().numpy() @ h)
                if _ref["x0"] is None:
                    _ref["x0"] = xu
                d = xu - _ref["x0"]
                if _g is not None:
                    d = d[np.asarray(_g)]
                n = max(1, d.shape[0])
                comp = (d * d).sum(axis=0) / n
                return np.array([comp[0], comp[1], comp[2], comp.sum()])

            if not hasattr(self, "vector_computes"):
                self.vector_computes = {}
            self.vector_computes[f"c_{cid}"] = vec
            return
        else:
            raise ScriptError(f"Unsupported compute style {style}")

        def provider(state, _raw=raw, _g=gmask):
            out = _raw(state)
            if _g is not None:
                out = torch.where(self._group_tensor(_g, out), out, 0.0)
            return out

        if not hasattr(self, "computes"):
            self.computes = {}
        self.computes[f"c_{cid}"] = provider

    @staticmethod
    def _group_tensor(gmask, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(gmask, bool), device=like.device)

    def cmd_dump(self, args):
        """dump ID group-ID style N file [cols...] (atom / custom)."""
        did, group, style, every, path = args[0], args[1], args[2], \
            int(args[3]), args[4]
        gmask = self._group_mask(group)
        if gmask is not None:
            gmask = np.asarray(gmask, bool)
        providers = getattr(self, "computes", {})
        if style == "atom":
            writer = DumpWriter(path, group_mask=gmask)
        elif style == "custom":
            writer = DumpWriter(path, columns=args[5:], providers=providers,
                                group_mask=gmask)
        else:
            raise ScriptError(f"Unsupported dump style {style}")
        if not hasattr(self, "dumps"):
            self.dumps = []
        self.dumps.append((every, writer))

    def cmd_restart(self, args):
        """restart N file — periodic restart files during the run
        (sample.in:23).  LAMMPS filename semantics: a '*' in the name is
        replaced by the timestep; two filenames alternate; a bare name
        gets '.<step>' appended."""
        from ..run.checkpoint import save_state
        every = int(args[0])
        self.dumps = [d for d in getattr(self, "dumps", [])
                      if getattr(d[1], "_is_restart", False) is False]
        if every == 0:
            return
        if len(args) not in (2, 3):
            raise ScriptError("restart N file [file2]")
        names = args[1:]
        counter = {"n": 0}

        def writer(state):
            step = int(state.step)
            if step == 0 or step == counter.get("last"):
                return                     # no file at step 0 (LAMMPS)
            counter["last"] = step
            if len(names) == 2:
                name = names[counter["n"] % 2]
                counter["n"] += 1
            else:
                name = names[0]
            name = (name.replace("*", str(step)) if "*" in name
                    else (name if len(names) == 2 else f"{name}.{step}"))
            save_state(name, state)

        writer._is_restart = True
        self.dumps.append((every, writer))

    def cmd_thermo(self, args):
        self.thermo_every = int(args[0])

    def cmd_thermo_style(self, args):
        if args[0] != "custom":
            raise ScriptError("Only thermo_style custom supported")
        self.thermo_cols = args[1:]

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------
    def _state(self) -> State:
        if getattr(self, "_restart_state", None) is not None:
            st = self._restart_state
            mass = st.mass.cpu().double().numpy().copy()
            for t, m in self.masses.items():
                mass[t] = m
            return st.replace(mass=torch.as_tensor(mass, dtype=self.dtype,
                                                   device=self.device))
        if self.positions is None:
            raise ScriptError("No atoms created")
        mass = np.zeros(self.ntypes + 1)
        for t, m in self.masses.items():
            mass[t] = m
        st = State.create(x=self.positions, type=self.types, box=self.box,
                          mass=mass, dtype=self.dtype, device=self.device)
        for sel, ident, val in getattr(self, "_charge_cmds", []):
            q = st.q.cpu().double().numpy().copy()
            if sel == "type":
                q[st.type.cpu().numpy() == int(ident)] = val
            else:                                   # group
                gmask = self._group_mask(ident)
                q[... if gmask is None else np.asarray(gmask)] = val
            st = st.replace(q=torch.as_tensor(q, dtype=self.dtype,
                                              device=self.device))
        return st

    def _make_engine(self) -> Engine:
        if self.pair is None:
            raise ScriptError("No pair style defined")
        state = self._state()
        for group, t_target, seed, kw in self._velocity_cmds:
            gmask = self._group_mask(group)
            if t_target == "set":
                v = state.v.cpu().double().numpy().copy()
                rows = (slice(None) if gmask is None
                        else np.asarray(gmask, bool))
                v[rows] = np.asarray(seed, v.dtype)     # seed = [vx,vy,vz]
                state = state.replace(v=torch.as_tensor(
                    v, dtype=state.x.dtype, device=state.x.device))
                continue
            state = velocity_create(state, self.units, t_target, seed,
                                    group_mask=gmask, **kw)
        # ordering check: fix bfield must precede the time integrator and
        # the integrator must be NVE-style (fix_bfield.cpp:206-219)
        if any(isinstance(f, FixBfield) for f in self.fixes):
            seen_bfield = False
            for f in self.fixes:
                if isinstance(f, FixBfield):
                    seen_bfield = True
                if getattr(f, "time_integrate", False):
                    if not seen_bfield:
                        raise ScriptError(
                            "fix bfield must be defined before NVE style "
                            "time integrator")
                    if isinstance(f, FixNVT):
                        raise ScriptError("fix bfield requires an NVE "
                                          "style integrator")
        if self.n_devices > 1:
            # as the JAX Script (script.py:876-880): dt and skin only
            return ShardedEngine(state, self.pair, self.fixes, self.units,
                                 devices=self.devices, dt=self.dt,
                                 skin=self.skin, placement=self.placement)
        return Engine(state, self.pair, self.fixes, self.units,
                      dt=self.dt, skin=self.skin,
                      check_every=self.check_every)

    _COLMAP = {"step": "step", "temp": "temp", "press": "press",
               "pe": "pe", "poteng": "pe", "ke": "ke", "kineng": "ke",
               "etotal": "etotal", "vol": "vol", "cellgamma": "cellgamma",
               "cellalpha": "cellalpha", "cellbeta": "cellbeta",
               "epair": "pe", "emol": None, "lx": "lx", "ly": "ly",
               "lz": "lz", "pxx": "pxx", "pyy": "pyy", "pzz": "pzz",
               "pxy": "pxy", "pxz": "pxz", "pyz": "pyz"}

    def cmd_min_style(self, args):
        """min_style fire — FIRE is the one minimizer (its iteration is a
        damped MD step; see run/minimize.py)."""
        if args[0] not in ("fire", "fire/old", "quickmin"):
            raise ScriptError(
                f"min_style {args[0]!r} not supported (only fire; its "
                f"damped-MD iteration is the jit/scan-shaped minimizer)")

    def cmd_min_modify(self, args):
        pass                                    # FIRE defaults only

    def cmd_minimize(self, args):
        """minimize etol ftol maxiter maxeval (maxeval folded into
        maxiter: FIRE costs exactly one force evaluation per iteration)."""
        from ..run.minimize import minimize as _minimize
        etol, ftol = float(args[0]), float(args[1])
        maxiter = int(args[2])
        if len(args) > 3:
            maxiter = min(maxiter, int(args[3]))
        if self.engine is None:
            self.engine = self._make_engine()
        if isinstance(self.engine, ShardedEngine):
            raise ScriptError("minimize is single-device (run it before "
                              "sharded dynamics, like LAMMPS minimizes "
                              "before production runs)")
        res = _minimize(self.engine, etol=etol, ftol=ftol, maxiter=maxiter)
        self.log(repr(res))
        self.last_min = res
        return res

    def cmd_run(self, args):
        n = int(args[0])
        if self.engine is None:
            self.engine = self._make_engine()
        eng = self.engine

        # T-ramp window: LAMMPS ramps Tstart->Tstop over EACH run command
        # (fix_nh.cpp compute_temp_target uses update->beginstep/endstep).
        # The window is a constant of the captured step; it is in the
        # fixes' capture_key, so the device loop captures anew when it
        # changes.
        ramped = [fx for fx in self.fixes
                  if hasattr(fx, "begin_step") and hasattr(fx, "t_stop")
                  and fx.t_stop != fx.t_start]
        b = int(eng.step)
        for fx in ramped:
            fx.begin_step, fx.end_step = b, b + n

        header = "   " + "".join(f"{c:>15}" for c in self.thermo_cols)
        self.log(header)

        fix_by_id = {f"{i+1}": fx for i, fx in enumerate(self.fixes)}
        fix_by_id.update({getattr(fx, "key", "").split(":")[-1]: fx
                          for fx in self.fixes})

        def fix_output(col):
            """f_ID -> compute_scalar; f_ID[k] -> compute_vector(k)."""
            name = col[2:]
            k = None
            if "[" in name:
                name, idx = name[:-1].split("[")
                k = int(idx)
            fx = fix_by_id.get(name)
            if fx is None:
                return 0.0
            st = (eng.fix_view_state() if isinstance(eng, ShardedEngine)
                  else eng.state)
            if k is None:
                return float(fx.energy(st, eng.ctx))
            return float(fx.vector(st)[k - 1])

        def compute_output(col):
            """c_ID -> vector total (last element); c_ID[k] -> element k."""
            name, k = col, None
            if "[" in col:
                name, idx = col[:-1].split("[")
                k = int(idx)
            vc = getattr(self, "vector_computes", {}).get(name)
            if vc is None:
                if name in getattr(self, "computes", {}):
                    raise ScriptError(
                        f"Per-atom compute {name} cannot be used in "
                        f"thermo_style custom (LAMMPS: 'Thermo compute "
                        f"does not compute scalar/vector')")
                raise ScriptError(f"Unknown compute ID in thermo: {name}")
            v = vc(eng.state)
            return float(v[-1] if k is None else v[k - 1])

        var_cols = {}
        for c in self.thermo_cols:
            if c.startswith("v_"):
                # equal-style variable thermo columns, evaluated against
                # the thermo row (LAMMPS Thermo::compute_variable; the
                # keyword env closes the documented equalvar boundary)
                from .equalvar import compile_equal
                name = c[2:]
                if name not in self.variables:
                    raise ScriptError(f"Undefined variable v_{name}")
                var_cols[c] = compile_equal(self.variables[name],
                                            self.variables)

        def var_output(col, row):
            env = dict(row)
            env.setdefault("time", row.get("step", 0) * float(eng.ctx.dt))
            env["etotal"] = row.get("etotal",
                                    row.get("pe", 0.0) + row.get("ke", 0.0))
            return float(var_cols[col](env))

        def on_thermo(row):
            vals = []
            for c in self.thermo_cols:
                if c.startswith("c_"):
                    v = compute_output(c)
                elif c.startswith("f_"):
                    v = fix_output(c)
                elif c in var_cols:
                    v = var_output(c, row)
                else:
                    key = self._COLMAP.get(c, c)
                    v = row.get(key, 0.0) if key else 0.0
                if c == "step":
                    vals.append(f"{int(v):>15d}")
                else:
                    vals.append(f"{v:>15.8g}")
            self.log("   " + "".join(vals))

        # dump frames book their parts under the engine's Output section
        callbacks = [(every, functools.partial(fn.write, timers=eng.timers)
                      if isinstance(fn, DumpWriter) else fn)
                     for every, fn in getattr(self, "dumps", ())]
        rows = eng.run(n, thermo_every=self.thermo_every or max(n, 1),
                       on_thermo=on_thermo, callbacks=callbacks)
        self.last_rows = rows
        if hasattr(eng, "timers"):
            self.log(eng.timers.performance_summary(eng.ctx.dt))
        return rows

    # ------------------------------------------------------------------
    # checkpoint / restart (the state to persist is x, v, image, type, box:
    # both reference pair styles set restartinfo=0, pair_aeam.cpp:38,
    # pair_rebomos.cpp:60; potentials are read again from their files)
    # ------------------------------------------------------------------
    def cmd_write_restart(self, args):
        from ..run.checkpoint import save_state
        st = self._state() if self.engine is None else self.engine.state
        save_state(args[0], st)
        self.log(f"Wrote restart file {args[0]}")

    def cmd_read_data(self, args):
        """read_data <file> — LAMMPS data file (atomic/charge styles)."""
        from .data import read_data
        st = read_data(args[0], atom_style=self.atom_style,
                       periodic=self.boundary, dtype=self.dtype,
                       device=self.device)
        self._adopt(st)
        for t, m in enumerate(st.mass.cpu().numpy()[1:], start=1):
            if m > 0:
                self.masses[t] = float(m)
        self._restart_state = st
        self.engine = None
        self.log(f"Read data file {args[0]} ({st.natoms} atoms)")

    def cmd_write_data(self, args):
        """write_data <file> — current system as a LAMMPS data file."""
        from .data import write_data
        st = self.engine.state if self.engine is not None else self._state()
        write_data(args[0], st, atom_style=self.atom_style)
        self.log(f"Wrote data file {args[0]} ({st.natoms} atoms)")

    def _adopt(self, st: State):
        """Box, type count, positions and types of a read State."""
        self.box = st.box
        self.ntypes = st.mass.shape[0] - 1
        self.positions = st.x.detach().cpu().double().numpy()
        self.types = st.type.cpu().numpy()

    def cmd_read_restart(self, args):
        from ..run.checkpoint import load_state
        st = load_state(args[0], dtype=self.dtype, device=self.device)
        self._adopt(st)
        for t, m in enumerate(st.mass.cpu().numpy()[1:], start=1):
            if m > 0:
                self.masses[t] = float(m)
        self._restart_state = st
        self.engine = None
        self.log(f"Read restart file {args[0]} ({st.natoms} atoms)")
