"""Trajectory dump files in LAMMPS text format (port of
lammps_plugins_tpu/run/dump.py; the same text for the same values).

  * atom:   id type xs ys zs        (scaled coordinates)
  * custom: columns from id, type, x, y, z, xs, ys, zs, ix, iy, iz, vx, vy,
            vz, fx, fy, fz, q and computed columns (`providers`, e.g. c_pe
            of compute pe/atom)

Triclinic boxes get the xy/xz/yz bounds header LAMMPS tools expect.  A
frame's device columns are stacked into one float64 tensor and copied to
the host once (integers and float32 values are exact in float64); the
scaled coordinates are then formed on the host in float64, as the JAX
writer forms them.  A frame's seconds go to the Timers it is given, in
three parts: `Output.dump.compute` (the per-atom computes, device work,
synchronized), `Output.dump.copy` (the host copy) and `Output.dump.text`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.state import State
from .timers import Timers

_INT_COLUMNS = ("id", "type", "ix", "iy", "iz")


class DumpWriter:
    def __init__(self, path: str, columns: Sequence[str] = ("id", "type",
                                                            "xs", "ys", "zs"),
                 append: bool = False, providers=None, group_mask=None):
        """providers: {column: fn(state) -> [N] tensor} for computed
        columns; group_mask: [N] bool, only those atoms are written (atom
        ids stay global: LAMMPS `dump ID group-ID`)."""
        self.path = path
        self.columns = list(columns)
        self.providers = dict(providers or {})
        self.group_mask = (None if group_mask is None
                           else np.asarray(group_mask, bool))
        self.frames = 0
        self._fh = open(path, "a" if append else "w")

    def close(self):
        self._fh.close()

    def __call__(self, state: State):
        self.write(state)

    def _device_columns(self, state: State):
        """(names, [N] device tensors) of everything the frame reads, and
        the position columns' place."""
        cols, names = [], []

        def add(name, t):
            names.append(name)
            cols.append(t.to(torch.float64))

        want = set(self.columns)
        if want & {"x", "y", "z", "xs", "ys", "zs"}:
            for a in range(3):
                add("xyz"[a], state.x[:, a])
        for c in self.columns:
            if c in names or c in ("id", "x", "y", "z", "xs", "ys", "zs"):
                continue
            if c == "type":
                add(c, state.type)
            elif c in ("ix", "iy", "iz"):
                add(c, state.image[:, "xyz".index(c[1])])
            elif c in ("vx", "vy", "vz"):
                add(c, state.v[:, "xyz".index(c[1])])
            elif c in ("fx", "fy", "fz"):
                add(c, state.f[:, "xyz".index(c[1])])
            elif c == "q":
                add(c, state.q)
            elif c in self.providers:
                add(c, self.providers[c](state))
            else:
                raise ValueError(f"Unknown dump column {c!r}")
        return names, cols

    def write(self, state: State, timers: Timers | None = None):
        """Write one frame of `state`; its parts' seconds go to `timers`
        (the running Engine's, when a deck's run calls it)."""
        tm = Timers() if timers is None else timers
        with tm.section("Output.dump.compute"):
            names, cols = self._device_columns(state)
            if state.x.is_cuda:
                torch.cuda.synchronize(state.x.device)
        with tm.section("Output.dump.copy"):
            host = (torch.stack(cols, dim=1).cpu().numpy() if cols
                    else np.zeros((state.natoms, 0)))
        with tm.section("Output.dump.text"):
            self._text(state, dict(zip(names, host.T)))
        self.frames += 1

    def _text(self, state: State, vals: dict):
        """The frame's text from its host columns `vals`, written out."""
        n = state.natoms
        h = state.box.h_np()
        lo = state.box.lo_np()
        xy, xz, yz = h[1, 0], h[2, 0], h[2, 1]
        triclinic = any(abs(v) > 0 for v in (xy, xz, yz))
        if any(c in self.columns for c in ("xs", "ys", "zs")):
            x = np.stack([vals[c] for c in "xyz"], axis=1)
            f = (x - lo) @ np.linalg.inv(h)
            for a, c in enumerate(("xs", "ys", "zs")):
                vals[c] = f[:, a]
        vals["id"] = np.arange(1, n + 1, dtype=np.float64)
        table = np.stack([vals[c] for c in self.columns], axis=1)
        if self.group_mask is not None:
            table = table[self.group_mask]
            n = int(self.group_mask.sum())

        out = ["ITEM: TIMESTEP", str(int(state.step)),
               "ITEM: NUMBER OF ATOMS", str(n)]
        per = "".join("p" if p else "f" for p in state.box.periodic)
        bper = " ".join(2 * c for c in per)
        if triclinic:
            # LAMMPS bound convention for triclinic dumps
            xlo_b = lo[0] + min(0.0, xy, xz, xy + xz)
            xhi_b = lo[0] + h[0, 0] + max(0.0, xy, xz, xy + xz)
            ylo_b = lo[1] + min(0.0, yz)
            yhi_b = lo[1] + h[1, 1] + max(0.0, yz)
            out.append(f"ITEM: BOX BOUNDS xy xz yz {bper}")
            out.append(f"{xlo_b:.16g} {xhi_b:.16g} {xy:.16g}")
            out.append(f"{ylo_b:.16g} {yhi_b:.16g} {xz:.16g}")
            out.append(f"{lo[2]:.16g} {lo[2] + h[2, 2]:.16g} {yz:.16g}")
        else:
            out.append(f"ITEM: BOX BOUNDS {bper}")
            for d in range(3):
                out.append(f"{lo[d]:.16g} {lo[d] + h[d, d]:.16g}")
        out.append("ITEM: ATOMS " + " ".join(self.columns))
        # '%d' % v prints int(v) and '%.8g' % v equals f"{v:.8g}": the JAX
        # writer's text for its integer and float columns
        fmt = " ".join("%d" if c in _INT_COLUMNS else "%.8g"
                       for c in self.columns)
        out.extend(fmt % tuple(row) for row in table.tolist())
        self._fh.write("\n".join(out) + "\n")
        self._fh.flush()
