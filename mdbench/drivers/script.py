"""The Script driver: the program's input-script interpreter running a deck,
as users run the program, with the deck's outputs in the window.

The deck is made from the configuration (units, the seed's atoms and
velocities through read_data of a data file, the style's and the fixes'
lines, the neighbour settings, the timestep) and the traffic's `outputs`
lines, where {dir} names the run's own directory under TMPDIR (deleted at
the end).  Its `run` commands are the calls: the compared first steps
(`run check_steps`, which writes the first frame and thermo row from the
seed's inputs), the warm-up and a sizing run with the dumps held back (so
that they write no frames), a sizing run with them, the window and the
compared end steps (dumps held back).  The window runs whole periods of
`period_steps` (the largest output interval), as many as reach past
`seconds` at the pace the sizing runs read.

compare_outputs() holds the first thermo row and frame, and the window's
last, against the reference at the states they were written from: the
seed's inputs, and the state where the window closed.
"""

from __future__ import annotations

import math
import mmap
import os
import re
import shutil
import tempfile

import numpy as np
import torch

import harness as H
from integrate import UNITS, rms, stress_atom, thermo


class Driver:
    def __init__(self, c: dict, inp: dict, device, log=print):
        from lammps_plugins_tpu_torch.api.script import Script
        self.cfg, self.trf, self.root = c["cfg"], c["trf"], c["root"]
        self.natoms = len(inp["types"])
        self.sync = (torch.cuda.synchronize if torch.device(device).type
                     == "cuda" else (lambda: None))
        self.dir = tempfile.mkdtemp(prefix="mdbench-")
        data = os.path.join(self.dir, "atoms.data")
        write_data(data, inp)
        self.rows = []
        self.script = Script(log=self._log, dtype=inp["dtype"],
                             device=device)
        self.script.run_text(deck(self.cfg, self.trf, data, self.dir,
                                  self.root))
        self.out = {}

    @property
    def eng(self):
        return self.script.engine

    def _log(self, text):
        """Keep the thermo rows the deck prints (as a user reads them)."""
        cols = self.script.thermo_cols
        for line in str(text).splitlines():
            tok = line.split()
            if len(tok) != len(cols) or tok == cols:
                continue
            try:
                self.rows.append(dict(zip(cols, map(float, tok))))
            except ValueError:
                continue

    def _run(self, n: int, dumps: bool = True):
        held = getattr(self.script, "dumps", [])
        if not dumps:
            self.script.dumps = []
        try:
            self.script.command(f"run {n}")
        finally:
            self.script.dumps = held

    def snapshot(self) -> dict:
        return H.snapshot(self.eng, self.cfg, self.root)

    def start(self, k: int) -> dict:
        self.rows.clear()
        self._run(k)
        self.out["start"] = dict(step=0, row=self.rows[0] if self.rows
                                 else {}, frame=self._last_frame())
        return self.snapshot()

    def prepare(self, seconds: float) -> int:
        """Warm up, then size the window from two sizing runs of
        rate_steps, the second with its frame (written at its first
        step): a period is period_steps at the first's pace plus the
        frame's time, the difference of the two."""
        trf = self.trf
        n = trf["rate_steps"]
        self._run(trf["warmup_steps"], dumps=False)
        bare, dumped = (self._timed(n, dumps=False), self._timed(n))
        per = trf["period_steps"]
        t_period = per * bare / n + max(0.0, dumped - bare)
        return per * max(1, math.ceil(seconds / t_period))

    def _timed(self, n: int, dumps: bool = True) -> float:
        self.sync()
        t = H.now()
        self._run(n, dumps)
        self.sync()
        return H.now() - t

    def window(self, n: int):
        self.rows.clear()
        self._run(n)

    def counters(self) -> dict:
        eng = self.eng
        return dict(step=int(eng.step), rebuilds=int(eng.rebuilds),
                    timers=dict(eng.timers.acc),
                    loop=id(getattr(eng, "_loop", None)))

    def end(self, k: int):
        before = self.snapshot()
        self.out["end"] = dict(step=before["step"], row=self.rows[-1]
                               if self.rows else {}, frame=self._last_frame())
        self._run(k, dumps=False)
        after = self.snapshot()
        after["f_start"] = before["f"]
        return before, after

    def spans(self) -> dict:
        return H.engine_spans(self.eng)

    def outputs(self) -> dict:
        return self.out

    def _last_frame(self) -> dict:
        """The last frame of the deck's dump as columns (none without
        one; a deck has at most one)."""
        dumps = getattr(self.script, "dumps", [])
        if not dumps:
            return {}
        (_, writer), = dumps
        return read_last_frame(writer.path)

    def close(self):
        for _, writer in getattr(self.script, "dumps", []):
            writer.close()
        self.script = None
        shutil.rmtree(self.dir, ignore_errors=True)


def deck(cfg: dict, trf: dict, data: str, out_dir: str, root: str) -> str:
    style = H.find("styles", cfg["pair"]["style"], root)
    lines = [f"units {cfg['units']}", "atom_style atomic",
             "boundary p p p", f"read_data {data}",
             *style.deck(cfg["pair"], root),
             f"neighbor {cfg['skin']!r} bin",
             f"neigh_modify every {cfg['check_every']} delay 0 check yes",
             f"timestep {cfg['dt']!r}"]
    for i, (fc, mod) in enumerate(H.fix_modules(cfg, root), start=1):
        lines.append(mod.deck(fc, str(i)))
    lines += [ln.replace("{dir}", out_dir) for ln in trf["outputs"]]
    return "\n".join(lines) + "\n"


def write_data(path: str, inp: dict):
    """A LAMMPS data file (atomic style) of the inputs: box, masses, atoms
    and velocities, every number exact (%.17g, or repr)."""
    h = inp["h"].cpu().numpy()
    x = inp["x"].cpu().numpy()
    v = inp["v"].cpu().numpy()
    types = inp["types"].cpu().numpy()
    mass = inp["mass"].cpu().numpy()
    n = len(types)
    g = "%.17g"
    head = [
        "mdbench: the seed's atoms", "", f"{n} atoms",
        f"{len(mass) - 1} atom types", "",
        f"0 {g % h[0, 0]} xlo xhi", f"0 {g % h[1, 1]} ylo yhi",
        f"0 {g % h[2, 2]} zlo zhi",
        f"{g % h[1, 0]} {g % h[2, 0]} {g % h[2, 1]} xy xz yz", "",
        "Masses", "", *(f"{t} {g % mass[t]}" for t in range(1, len(mass))),
        "", "Atoms # atomic", ""]
    ids = np.arange(1, n + 1)
    with open(path, "w") as fh:
        fh.write("\n".join(head) + "\n")
        fh.write("\n".join(f"{i} {t} {a!r} {b!r} {c!r}" for i, t, (a, b, c)
                           in zip(ids.tolist(), types.tolist(), x.tolist())))
        fh.write("\n\nVelocities\n\n")
        fh.write("\n".join(f"{i} {a!r} {b!r} {c!r}" for i, (a, b, c)
                           in zip(ids.tolist(), v.tolist())))
        fh.write("\n")


def read_last_frame(path: str) -> dict:
    """The last frame of a dump file: step and {column: [N] float64}."""
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0,
                                           access=mmap.ACCESS_READ) as mm:
        at = mm.rfind(b"ITEM: TIMESTEP")
        text = mm[at:].decode()
    head, body = text.split("ITEM: ATOMS", 1)
    cols_line, body = body.split("\n", 1)
    cols = cols_line.split()
    h = head.split("\n")
    step, n = int(h[1]), int(h[3])
    vals = np.fromstring(body, sep=" ").reshape(n, len(cols))
    return dict(step=step, **{c: vals[:, i] for i, c in enumerate(cols)})


#: thermo columns compared (the deck's names)
THERMO = ("temp", "epair", "pe", "ke", "etotal", "press")


def compare_outputs(c: dict, inp: dict, pot, outs: dict, states: dict,
                    control: bool) -> dict:
    """thermo (the largest relative gap of a compared thermo column; each
    column's also as thermo.<column>), pe_atom and stress_atom (the
    largest gap of an atom's compute pe/atom value, or stress/atom
    component, over the rms of the reference's) of the first and the
    window's last row and frame."""
    cfg, trf = c["cfg"], c["trf"]
    units = UNITS[cfg["units"]]
    computes = {ln.split()[1]: ln.split()[3] for ln in trf["outputs"]
                if ln.split()[0] == "compute"}
    h, types = inp["h"], inp["types"]
    m = inp["mass"].double()[types]
    volume = float(torch.linalg.det(h.double()).abs())
    nums = dict(thermo=-math.inf, pe_atom=-math.inf, stress_atom=-math.inf)
    for tag, o in outs.items():
        st = states[tag]
        x, v = st["x"], st["v"]
        pairs = pot.pairs(x, h, types)
        ref = _values(pot.evaluate(x, h, types, pairs, tallies=True), v, m,
                      volume, units)
        if control:
            got = _values(pot.evaluate(x, h, types, pairs, torch.bfloat16,
                                       tallies=True), v, m, volume, units)
            row, frame = got["row"], {}
            for col in o["frame"]:
                val = _frame_value(col, computes, got)
                if val is not None:
                    frame[col] = val
        else:
            row, frame = o["row"], {col: torch.as_tensor(val, device=x.device)
                                    for col, val in o["frame"].items()}
        steps_ok = all(int(r["step"]) == o["step"]
                       for r in (o["row"], o["frame"]) if r)
        for col in THERMO:
            if col in row:
                scale = ref["row"]["press_scale" if col == "press" else col]
                gap = abs(row[col] - ref["row"][col]) / abs(scale)
                gap = gap if steps_ok else math.nan
                nums["thermo"] = _worse(nums["thermo"], gap)
                nums[f"thermo.{col}"] = _worse(
                    nums.get(f"thermo.{col}", gap), gap)
        for col, val in frame.items():
            want = _frame_value(col, computes, ref)
            if want is None or col == "step":
                continue
            key = "pe_atom" if computes[_cid(col)] == "pe/atom" \
                else "stress_atom"
            norm = ref["pe_rms"] if key == "pe_atom" else ref["s_rms"]
            diff = (val.double() - want).abs()
            gap = float(diff.max()) / norm
            if gap > nums[key]:
                i = int(diff.argmax())
                nums[key + ".at"] = (
                    f"{tag} {col} atom {i} type {int(types[i])} x "
                    + " ".join(f"{float(a):.3f}" for a in x[i])
                    + f" got {float(val[i]):.8g} ref {float(want[i]):.8g}"
                    f" rms {norm:.6g}")
            nums[key] = _worse(nums[key], gap if steps_ok else math.nan)
    return nums


def _worse(a: float, b: float) -> float:
    """The larger gap; a missing one (nan) stays missing."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _values(ev: dict, v, m, volume: float, units) -> dict:
    s = stress_atom(ev["vatom"], v, m, units)
    return dict(row=thermo(ev["e"], ev["vatom"][:, :3].sum(), v, m, volume,
                           units),
                pe=ev["eatom"], s=s, pe_rms=rms(ev["eatom"][:, None]),
                s_rms=rms(s.reshape(-1, 1)))


def _cid(col: str) -> str:
    return re.sub(r"\[\d+\]$", "", col)[2:]


def _frame_value(col: str, computes: dict, vals: dict):
    """The reference's value of a dump column c_ID or c_ID[k] of compute
    pe/atom or stress/atom, or None for another column."""
    if not col.startswith("c_") or _cid(col) not in computes:
        return None
    style = computes[_cid(col)]
    if style == "pe/atom":
        return vals["pe"]
    k = re.search(r"\[(\d+)\]$", col)
    if style == "stress/atom" and k:
        return vals["s"][:, int(k.group(1)) - 1]
    return None
