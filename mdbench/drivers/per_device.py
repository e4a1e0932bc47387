"""The per-device driver: the program's sharded engine over the seed's
inputs, each shard on its own device as the configuration's `layout`
states, driven by ShardedEngine.run as users call it.

layout: {"shards": n, "per_card": m, "grid": [Px, Py]}: shard d on card
d // m of the cell's cards (on the CPU every shard on the CPU), the
domains a Px x Py grid.  The engine is then a PerDeviceEngine: its host
loop reads once a segment, each segment a captured program a shard.

Set-up runs the compared first steps, the warm-up (past the capacity
re-sizes of the first steps, so that no re-size or re-capture falls in the
window) and a timed run of rate_steps that sizes the window: whole
segments lasting the larger of `seconds` and the traffic's
window_seconds, one run call.  counters() gives, beside the engine's
timers, the host loop's discarded segments and their steps
(`redone_segments`, `redone_steps`), the captured programs (`captures`)
and the capacity re-sizes (`resizes`); the window's are logged in a line
of their own.

compare_outputs() adds x_ulp: the largest |x_program - x_reference| over
atoms and components after a check's steps, each over the float32
spacing at the reference's coordinate as the program stores it (wrapped
by the program's own image counts), a coordinate nearer zero than
ULP_FLOOR taken at ULP_FLOOR.  The program's positions are unwrapped as
the reference's start was (images times the float64 box), except that a
period crossed during the check's steps is the program's own float32 box
length, which is how far the program moved the row.  Far from the origin
both a sound run and a wrong one read a few spacings of position
rounding; near it the positions that forces in bfloat16 reach are many
spacings off.  The reference's end positions come from the harness's own
follow of each check (kept as it runs), so no check is followed twice.
"""

from __future__ import annotations

import json
import math

import torch

import harness as H

#: length units: coordinates nearer zero are read at this spacing (that of
#: a coordinate of 1), so that the reading follows the forces and not the
#: one coordinate that happens to lie nearest zero
ULP_FLOOR = 1.0
#: counters of the window, logged and read by the metrics
COUNTS = ("redone_segments", "redone_steps", "captures", "resizes")


def shard_devices(layout: dict, device) -> list:
    """One torch device per shard: shard d on card d // per_card, or
    every shard on a CPU `device`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * layout["shards"]
    return [torch.device("cuda", d // layout["per_card"])
            for d in range(layout["shards"])]


class _Follow:
    """harness.follow, keeping where each run of it ended: (id of the
    starting state, dtype) -> positions."""

    def __init__(self, follow):
        self.follow = follow
        self.ends = {}

    def __call__(self, cfg, inp, pot, start, k, dtype=torch.float64,
                 root=H.ROOT):
        s, f0, integ = self.follow(cfg, inp, pot, start, k, dtype=dtype,
                                   root=root)
        self.ends[(id(start), dtype)] = s.x
        return s, f0, integ


class Driver:
    def __init__(self, c: dict, inp: dict, device, log=print):
        from lammps_plugins_tpu_torch import ShardedEngine
        from lammps_plugins_tpu_torch.core import units
        from lammps_plugins_tpu_torch.core.box import Box
        from lammps_plugins_tpu_torch.core.state import State
        cfg, root = c["cfg"], c["root"]
        self.cfg, self.trf, self.root, self.log = cfg, c["trf"], root, log
        lay = cfg["layout"]
        dtype = inp["dtype"]
        n = len(inp["types"])
        box = Box.from_numpy(inp["h"].cpu().numpy(), dtype=dtype,
                             device=device)
        st = State(x=inp["x"].to(dtype), v=inp["v"].to(dtype),
                   f=torch.zeros((n, 3), dtype=dtype, device=device),
                   type=inp["types"].to(torch.int64),
                   q=torch.zeros(n, dtype=dtype, device=device),
                   image=torch.zeros((n, 3), dtype=torch.int32,
                                     device=device),
                   mass=inp["mass"].to(dtype), box=box, step=0, extras={})
        self.eng = ShardedEngine(
            st, H.program_pair(cfg, dtype, device, root),
            H.program_fixes(cfg, root), getattr(units, cfg["units"].upper()),
            devices=shard_devices(lay, device), dt=cfg["dt"],
            skin=cfg["skin"], check_every=cfg["check_every"],
            grid=tuple(lay["grid"]), placement="per_device")
        self.counters()     # a program that keeps none fails before warm-up
        self.natoms = n
        self.sync = self.eng.group.synchronize
        self.out = {}
        self._win = None
        if not isinstance(H.follow, _Follow):
            H.follow = _Follow(H.follow)

    def snapshot(self) -> dict:
        """The engine's state as float64 copies (harness.snapshot's
        fields), with the program's image counts."""
        eng = self.eng
        st = eng.to_state()
        h = torch.tensor(st.box.h64, dtype=torch.float64,
                         device=st.x.device)
        ext = {}
        for fc, mod in H.fix_modules(self.cfg, self.root):
            ext.update(mod.snapshot(fc, eng.fix_view_state().extras))
        return dict(x=st.x.double() + st.image.double() @ h,
                    v=st.v.double().clone(), f=st.f.double().clone(),
                    image=st.image.clone(), ext=ext, step=int(eng.step),
                    rebuilds=int(eng.resettles))

    def start(self, k: int) -> dict:
        """The compared first steps: the state k steps from the inputs."""
        self.eng.run(k)
        self.out["start"] = self.snapshot()
        return self.out["start"]

    def prepare(self, seconds: float) -> int:
        """Warm up and size the window: its number of steps."""
        trf = self.trf
        every = self.cfg["check_every"]
        self.eng.run(trf["warmup_steps"])
        self.sync()
        t = H.now()
        self.eng.run(trf["rate_steps"])
        self.sync()
        rate = trf["rate_steps"] / (H.now() - t)
        span = max(seconds, trf["window_seconds"])
        return every * max(1, math.ceil(span * rate / every))

    def window(self, n: int):
        mark = self.counters()
        self.eng.run(n)
        self._win = (mark, self.counters())

    def counters(self) -> dict:
        eng = self.eng
        timers = dict(eng.timers.acc)
        timers.update(eng.timers.counts, captures=eng.captures,
                      resizes=eng.regrows)
        return dict(step=int(eng.step), rebuilds=int(eng.resettles),
                    timers=timers, loop=eng.captures)

    def end(self, k: int):
        """The compared end steps through the same call: (the state where
        the window closed, the state k steps on, with the window's last
        forces as f_start).  Logs the window's counters first."""
        if self._win is not None:
            a, b = self._win
            self.log("# window counters " + json.dumps(dict(
                steps=b["step"] - a["step"],
                rebuilds=b["rebuilds"] - a["rebuilds"],
                **{key: b["timers"].get(key, 0) - a["timers"].get(key, 0)
                   for key in COUNTS})))
        before = self.snapshot()
        self.eng.run(k)
        after = self.snapshot()
        after["f_start"] = before["f"]
        self.out["end"] = after
        return before, after

    def spans(self) -> dict:
        return {}

    def outputs(self) -> dict:
        """The program's states that the checks compared."""
        return self.out

    def close(self):
        self.eng.close()
        self.eng = None


def f32_spacing(c: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at |c| (float64), |c| below ULP_FLOOR read at
    ULP_FLOOR."""
    _, e = torch.frexp(c.abs().clamp(min=ULP_FLOOR))
    return torch.ldexp(torch.ones_like(c), e - 24)


def compare_outputs(c: dict, inp: dict, pot, outs: dict, states: dict,
                    control: bool) -> dict:
    """x_ulp, the larger of the start and end checks' (module docstring);
    x_ulp.at says where the larger lies.  In control mode the reference
    in bfloat16 stands in the program's place."""
    cfg, k = c["cfg"], c["trf"]["check_steps"]
    follow = H.follow
    ends = follow.ends if isinstance(follow, _Follow) else {}

    def end_x(start, dtype):
        x = ends.get((id(start), dtype))
        if x is None:
            x = follow(cfg, inp, pot, start, k, dtype=dtype)[0].x
        return x

    h = inp["h"].double()
    h_prog = inp["h"].to(inp["dtype"]).double()
    nums = {"x_ulp": -math.inf}
    for tag in ("start", "end"):
        got = outs[tag]
        ref = end_x(states[tag], torch.float64)
        dev = ref.device
        image = got["image"].to(dev).double()
        im0 = states[tag].get("image")       # none: the inputs, image 0
        crossed = image - (0.0 if im0 is None else im0.to(dev).double())
        x = (end_x(states[tag], torch.bfloat16) if control
             else got["x"].to(dev) - crossed @ (h - h_prog).to(dev))
        stored = ref - image @ h.to(dev)
        ulps = (x - ref).abs() / f32_spacing(stored)
        v = float(ulps.max())
        if v > nums["x_ulp"]:
            i = int(ulps.argmax())
            a, comp = divmod(i, 3)
            nums["x_ulp"] = v
            nums["x_ulp.at"] = (
                f"{tag} atom {a} component {comp} stored coordinate "
                f"{float(stored[a, comp]):.6f} |dx| "
                f"{float((x[a, comp] - ref[a, comp]).abs()):.3e}")
    if isinstance(follow, _Follow):
        H.follow = follow.follow
    return nums
