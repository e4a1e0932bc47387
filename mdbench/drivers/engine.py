"""The Engine driver: the program's Engine over the seed's inputs, as the
configuration states, driven by Engine.run.

Set-up runs the compared first steps, the warm-up, and a timed run that
sizes the window.  The window is one Engine.run of whole chunks lasting
about `seconds`, as a user's `run N` (each run call starts by checking
its lists, so many short calls would add work that one run does not).
The traffic file gives warmup_steps, rate_steps, chunk_steps and
check_steps.
"""

from __future__ import annotations

import math

import torch

import harness as H


class Driver:
    def __init__(self, c: dict, inp: dict, device, log=print):
        from lammps_plugins_tpu_torch.core import units
        from lammps_plugins_tpu_torch.core.box import Box
        from lammps_plugins_tpu_torch.core.state import State
        from lammps_plugins_tpu_torch.run.simulation import Engine
        cfg, root = c["cfg"], c["root"]
        self.cfg, self.trf, self.root = cfg, c["trf"], root
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
        self.eng = Engine(st, H.program_pair(cfg, dtype, device, root),
                          H.program_fixes(cfg, root),
                          getattr(units, cfg["units"].upper()),
                          dt=cfg["dt"], skin=cfg["skin"],
                          check_every=cfg["check_every"])
        self.natoms = n
        self.sync = (torch.cuda.synchronize if torch.device(device).type
                     == "cuda" else (lambda: None))

    def snapshot(self) -> dict:
        return H.snapshot(self.eng, self.cfg, self.root)

    def start(self, k: int) -> dict:
        """The compared first steps: the state k steps from the inputs."""
        self.eng.run(k)
        return self.snapshot()

    def prepare(self, seconds: float) -> int:
        """Warm up and size the window: its number of steps."""
        trf = self.trf
        self.eng.run(trf["warmup_steps"])
        self.sync()
        t = H.now()
        self.eng.run(trf["rate_steps"])
        self.sync()
        rate = trf["rate_steps"] / (H.now() - t)
        chunk = trf["chunk_steps"]
        return chunk * max(1, math.ceil(seconds * rate / chunk))

    def window(self, n: int):
        self.eng.run(n)

    def counters(self) -> dict:
        return dict(step=int(self.eng.step), rebuilds=int(self.eng.rebuilds),
                    timers=dict(self.eng.timers.acc),
                    loop=id(getattr(self.eng, "_loop", None)))

    def end(self, k: int):
        """The compared end steps through the same call: (the state where
        the window closed, the state k steps on, with the window's last
        forces as f_start)."""
        before = self.snapshot()
        self.eng.run(k)
        after = self.snapshot()
        after["f_start"] = before["f"]
        return before, after

    def spans(self) -> dict:
        return H.engine_spans(self.eng)

    def outputs(self) -> dict:
        return {}

    def close(self):
        self.eng = None
