"""Checkpoint / resume (port of lammps_plugins_tpu/run/checkpoint.py).

The reference pair styles keep no restart data (restartinfo=0,
pair_aeam.cpp:38, pair_rebomos.cpp:60), so a checkpoint is the dynamical
state: x, v, f, type, q, image, mass, box, step and the fixes' extras
(fix nvt's chain, fix bfield's fields).  Potentials are read again from
their files on resume.

The file is the JAX package's .npz, key for key, so that restart files
cross between the two packages.  Fix extras are stored as
"extras/<key>/<field>".  The writer leaves out the fixes' own step counts
(the `step` field of an extras entry), which only the port keeps; the
reader gives every extras entry its count back from `step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.box import Box
from ..core.device import resolve
from ..core.state import State


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_state(path: str, state: State) -> None:
    data = {
        "x": _np(state.x), "v": _np(state.v), "f": _np(state.f),
        "type": _np(state.type).astype(np.int32), "q": _np(state.q),
        "image": _np(state.image), "mass": _np(state.mass),
        "step": np.asarray(int(state.step), np.int32),
        "box_h": state.box.h_np(), "box_lo": state.box.lo_np(),
        "box_periodic": np.asarray(state.box.periodic),
    }
    for key, sub in state.extras.items():
        if isinstance(sub, dict):
            for field, val in sub.items():
                if field != "step":
                    data[f"extras/{key}/{field}"] = _np(val)
        else:
            data[f"extras/{key}"] = _np(sub)
    with open(path, "wb") as fh:        # the exact filename (np.savez
        np.savez(fh, **data)            # would append ".npz" to a bare one)


def load_state(path: str, dtype=torch.float32, device="cuda") -> State:
    """The State of a restart file written by either package, on `device`
    (the card unless the caller asks for the CPU)."""
    device = resolve(device)
    z = np.load(path, allow_pickle=False)
    box = Box.from_numpy(z["box_h"], z["box_lo"],
                         tuple(bool(p) for p in z["box_periodic"]),
                         dtype=dtype, device=device)
    step = int(z["step"])
    extras: dict = {}
    for name in z.files:
        if not name.startswith("extras/"):
            continue
        parts = name.split("/")
        val = torch.as_tensor(z[name], device=device)
        if val.is_floating_point():
            val = val.to(dtype)
        if len(parts) == 3:
            extras.setdefault(parts[1], {})[parts[2]] = val
        else:
            extras[parts[1]] = val
    for sub in extras.values():
        if isinstance(sub, dict):
            sub["step"] = torch.tensor(step, dtype=torch.int64,
                                       device=device)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                         device=device)
    return State(x=as_t(z["x"], dtype), v=as_t(z["v"], dtype),
                 f=as_t(z["f"], dtype), type=as_t(z["type"], torch.int64),
                 q=as_t(z["q"], dtype), image=as_t(z["image"], torch.int32),
                 mass=as_t(z["mass"], dtype), box=box, step=step,
                 extras=extras)
