"""Atom state (port of lammps_plugins_tpu/core/state.py).

A frozen dataclass of fixed-shape tensors.  Updates build a new State
(`replace`) rather than writing in place, so the Engine can keep a
segment's start state for the half-skin redo rule without copying.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .box import Box


@dataclasses.dataclass(frozen=True)
class State:
    """x, v, f [N, 3]; type [N] 1-based (int64); q [N]; image [N, 3]
    int32; mass [T+1] per type (index 0 unused); step: Python int."""

    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    type: torch.Tensor
    q: torch.Tensor
    image: torch.Tensor
    mass: torch.Tensor
    box: Box
    step: int
    extras: Dict[str, Any]

    @property
    def natoms(self) -> int:
        return self.x.shape[0]

    @property
    def per_atom_mass(self) -> torch.Tensor:
        return self.mass[self.type]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, x, type, box: Box, mass, v=None, q=None, image=None,
               dtype=None, device=None) -> "State":
        """Build from array-likes; dtype/device default to the box's."""
        dtype = dtype or box.h.dtype
        device = device or box.h.device
        xt = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        n = xt.shape[0]

        def arr(a, shape, dt):
            if a is None:
                return torch.zeros(shape, dtype=dt, device=device)
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return cls(x=xt, v=arr(v, (n, 3), dtype),
                   f=torch.zeros((n, 3), dtype=dtype, device=device),
                   type=arr(type, (n,), torch.int64),
                   q=arr(q, (n,), dtype),
                   image=arr(image, (n, 3), torch.int32),
                   mass=arr(mass, None, dtype),
                   box=box.to(device, dtype), step=0, extras={})
