"""Pair-style interface (port of lammps_plugins_tpu/potentials/base.py).

A PairStyle is one differentiable energy E(x, strain) over fixed-shape
neighbor structures.  Forces are -dE/dx and the virial is -dE/dstrain,
both taken with torch.autograd.grad, as the JAX package takes them with
jax.grad.  Styles may override `forces` with a faster analytic path.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..neighbor.build import NeighborData


class PairStyle:
    """Base class: subclasses implement neighbor_requests() and energy()."""

    name: str = "none"
    #: the style reads per-atom charges (the Engine binds state.q at setup)
    needs_charges: bool = False

    def bind_charges(self, q) -> None:
        """Receive the system's static per-atom charges (a no-op for a
        charge-free style)."""

    def with_charges(self, q) -> "PairStyle":
        """This style bound to the charge array `q` (itself for a
        charge-free style)."""
        return self

    def neighbor_requests(self) -> Mapping[str, np.ndarray]:
        """name -> cutoff (scalar or [T+1, T+1] per-type-pair matrix)."""
        raise NotImplementedError

    def prepare(self, types_np: np.ndarray) -> None:
        """Optional host-side setup from the (static) atom types."""

    def energy(self, x: torch.Tensor, strain: torch.Tensor | None,
               types: torch.Tensor, nbr: NeighborData,
               h: torch.Tensor) -> torch.Tensor:
        """Total potential energy (differentiable in x and strain)."""
        raise NotImplementedError

    def energy_force_virial(self, x, types, nbr, h):
        """(E, F, W): energy, forces = -dE/dx, virial = -dE/dstrain."""
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            s = torch.zeros((3, 3), dtype=x.dtype, device=x.device,
                            requires_grad=True)
            e = self.energy(x_, s, types, nbr, h)
            gx, gs = torch.autograd.grad(e, (x_, s))
        return e.detach(), -gx, -gs

    def energy_virial(self, x, types, nbr, h):
        """(E, W) without forces — for thermo rows."""
        with torch.enable_grad():
            s = torch.zeros((3, 3), dtype=x.dtype, device=x.device,
                            requires_grad=True)
            e = self.energy(x.detach(), s, types, nbr, h)
            (gs,) = torch.autograd.grad(e, (s,))
        return e.detach(), -gs

    def forces(self, x, types, nbr, h):
        """Forces only (the per-step path): -dE/dx without the strain."""
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(
                self.energy(x_, None, types, nbr, h), (x_,))
        return -gx
