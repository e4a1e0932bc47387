"""pair_style none / zero (port of lammps_plugins_tpu/potentials/none.py):
no pairwise interactions, for pure-fix dynamics such as the fix bfield
cyclotron check, which integrates free charged particles in a uniform
field.  The Engine still keeps a neighbor list at `cutoff`, as LAMMPS
does for `pair_style zero`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..registry import register_pair_style
from .base import PairStyle


@register_pair_style("none")
@register_pair_style("zero")
class PairNone(PairStyle):
    def __init__(self, cutoff: float = 1.0):
        self.cutoff = float(cutoff)
        self.ntypes = None          # the system's, from prepare()

    def prepare(self, types_np: np.ndarray) -> None:
        self.ntypes = int(np.max(types_np))

    def neighbor_requests(self):
        """{"main": cutoff} — as a [T+1, T+1] matrix once the types are
        known (the device rebuild reads its cutoffs per type pair)."""
        if self.ntypes is None:
            return {"main": self.cutoff}
        cut = np.zeros((self.ntypes + 1, self.ntypes + 1))
        cut[1:, 1:] = self.cutoff
        return {"main": cut}

    def energy(self, x, strain, types, nbr, h, center_mask=None):
        # depends on x and strain so that their gradients are defined
        # (strain is None on the forces-only path)
        e = 0.0 * torch.sum(x)
        if strain is not None:
            e = e + 0.0 * torch.sum(strain)
        return e

    def forces(self, x, types, nbr, h):
        return torch.zeros_like(x)
