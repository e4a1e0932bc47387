"""pair_style lj/cut with one atom type: the program's PairLJCut and the
plain reference."""

from __future__ import annotations


def program(pc: dict, root: str, dtype, device):
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    pair = PairLJCut(pc["cutoff"], ntypes=1, dtype=dtype, device=device)
    pair.set_coeff(1, 1, pc["epsilon"], pc["sigma"], pc["cutoff"])
    return pair


def reference(pc: dict, root: str, devices):
    """The plain reference on `devices` (one, or the cell's cards)."""
    from ljcut import LJCut
    return LJCut(pc["cutoff"], pc["epsilon"], pc["sigma"], devices)


def deck(pc: dict, root: str) -> list:
    return [f"pair_style lj/cut {pc['cutoff']!r}",
            f"pair_coeff 1 1 {pc['epsilon']!r} {pc['sigma']!r} "
            f"{pc['cutoff']!r}"]
