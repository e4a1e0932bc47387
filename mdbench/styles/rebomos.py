"""pair_style rebomos: the program's REBOMoS read from the configuration's
parameter file, and the plain reference read from the same file."""

from __future__ import annotations

import os


def program(pc: dict, root: str, dtype, device):
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    return REBOMoS.from_file(os.path.join(root, pc["file"]), pc["elements"],
                             dtype=dtype, device=device)


def reference(pc: dict, root: str, devices):
    """The plain reference on `devices` (one, or the cell's cards)."""
    from rebomos import REBOMoS
    return REBOMoS(os.path.join(root, pc["file"]), pc["elements"],
                   devices=devices)


def deck(pc: dict, root: str) -> list:
    return ["pair_style rebomos",
            f"pair_coeff * * {os.path.join(root, pc['file'])} "
            + " ".join(pc["elements"])]
