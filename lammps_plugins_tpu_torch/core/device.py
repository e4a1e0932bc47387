"""The device rule of the port's entry points.

Scene functions, Box constructors, REBOMoS and the host neighbor build
default to the card (device="cuda", float32, the kernels' type).  Without
a CUDA device they raise; they never move to the CPU on their own.  A
caller that wants the CPU (the parity tests) passes device="cpu".
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """torch.device(device), or a clear error when it names CUDA and this
    process has no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lammps_plugins_tpu_torch: no CUDA device. The entry points run "
            "on the card by default; pass device='cpu' to run on the CPU.")
    return dev
