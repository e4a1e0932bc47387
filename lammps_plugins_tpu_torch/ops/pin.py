"""Layout-pin copy: CUDA kernel wrapper and plain-PyTorch twin.

Counterpart of lammps_plugins_tpu/ops/pin_rows.py.  `pin_copy` is the
identity copy of a 2-D [R, L] array (`_pin_call` / `_pin2_call`);
`pin_rows3` and `pin_rows3_v2` keep the JAX functions' shapes around it:

  * pin_rows3:    [A, B, 3] -> flat, zero-padded to [ceil(3AB/128), 128],
                  copied, sliced back to [A*B, 3];
  * pin_rows3_v2: [K, Np, 3] -> [K, 3*Np], copied, viewed as [K*Np, 3].

On the TPU the copy pinned a row-major layout for the mirror gather that
follows; here it runs the same data flow (the `pin` and `pin2` combine
configurations of potentials/rebomos.py).  The twin is `clone()`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

#: kernel launches (one per call that reached the CUDA kernel)
launches = 0


def pin_copy(a: torch.Tensor) -> torch.Tensor:
    """Identity copy of a contiguous 2-D array.  CPU tensors take the twin
    (clone); CUDA float32 tensors the kernel."""
    global launches
    if not build.use_kernel(a, "pin_copy"):
        return a.clone()
    if a.dim() != 2:
        raise ValueError(f"pin_copy: needs a 2-D array, got {tuple(a.shape)}")
    R, L = a.shape
    ptr = build.check(a, "a", (R, L), torch.float32, a.device)
    out = torch.empty_like(a)
    status = build.lib().lpt_pin_copy(ptr, out.data_ptr(), R, L,
                                      build.stream(a.device))
    build.raise_on_error(status, "pin_copy")
    launches += 1
    return out


def pin_rows3(planes_stacked: torch.Tensor) -> torch.Tensor:
    """[A, B, 3] interleaved table -> [A*B, 3] through the [R, 128] copy."""
    M = planes_stacked.shape[0] * planes_stacked.shape[1]
    flat = planes_stacked.reshape(-1)
    L = 128
    R = -(-flat.shape[0] // L)
    flat = F.pad(flat, (0, R * L - flat.shape[0]))
    out = pin_copy(flat.reshape(R, L))
    return out.reshape(-1)[:M * 3].reshape(M, 3)


def pin_rows3_v2(planes_stacked: torch.Tensor) -> torch.Tensor:
    """[K, Np, 3] -> [K*Np, 3] through the [K, 3*Np] copy."""
    K, Np, three = planes_stacked.shape
    out = pin_copy(planes_stacked.reshape(K, Np * three).contiguous())
    return out.reshape(K * Np, three)
