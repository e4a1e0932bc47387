"""The H100's published peaks and the work each force layer needs, counted
from the physics of the run's inputs (atoms, and the pairs and edges
within the cutoffs at the end state) and never from the program's padded
lists, its kernels' internals or the pairs it happens to test.

Peaks: NVIDIA H100 SXM data sheet at 700 W, HBM 3.35 TB/s and 67 TFLOP/s
FP32 outside the tensor cores; the special-function units 132 SMs x 16 a
clock at the 1.98 GHz boost clock.  A share is the least time the chip
could take (the larger of bytes over bandwidth and operations over their
rate) over the time measured; inputs are read once and outputs written
once, in the configuration's float32.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS = 132 * 16 * 1.98e9
F32 = 4


def bound_s(nbytes: float, flops: float, sfu: float = 0.0) -> float:
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS, sfu / SFU_OPS)


def rebo(counts: dict) -> float:
    """REBO forces: positions and types in, forces out, each directed edge
    within rcmax read once (its neighbour index); 40 flops and 5
    special-function operations a directed edge, 100 flops a pair of one
    atom's edges (the angle, g, g' and the two passes' sums)."""
    n = counts["atoms"]
    e = counts["rebo_edges"]
    nbytes = n * (3 * F32 + F32) + n * 3 * F32 + e * F32
    return bound_s(nbytes, 40 * e + 100 * counts["rebo_edge_pairs"], 5 * e)


def lj_window(counts: dict) -> float:
    """REBOMOS's switched LJ tier: 30 flops for each ordered pair inside
    [rcLJmin, rcLJmax], positions and types in, forces out."""
    n = counts["atoms"]
    return bound_s(n * (4 * F32) + n * 3 * F32,
                   30 * counts["lj_window_pairs"])


#: one unordered lj/cut pair: the displacement (3), r^2 (5), 1/r^2 (1),
#: r^-6 (2), the force over r (4), its three components (3) and the sums
#: into both atoms (6)
LJCUT_PAIR_FLOPS = 24


def ljcut(counts: dict) -> float:
    """lj/cut forces: the unordered pairs within the force cutoff."""
    n = counts["atoms"]
    return bound_s(n * 3 * F32 + n * 3 * F32,
                   LJCUT_PAIR_FLOPS * counts["ljcut_pairs"])


def kernel_seconds(rec: dict, names) -> float:
    """Device seconds over the traced window of the ops whose names hold
    any of `names`, summed over the cards."""
    return sum(s for card in rec["trace"]["cards"].values()
               for op, s in card["ops"].items()
               if any(n in op for n in names))
