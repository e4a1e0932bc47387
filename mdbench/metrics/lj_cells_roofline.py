"""REBOMOS LJ tier layer: the roofline bound of a step's switched-LJ
forces over the device time a step of kernel C (the cell sweep), by
kernel name in the traced window, in %."""

import roofline

KERNELS = ("lj_cells_kernel",)


def read(rec):
    if "lj_window_pairs" not in rec["counts"] or rec["steps"] <= 0:
        return None
    t = roofline.kernel_seconds(rec, KERNELS) / rec["steps"]
    return 100.0 * roofline.lj_window(rec["counts"]) / t if t > 0 else None
