"""REBO forces layer: the roofline bound of a step's REBO forces over the
device time a step of kernel A (the edge cotangents) and the combine
(kernel B), by kernel name in the traced window, in %."""

import roofline

KERNELS = ("rebo_cotangents_kernel", "mirror_combine_kernel")


def read(rec):
    if "rebo_edges" not in rec["counts"] or rec["steps"] <= 0:
        return None
    t = roofline.kernel_seconds(rec, KERNELS) / rec["steps"]
    return 100.0 * roofline.rebo(rec["counts"]) / t if t > 0 else None
