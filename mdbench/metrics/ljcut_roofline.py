"""LJ forces layer: the roofline bound of lj/cut's forces over the device
time of the pair style's force call on the run's end state and lists, by
CUDA events in the benchmark's own span (median of a few), in %."""

import statistics

import roofline


def read(rec):
    ms = rec["spans"].get("pair_forces_ms")
    if "ljcut_pairs" not in rec["counts"] or not ms:
        return None
    return 100.0 * roofline.ljcut(rec["counts"]) / (
        statistics.median(ms) * 1e-3)
