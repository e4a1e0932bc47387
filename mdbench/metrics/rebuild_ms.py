"""Neighbor rebuild layer: device ms of one Engine.rebuild_neighbors() on
the run's end state, by CUDA events in the benchmark's own span, the
median of a few."""

import statistics


def read(rec):
    ms = rec["spans"].get("rebuild_ms")
    return statistics.median(ms) if ms else None
