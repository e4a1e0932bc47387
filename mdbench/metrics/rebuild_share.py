"""Neighbor rebuild layer: the program's Neigh section over the window (its
device loop's rebuilds timed on the device inside the captured loop, eager
rebuilds on the host clock) over the window's wall, in %."""


def read(rec):
    t = rec["timers"].get("Neigh", 0.0)
    if t <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * t / rec["window_s"]
