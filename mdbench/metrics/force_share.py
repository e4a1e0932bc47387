"""Pair style layer: the device seconds of the pair style's force call in
every step of the window (the program's Pair.forces span, stamped on the
device around the call inside the captured loop) over the window's wall,
in %."""


def read(rec):
    t = rec["timers"].get("Pair.forces", 0.0)
    if t <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * t / rec["window_s"]
