"""Per-device placement layer: the device ms a step of the collectives'
copies and reductions alone, without their waits (the program's Comm.copy
span, the mean over the shards' receiving streams)."""


def read(rec):
    t = rec["timers"].get("Comm.copy", 0.0)
    if t <= 0 or rec["steps"] <= 0:
        return None
    return 1e3 * t / rec["steps"]
