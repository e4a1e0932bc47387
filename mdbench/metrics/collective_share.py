"""Per-device placement layer: the device seconds of the step segments'
collectives, from before each receiving stream's event waits to after its
copies (the program's Comm.collective span, stamped on every shard's
stream and booked as the mean over them), over the window's wall, in %."""


def read(rec):
    t = rec["timers"].get("Comm.collective", 0.0)
    if t <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * t / rec["window_s"]
