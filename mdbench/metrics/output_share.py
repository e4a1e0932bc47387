"""Script / output layer: the Output section of the program's own timers
(thermo rows and dump frames, each ending in a host read) over the traced
window's wall, in %."""


def read(rec):
    out = rec["timers"].get("Output", 0.0)
    if out <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * out / rec["window_s"]
