"""Script / output layer: the host seconds that the window's dump frames
spend forming and writing their text (the program's Output.dump.text span)
over the window's wall, in %."""


def read(rec):
    t = rec["timers"].get("Output.dump.text", 0.0)
    if t <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * t / rec["window_s"]
