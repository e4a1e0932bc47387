"""Engine layer: the steps that the host loop ran in segments its rebuild
rule discarded and ran again (the program's redone_steps count) over the
steps the window kept, in %."""


def read(rec):
    n = rec["timers"].get("redone_steps")
    if n is None or rec["steps"] <= 0:
        return None
    return 100.0 * n / rec["steps"]
