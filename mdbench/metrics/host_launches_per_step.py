"""Engine layer: the host's runtime launch calls (cudaLaunchKernel*,
cuLaunchKernel*, cudaGraphLaunch) in the traced window per MD step."""


def read(rec):
    if rec["steps"] <= 0 or not rec["trace"]["cards"]:
        return None
    return rec["trace"]["launch_calls"] / rec["steps"]
