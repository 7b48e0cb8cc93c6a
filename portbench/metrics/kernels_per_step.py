"""kernels_per_step: device kernels in the traced window over its steps."""


def read(run):
    t = run["trace"]
    if t is None or not t["kernels"]:
        return None
    return t["kernels"] / run["steps"]
