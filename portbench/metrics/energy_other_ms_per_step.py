"""energy_other_ms_per_step: device time a step inside the energy's span
but outside the spans of kernels A, B, C and C' (ESM2's products, norms and
elementwise work; the energy's own sums and casts)."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    return t["device_s"].get("energy", 0.0) * 1e3 / run["steps"]
