"""sampler_device_ms_per_step: device time a step that no span of the
energy launched: the proposal, the MH accept, the best tracking and the
segments' copies (device trace)."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    return t["device_s"].get("sampler", 0.0) * 1e3 / run["steps"]
