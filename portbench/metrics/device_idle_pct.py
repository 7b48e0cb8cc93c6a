"""device_idle_pct: the share of a step in which no kernel, copy or fill
ran on the device: the traced window's device busy time over the seconds
of the same window run untraced (the profiler's host cost left out), in
percent."""


def read(run):
    t = run["trace"]
    if t is None or t["host_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["host_window_s"])
