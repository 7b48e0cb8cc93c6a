"""step_mfu_pct: the model FLOPs of the traced window's energy calls (the
Potts and CNN counts of the rooflines, and each expert's forward and its
backward to the input, 2 x its module's ``forward_flops`` a chain) over the
seconds of the same window run untraced (host clock: the profiler's own
cost left out) and the chip's bf16 dense peak, in percent."""
from portbench import experts, yardstick


def read(run):
    t = run["trace"]
    if t is None or t["host_window_s"] <= 0:
        return None
    cfg, n, L = run["config"], run["chains"], run["L"]
    cnn = cfg["cnn"]
    C = L if cnn["channels"] == "L" else int(cnn["channels"])
    per_call = (yardstick.potts_bytes_ops(n, L, cfg["potts"]["dtype"])[1]
                + yardstick.cnn_ops(n, L, cnn["members"], C, 2 * C,
                                    cnn["kernel"]))
    for _, mod, settings in experts.of(cfg):
        per_call += 2 * n * mod.forward_flops(settings, L)
    flops = per_call * run["energy_calls"]
    return 100.0 * flops / t["host_window_s"] / yardstick.STEP_PEAK
