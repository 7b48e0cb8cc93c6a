"""attention_roofline: the least time of the window's kernel C and C' calls
(ESM2's attention core, forward and backward) over the device time their
spans launched, in percent."""
from portbench import yardstick


def read(run):
    esm, t = run["config"].get("esm2"), run["trace"]
    fwd, bwd = run["launches"]["kernel_c"], run["launches"]["kernel_c_bwd"]
    if esm is None or t is None or not (fwd and bwd):
        return None
    dev = t["device_s"].get("kernel_c", 0.0) + t["device_s"].get(
        "kernel_c_bwd", 0.0)
    if dev <= 0:
        return None
    heads, dt = esm["attention_heads"], esm["dtype"]
    hd = esm["embed_dim"] // heads
    rows = run["chains"] * run["energy_calls"] * heads * esm["layers"]
    least = 0.0
    for calls, backward in ((fwd, False), (bwd, True)):
        b, ops = yardstick.attention_bytes_ops(rows / calls, run["L"], hd,
                                               dt, backward)
        least += calls * yardstick.bound_s(b, ops, dt)
    return 100.0 * least / dev
