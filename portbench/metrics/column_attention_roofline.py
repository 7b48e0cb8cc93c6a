"""column_attention_roofline: the least time of the window's kernel C and
C' calls at the MSA Transformer's column attention (Z = chains x columns x
heads, T = the alignment's rows, its head width; bytes and operations by
``yardstick.attention_bytes_ops``) over the device time their spans
launched, in percent."""
from portbench import yardstick


def read(run):
    cfg, t = run["config"].get("msa"), run["trace"]
    fwd = run["launches"].get("kernel_c", 0)
    bwd = run["launches"].get("kernel_c_bwd", 0)
    if cfg is None or t is None or not (fwd and bwd):
        return None
    dev = t["device_s"].get("kernel_c", 0.0) + t["device_s"].get(
        "kernel_c_bwd", 0.0)
    if dev <= 0:
        return None
    heads, dt = cfg["attention_heads"], cfg["dtype"]
    hd = cfg["embed_dim"] // heads
    z = (run["chains"] * run["energy_calls"] * cfg["layers"]
         * (run["L"] + 1) * heads)
    least = 0.0
    for calls, backward in ((fwd, False), (bwd, True)):
        b, ops = yardstick.attention_bytes_ops(z / calls, cfg["rows"], hd,
                                               dt, backward)
        least += calls * yardstick.bound_s(b, ops, dt)
    return 100.0 * least / dev
