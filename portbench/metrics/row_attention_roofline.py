"""row_attention_roofline: the least time of the window's kernel T and T'
calls (the MSA Transformer's tied row attention, forward and backward;
bytes and operations by ``experts/msa.py::row_attention_bytes_ops``) over
the device time their spans launched, in percent."""
from portbench import yardstick
from portbench.experts import msa


def read(run):
    cfg, t = run["config"].get("msa"), run["trace"]
    fwd = run["launches"].get("kernel_t", 0)
    bwd = run["launches"].get("kernel_t_bwd", 0)
    if cfg is None or t is None or not (fwd and bwd):
        return None
    dev = t["device_s"].get("kernel_t", 0.0) + t["device_s"].get(
        "kernel_t_bwd", 0.0)
    if dev <= 0:
        return None
    rows = run["chains"] * run["energy_calls"] * cfg["layers"]
    least = 0.0
    for calls, backward in ((fwd, False), (bwd, True)):
        b, ops = msa.row_attention_bytes_ops(rows / calls, cfg, run["L"],
                                             backward)
        least += calls * yardstick.bound_s(b, ops, cfg["dtype"])
    return 100.0 * least / dev
