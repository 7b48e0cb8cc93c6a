"""kernel_a_roofline: the least time of the window's kernel A calls (the
Potts energy and gradient: bytes of x, W, h, grad and H; operations on x's
nonzeros) over the device time their span launched, in percent."""
from portbench import yardstick


def read(run):
    t, calls = run["trace"], run["launches"]["kernel_a"]
    dev = t["device_s"].get("kernel_a", 0.0) if t else 0.0
    if not calls or dev <= 0:
        return None
    rows = run["chains"] * run["energy_calls"]
    b, ops = yardstick.potts_bytes_ops(rows / calls, run["L"],
                                       run["config"]["potts"]["dtype"])
    return 100.0 * calls * yardstick.bound_s(
        b, ops, run["config"]["potts"]["dtype"]) / dev
