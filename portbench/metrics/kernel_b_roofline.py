"""kernel_b_roofline: the least time of the window's kernel B calls (the
OnehotCNN ensemble's fitness and input gradient; operations at the
configuration's type's peak) over the device time their span launched, in
percent."""
from portbench import yardstick


def read(run):
    t, calls = run["trace"], run["launches"]["kernel_b"]
    dev = t["device_s"].get("kernel_b", 0.0) if t else 0.0
    if not calls or dev <= 0:
        return None
    cnn, L = run["config"]["cnn"], run["L"]
    C = L if cnn["channels"] == "L" else int(cnn["channels"])
    B = run["chains"] * run["energy_calls"] / calls
    M, K, dt = cnn["members"], cnn["kernel"], cnn["dtype"]
    n_bytes = yardstick.cnn_bytes(B, L, M, C, 2 * C, dt, K)
    ops = yardstick.cnn_ops(B, L, M, C, 2 * C, K)
    return 100.0 * calls * yardstick.bound_s(n_bytes, ops, dt) / dev
