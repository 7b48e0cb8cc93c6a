"""The copied yardstick against hand-worked counts and against the bounds
PERF.md recorded for the same shapes (NVIDIA H100 peaks)."""
import pytest

from portbench import yardstick as y
from portbench.experts import esm2


def test_potts_counts_at_gfp_by_hand():
    # P = 4864 (237 * 20 = 4740 padded to 128); xf bf16, W and h float32,
    # grad and H float32
    P = 4864
    assert y.potts_padded(237) == P
    n_bytes, ops = y.potts_bytes_ops(128, 237, "float32")
    assert n_bytes == 128 * P * 2 + P * P * 4 + P * 4 + 128 * P * 4 + 128 * 4
    assert n_bytes == 98_389_504
    assert ops == 2 * 128 * 237 * P + 4 * 128 * P == 297_598_976


def test_cnn_counts_by_hand():
    # GFP: T = 233, C = 237, 2C = 474; L = 400: T = 396, C = 400, 2C = 800
    assert y.cnn_ops(128, 237, 3, 237, 474) == 2 * 3 * (
        128 * 233 * 5 * 237 + 128 * 233 * 237 * 474 + 128 * 474 * 237)
    assert y.cnn_ops(128, 237, 3, 237, 474) == 20_400_535_296
    assert y.cnn_ops(128, 400, 3, 400, 800) == 98_174_976_000
    w = 3 * (5 * 20 * 400 + 400 * 800 + 800) * 4 + 3 * (400 + 800 + 1) * 4
    assert y.cnn_bytes(128, 400, 3, 400, 800, "float32") == (
        128 * 400 * 20 * 4 + w + 128 * 4 + 128 * 400 * 20 * 4)


@pytest.mark.parametrize("case, want_ms", [
    # PERF.md section 6: kernel A f32 bound 0.0372 ms [B = 128: 0.0294]
    (("potts", 1024, 237), 0.0372), (("potts", 128, 237), 0.0294),
    # kernel B f32 2.436 [0.305]; the wide kernel at L = 400 f32 1.465
    (("cnn", 1024, 237), 2.436), (("cnn", 128, 237), 0.305),
    (("cnn", 128, 400), 1.465),
])
def test_bounds_match_the_recorded_ones(case, want_ms):
    kind, B, L = case
    if kind == "potts":
        b, ops = y.potts_bytes_ops(B, L, "float32")
    else:
        b = y.cnn_bytes(B, L, 3, L, 2 * L, "float32")
        ops = y.cnn_ops(B, L, 3, L, 2 * L)
    assert y.bound_s(b, ops, "float32") * 1e3 == pytest.approx(want_ms,
                                                               abs=6e-4)


def test_attention_and_esm_counts():
    # PERF.md: rs at (2560, 237, 32) bound 0.0464 ms forward, 0.0811 back
    fwd = y.attention_bytes_ops(2560, 237, 32, "bfloat16", False)
    bwd = y.attention_bytes_ops(2560, 237, 32, "bfloat16", True)
    assert fwd == (4 * 2560 * 237 * 32 * 2, 4 * 2560 * 237 * 32 * 237)
    assert y.bound_s(*fwd, "bfloat16") * 1e3 == pytest.approx(0.0464,
                                                              abs=1e-4)
    assert y.bound_s(*bwd, "bfloat16") * 1e3 == pytest.approx(0.0811,
                                                              abs=1e-4)
    # transformer-M, 128 chains, forward and backward to the input: 19.00
    # TFLOP a step (PERF.md section 5)
    f = esm2.forward_flops({"layers": 30, "embed_dim": 640,
                            "ffn_embed_dim": 2560, "vocab": 33}, 237)
    assert f == 30 * (8 * 237 * 640 ** 2 + 4 * 237 * 640 * 2560
                      + 4 * 237 ** 2 * 640) + 4 * 237 * 640 * 33
    assert 2 * 128 * f / 1e12 == pytest.approx(19.00, abs=0.005)


def test_check_run_catches_a_chain_over_budget():
    import numpy as np

    wt = np.eye(20, dtype=np.float32)[np.zeros(12, int)]
    final = np.repeat(wt[None], 4, 0)
    final[0, :10] = np.eye(20, dtype=np.float32)[1]
    e = np.zeros((3, 4))
    with pytest.raises(y.CheckFailed, match="nmut"):
        y.check_run(e, np.zeros(4), final, final, 3, wt, 10, 2, 4)
    final[0, :10] = wt[:10]
    final[1, 0] = np.eye(20, dtype=np.float32)[1]
    out = y.check_run(e, np.zeros(4), final, final, 3, wt, 10, 2, 4)
    assert out["chains_moved"] == 1 and out["acceptance_rate"] == 3 / 8
