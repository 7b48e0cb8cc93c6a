"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: ``correct`` has
to come out false for each fault a cell can have, and the control (the
reference one precision lower) has to fail the cell's limits. One test
runs a cell on the card at its own size."""
import time

import pytest
import torch

from portbench import harness

CELL = "poe-potts-cnn.gfp.c1024"


def tiny_spec(cell=CELL):
    spec = harness.find_cell(cell)
    spec["traffic"] = {"protein": "TINY", "wt_length": 24, "n_chains": 8,
                       "log_every": 5, "warm_steps": 2}
    return spec


def run_tiny(seed=2 ** 31 + 101, readings=None, cell=CELL):
    return harness.run(cell, tiny_spec(cell), seed, 0.2, False,
                       torch.device("cpu"), time.perf_counter(),
                       readings=readings, log=lambda m: None)


def test_a_sound_run_is_correct_and_the_control_is_not():
    out = run_tiny(readings="control")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    limits = harness.find_cell(CELL)["limits"]
    ctrl = out["readings"]["control"]
    assert any(ctrl[g] > limits[g] for g in limits), (ctrl, limits)
    for g in ("energy_gap", "fit_gap", "grad_gap"):
        assert ctrl[g] >= 3 * out["checks"][g]["value"], g


def test_step_returning_its_state_unchanged(monkeypatch):
    from ppde_tpu_torch.samplers.protein import ppde

    make_step = ppde.make_step

    def frozen(*a, **k):
        step = make_step(*a, **k)

        def f(ctx, state, draws):
            _, ys = step(ctx, state, draws)
            return state, ys
        return f

    monkeypatch.setattr(ppde, "make_step", frozen)
    assert not run_tiny()["correct"]


def test_half_the_batch_left_out(monkeypatch):
    from ppde_tpu_torch.ops import potts_fused

    fn = potts_fused.energy_and_grad

    def half(W, h, xf, col0=0):
        H, g = fn(W, h, xf, col0)
        k = xf.shape[0] // 2
        H, g = H.clone(), g.clone()
        H[k:] = H[:k].mean()
        g[k:] = g[:k].mean(0)
        return H, g

    monkeypatch.setattr(potts_fused, "energy_and_grad", half)
    assert not run_tiny()["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from ppde_tpu_torch.ops import cnn_fused

    fn = cnn_fused.ensemble_apply_and_grad

    def altered(*a, **k):
        fit, dx = fn(*a, **k)
        fit = fit.clone()
        fit[0] += 0.01
        return fit, dx

    monkeypatch.setattr(cnn_fused, "ensemble_apply_and_grad", altered)
    assert not run_tiny()["correct"]


def test_the_gradient_wrong_in_one_chunk_alone():
    from portbench import control

    undo = control.plant_dx_chunk(tiny_spec()["traffic"]["n_chains"])
    try:
        out = run_tiny()
    finally:
        undo()
    assert not out["correct"]
    checks = out["checks"]
    # the fitness is untouched and one chain of eight is wrong: the median
    # does not see it, the 95th percentile does
    assert checks["fit_gap"]["value"] <= checks["fit_gap"]["limit"]
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    assert checks["grad_gap_p95"]["value"] > checks["grad_gap_p95"]["limit"]


@pytest.mark.cuda
def test_a_cell_on_the_card_at_its_own_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = harness.find_cell("poe-potts-cnn.len400.c512")
    out = harness.run("poe-potts-cnn.len400.c512", spec, 2 ** 31 + 7, 3.0,
                      False, torch.device("cuda", 0), time.perf_counter(),
                      log=lambda m: None)
    assert out["correct"], out["checks"]
