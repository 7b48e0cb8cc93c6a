"""The MSA Transformer's expert module (``experts/msa.py``): its interface,
the context it draws from the seed, the FLOP and byte counts its readers
use, the weights' layout against the program's, and the cell at a tiny
width through the harness on the CPU."""
import math
import os
import time

import numpy as np
import pytest
import torch

from portbench import experts, harness, proteins, reference
from portbench.experts import esm2 as bench_esm2, msa

CELL = "poe-msa1b.gfp.c128"
SEED = 2 ** 31 + 4321
TINY = {"program_name": "msa-tiny", "layers": 2, "embed_dim": 32,
        "attention_heads": 2, "ffn_embed_dim": 64, "max_positions": 256,
        "rows": 4}


def cell_config():
    return harness.find_cell(CELL)["config"]


def test_msa_is_found_by_its_key_and_its_interface_is_whole():
    cfg = cell_config()
    (key, mod, settings), = experts.of(cfg)
    assert key == "msa" and mod is msa and settings is cfg["msa"]
    assert mod.cli_term(settings) == "msa-1b"
    assert mod.cli_args(settings, {msa.FILE: "w.npz",
                                   msa.CONTEXT: "c.a2m"}) == {
        "msa_expert_weights": "w.npz", "allow_random_esm": False,
        "msa_expert_context": "c.a2m", "msa_expert_rows": 32,
        "esm_chunk": 0}
    assert mod.SPAN_PREFIX == "msa." and 1 <= mod.REFERENCE_BLOCK <= 8
    assert mod.SERVED and set(mod.KERNELS) == {"kernel_t", "kernel_t_bwd"}
    assert not set(mod.KERNELS) & set(bench_esm2.KERNELS)
    assert mod.control_round is bench_esm2.round_fp8
    mod.check_dtype(settings)
    with pytest.raises(ValueError, match="bfloat16"):
        mod.check_dtype(dict(settings, dtype="float32"))


def test_the_configuration_holds_the_published_widths():
    cfg = cell_config()["msa"]
    assert (cfg["layers"], cfg["embed_dim"], cfg["attention_heads"],
            cfg["ffn_embed_dim"], cfg["vocab"], cfg["max_positions"]) == (
        12, 768, 12, 3072, 33, 1024)
    assert cfg["rows"] == 32 and cfg["dtype"] == "bfloat16"
    traffic = harness.find_cell(CELL)["traffic"]
    assert (traffic["n_chains"], traffic["log_every"]) == (128, 5)
    assert len(traffic["wild_type"]) == 237


def test_the_context_is_drawn_from_the_seed():
    wt = harness.find_cell(CELL)["traffic"]["wild_type"]
    rows = msa.read_fasta(msa.ALIGNMENT)
    assert rows[0][1] == wt and len(rows) == 2001

    def draw(seed):
        return msa.context_rows(torch.Generator().manual_seed(seed), wt, 31,
                                "cpu")

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert a == b and a != c
    assert len({s for _, s in a}) == 31 and all(len(s) == 237 for _, s in a)
    assert rows[0] not in a and all(r in rows[1:] for r in a)
    with pytest.raises(ValueError, match="wild type"):
        msa.context_rows(torch.Generator().manual_seed(SEED), wt[::-1], 31,
                         "cpu")


def test_flop_and_byte_counts():
    cfg = cell_config()["msa"]
    D, R, C, Fd = 768, 32, 238, 3072
    T = R * C
    layer = 16 * T * D * D + 4 * T * D * Fd
    row, col = 4 * R * C * C * D, 4 * C * R * R * D
    head = 2 * 237 * 33 * D + 2 * 237 * D * D + 2 * 237 * D * 33
    assert msa.forward_flops(cfg, 237) == 12 * (layer + row + col) + head
    total = msa.forward_flops(cfg, 237)
    assert total == pytest.approx(1.80e12, rel=0.01)
    assert 12 * row / total == pytest.approx(0.037, abs=0.001)
    assert 12 * col / total == pytest.approx(0.005, abs=0.001)
    b, ops = msa.row_attention_bytes_ops(1, cfg, 237, False)
    assert b == 4 * T * D * 2 == pytest.approx(46.8e6, rel=0.001)
    assert ops == 4 * 12 * C * C * R * 64
    b, ops = msa.row_attention_bytes_ops(2, cfg, 237, True)
    assert (b, ops) == (7 * 2 * T * D * 2, 10 * 2 * 12 * C * C * R * 64)


def test_the_weights_are_the_programs_layout():
    """``msa_leaves`` lists the program's leaves in its native checkpoint's
    order (the program validates each shape when it loads the file)."""
    from ppde_tpu_torch.models import esm2 as port_esm2
    from ppde_tpu_torch.models import msa_transformer as msat

    for name in ("msa-1b", "msa-S", "msa-tiny"):
        c = msat.CONFIGS[name]
        cfg = {"layers": c["layers"], "embed_dim": c["dim"],
               "ffn_embed_dim": c["ffn"], "max_positions": c["max_pos"],
               "vocab": 33}
        want = [tuple(s) for s in port_esm2._flatten(msat._shapes(name))]
        assert [s for _, s in msa.msa_leaves(cfg)] == want


def _readers_run(fwd, bwd, t_dev, c_dev):
    cfg = cell_config()
    return {"config": cfg, "chains": 128, "L": 237, "energy_calls": 10,
            "launches": {"kernel_t": fwd, "kernel_t_bwd": bwd,
                         "kernel_c": fwd, "kernel_c_bwd": bwd},
            "trace": {"device_s": {"kernel_t": t_dev[0],
                                   "kernel_t_bwd": t_dev[1],
                                   "kernel_c": c_dev[0],
                                   "kernel_c_bwd": c_dev[1]}}}


def test_roofline_readers():
    """Each roofline is the calls' least time over their device time;
    pieces of chains do not change it, nothing to read gives None."""
    row = harness.reader("row_attention_roofline")
    col = harness.reader("column_attention_roofline")
    cfg = cell_config()["msa"]
    chains, calls = 128 * 10, 12 * 10  # one piece a call
    b, ops = msa.row_attention_bytes_ops(chains / 10, cfg, 237, False)
    bb, bops = msa.row_attention_bytes_ops(chains / 10, cfg, 237, True)
    least_t = calls * (max(b / 3.35e12, ops / 989e12)
                       + max(bb / 3.35e12, bops / 989e12))
    run = _readers_run(calls, calls, (0.5, 1.5), (0.3, 0.7))
    assert row(run) == pytest.approx(100 * least_t / 2.0)
    z = 128 * 238 * 12
    least_c = calls * (4 * z * 32 * 64 * 2 + 7 * z * 32 * 64 * 2) / 3.35e12
    assert col(run) == pytest.approx(100 * least_c / 1.0)
    five = _readers_run(5 * calls, 5 * calls, (0.5, 1.5), (0.3, 0.7))
    assert row(five) == pytest.approx(row(run))
    assert col(five) == pytest.approx(col(run))
    assert row(dict(run, trace=None)) is None
    assert col(dict(run, config=dict(run["config"], msa=None))) is None
    assert row(_readers_run(0, 0, (0.5, 1.5), (0.3, 0.7))) is None


@pytest.fixture
def tiny_spec():
    spec = harness.find_cell(CELL)
    spec["config"]["msa"] = dict(spec["config"]["msa"], **TINY)
    spec["traffic"] = dict(spec["traffic"], n_chains=4, warm_steps=2)
    return spec


def test_the_cell_at_a_tiny_width_on_the_cpu(tiny_spec, tmp_path):
    """The cell's files, CLI term and reference at msa-tiny's widths and 4
    rows over GFP, 4 chains, the program in bf16 on the CPU: its energy,
    fitness and gradient gaps lie inside the cell's limits and far below the
    float8 control's at the same states. (``correct`` as a whole is not
    asked: a window of a few steps over 4 chains can accept every proposal,
    which ``check_run`` refuses.)"""
    out = harness.run("tiny", tiny_spec, SEED, 0.3, False,
                      torch.device("cpu"), time.perf_counter(),
                      readings="control", log=lambda m: None)
    prog, ctrl = out["readings"]["program"], out["readings"]["control"]
    for g in ("energy_gap", "fit_gap", "grad_gap", "grad_gap_p95"):
        assert prog[g] <= tiny_spec["limits"][g], (g, prog)
    for g in ("energy_gap", "grad_gap"):
        assert ctrl[g] > 3 * prog[g], (g, prog, ctrl)
    assert out["attempted"] > 0 and out["failed"] == 0
    paths = proteins.write(str(tmp_path), "GFP", tiny_spec["config"],
                           tiny_spec["traffic"], SEED, "cpu")
    files = paths["experts"]["msa"]
    assert set(files) == {msa.CONTEXT, msa.FILE}
    rows = msa.read_fasta(files[msa.CONTEXT])
    assert len(rows) == 3 and all(len(s) == 237 for _, s in rows)


def test_the_reference_reads_the_programs_files(tiny_spec, tmp_path):
    """The reference term at the program's own weights and context (the
    program in float32 on the CPU): the same scores, to the float32 sums'
    order."""
    from ppde_tpu_torch.models import msa_transformer as msat

    cfg = tiny_spec["config"]
    paths = proteins.write(str(tmp_path), "GFP", cfg, tiny_spec["traffic"],
                           SEED, "cpu")
    files = paths["experts"]["msa"]
    ctx = [s for _, s in msa.read_fasta(files[msa.CONTEXT])]
    params, apply = msat.load_expert(
        "msa-tiny", paths["wt"], ctx, weights_path=files[msa.FILE],
        dtype=torch.float32, device="cpu")
    score = msa.reference_term(paths["dir"], cfg["msa"], "cpu")
    wt = torch.from_numpy(reference.onehot(paths["wt"]))[None]
    x = wt.repeat(3, 1, 1)
    x[1, 10] = x[2, 200] = torch.eye(20)[4]
    with torch.no_grad():
        got = apply(params, x)
        want = score(x, lambda t: t) - score(wt, lambda t: t)
    assert float((got - want).abs().max()) <= 2e-5 * max(
        1.0, float(want.abs().max()))
    assert math.isfinite(float(want.sum()))
    assert abs(float(got[0])) <= 1e-5 * float(want.abs().max())
