"""The port's benchmark (ppde_tpu_torch/scripts/bench.py) against the root
bench.py, which measures the JAX package: the flag surface, the GFP energy
it builds against bench_jax's construction (rebuilt here from ppde_tpu),
the MNIST energy against the JAX CLI's build_energy, its timed loop against
ppde.run, the JSON line, and what it refuses. On the CPU (``--device cpu``:
the kernels' plain versions).

Tolerances: float32, sums in another order than XLA's: energies and
gradients within 1e-5 of the largest magnitude. bf16: energies at rtol /
atol 3e-2 and gradients at a cosine above 0.99, the JAX bf16 bound of
test_torch_port_cnn.py::test_bf16_close_to_jax. The random weights of the
CNN ensemble and of ESM2 come from the JAX package's inits (PRNGKey(0), as
bench_jax's), carried over through ``convert``; the Potts draws are numpy
in both packages."""
import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy
from ppde_tpu.models import cnn as jcnn, esm2 as jesm2, potts as jpotts
from ppde_tpu_torch import convert
from ppde_tpu_torch.models import cnn, esm2
from ppde_tpu_torch.samplers.base import Draws
from ppde_tpu_torch.samplers.protein import ppde
from ppde_tpu_torch.scripts import bench, mnist_sum, seeded_mnist

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(layers=2, dim=32, heads=4, ffn=64)
F32_REL = 1e-5
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
CPU = ["--device", "cpu"]


def _root_bench():
    sys.path.insert(0, REPO)
    import bench as root_bench
    return root_bench


def _close_to_largest(a, b, rel):
    b = np.asarray(b, np.float64)
    assert np.abs(np.asarray(a, np.float64) - b).max() <= rel * np.abs(b).max()


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def test_flags_and_defaults_match_root_bench(monkeypatch):
    """Every flag of root bench.py with its default, plus --device (cuda);
    the constants copied from it are its own."""
    jb = _root_bench()

    class Captured(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as got:
        jb.main()
    monkeypatch.undo()
    theirs = {a.dest: a.default for a in got.value.args[0]._actions}
    ours = {a.dest: a.default for a in bench.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert (bench.GFP_WT, bench.N_CHAINS, bench.N_CHAINS_PEAK) == \
        (jb.GFP_WT, jb.N_CHAINS, jb.N_CHAINS_PEAK)


@pytest.fixture
def carried(monkeypatch):
    """The port's inits of the CNN ensemble and of ESM2 return the JAX
    package's PRNGKey(0) weights (what bench_jax draws), so that the
    constructions can be compared; ESM2 "tiny" registered in both."""
    monkeypatch.setitem(jesm2.CONFIGS, "tiny", TINY)
    monkeypatch.setitem(esm2.CONFIGS, "tiny", TINY)

    def init_ensemble(generator, n_members=3, **kw):
        return convert.cnn_ensemble_from_numpy(jax.tree.map(
            np.asarray, jcnn.init_ensemble(jax.random.PRNGKey(0), n_members,
                                           **kw)), generator.device)

    def esm_init(generator, name="transformer-S", dtype=torch.bfloat16,
                 scale=0.02):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        return convert.esm2_from_numpy(jax.tree.map(
            np.asarray, jesm2.init(jax.random.PRNGKey(0), name, jdt)),
            generator.device)

    monkeypatch.setattr(cnn, "init_ensemble", init_ensemble)
    monkeypatch.setattr(esm2, "init", esm_init)


def _jax_gfp_energy(dtype, transformer, esm_name):
    """bench.py's bench_jax construction (its lines 83-107) at 4 chains."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pp = jpotts.synthetic(bench.GFP_WT, seed=0, dtype=jdt)
    ens = jcnn.init_ensemble(jax.random.PRNGKey(0), 3,
                             input_size=len(bench.GFP_WT))
    wt_oh = jnp.asarray(jcodec.seqs_to_onehot([bench.GFP_WT]))
    tr = (jesm2.load_expert(esm_name, bench.GFP_WT, allow_random=True,
                            dtype=jdt) if transformer else None)
    return jenergy.protein_poe(
        pp, ens, lam=1.0 if transformer else 15.0, wt_onehot=wt_oh,
        transformer=tr, chunk_size=16 if transformer else None,
        compute_dtype=jnp.bfloat16 if dtype == "bf16" else None,
        fused_cnn=False, cnn_chunk=None)


def _mutants(n, n_mut=4, seed=0):
    """n one-hot GFP sequences, each n_mut substitutions off the wild type
    (chain 0 included)."""
    rng = np.random.default_rng(seed)
    ints = np.tile(jcodec.seqs_to_ints([bench.GFP_WT]), (n, 1))
    for row in ints:
        pos = rng.choice(len(bench.GFP_WT), n_mut, replace=False)
        row[pos] = (row[pos] + rng.integers(1, 20, n_mut)) % 20
    return jcodec.ints_to_onehot(ints)


@pytest.mark.parametrize("transformer", [False, True],
                         ids=["potts", "potts+tiny"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gfp_energy_matches_bench_jax(carried, dtype, transformer):
    ten = bench.gfp_energy(dtype, 4, transformer, "cpu", esm_name="tiny")
    jen = _jax_gfp_energy(dtype, transformer, "tiny")
    assert ("tr" in ten.params) == transformer
    x = _mutants(4)
    with torch.no_grad():
        e, fit, g = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    ej, fj, gj = (np.asarray(v, np.float32)
                  for v in jen.energy_and_grad(jen.params, jnp.asarray(x)))
    if dtype == "f32":
        for a, b in ((e, ej), (fit, fj), (g, gj)):
            _close_to_largest(a.numpy(), b, F32_REL)
    else:
        np.testing.assert_allclose(e.float().numpy(), ej, **BF16_TOL)
        np.testing.assert_allclose(fit.float().numpy(), fj, **BF16_TOL)
        assert _cosine(g.float().numpy(), gj) > 0.99


def test_transformer_chunk_on_the_cpu_is_one_piece():
    assert bench.transformer_chunk(128, torch.device("cpu")) is None


def test_mnist_energy_matches_jax_build_energy(tmp_path, monkeypatch):
    """The MNIST energy the bench builds (seeded stand-ins, tracked EBM,
    lambda 10) against the JAX CLI's build_energy on the same
    directories."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import mnist_sum as jmnist_sum
    w = seeded_mnist.write_weights_dir(str(tmp_path / "w"))
    d = seeded_mnist.write_data_dir(str(tmp_path / "d"))
    ten = bench.mnist_energy(w, d, "cpu")
    args = argparse.Namespace(
        mnist_weights=w, data_dir=d, energy_function="product_of_experts",
        unsupervised_expert="ebm", energy_lamda=10.0)
    jen = jmnist_sum.build_energy(args)
    a, b = (np.load(os.path.join(d, f)).reshape(bench.MNIST_D)
            for f in mnist_sum.WT_FILES[bench.MNIST_WT])
    rng = np.random.default_rng(0)
    flips = rng.random((4, bench.MNIST_D)) < 0.05
    x1 = np.tile(a, (4, 1)).astype(np.float32)
    x2 = np.where(flips, 1.0 - b, b).astype(np.float32)
    e, fit, g = ten.energy_and_grad(ten.params, torch.from_numpy(x2),
                                    torch.from_numpy(x1))
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x2),
                                     jnp.asarray(x1))
    for p, q in ((e, ej), (fit, fj), (g, gj)):
        _close_to_largest(p.detach().numpy(), q, F32_REL)


def test_timed_loop_is_the_samplers_step():
    """Steps of the bench's timed loop equal ppde.run's from the same
    population and generator seed, bit for bit; so do the untimed and
    timed executions of time_executions, run back to back."""
    en = bench.gfp_energy("f32", 8, False, "cpu")
    pop = en.wt_onehot.repeat(8, 1, 1)
    L = pop.shape[1]
    res = ppde.run(en, pop, 8, 0, L - 1, cfg=bench.PPDE_CFG,
                   generator=torch.Generator().manual_seed(1), log_every=4,
                   quiet=True, device="cpu")
    with torch.no_grad():
        step, ctx, state = bench.protein_setup(en, pop)
        state5, e_trace, acc = bench.timed_loop(
            step, ctx, state, Draws(torch.Generator().manual_seed(1)), 5)
    res5 = ppde.run(en, pop, 5, 0, L - 1, cfg=bench.PPDE_CFG,
                    generator=torch.Generator().manual_seed(1), log_every=5,
                    quiet=True, device="cpu")
    final_x, _, (best_e, _, best_x) = state5
    np.testing.assert_array_equal(final_x.numpy(), res5.final_x)
    np.testing.assert_array_equal(best_e.numpy(), res5.best_energy)
    np.testing.assert_array_equal(best_x.numpy(), res5.best_x)
    np.testing.assert_array_equal(e_trace.numpy(),
                                  res5.energy_history[1:, 0])
    assert int(acc) == int(res5.n_accepted.sum())
    # one untimed execution of 2 steps (warmup 1), then 3 timed ones
    with torch.no_grad():
        step, ctx, state = bench.protein_setup(en, pop)
        state8, timing = bench.time_executions(
            step, ctx, state, Draws(torch.Generator().manual_seed(1)), 2, 1)
    assert timing["warmup_executions"] == 1
    assert len(timing["execution_s"]) == bench.REPS
    np.testing.assert_array_equal(state8[0].numpy(), res.final_x)
    np.testing.assert_array_equal(state8[2][0].numpy(), res.best_energy)
    np.testing.assert_array_equal(timing["chain0_energies"],
                                  res.energy_history[3:, 0])
    assert timing["accepted"] == int(res.n_accepted[2:].sum())


KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
DETAIL_KEYS = ("configs", "headline_n_chains",
               "torch_cpu_reference_steps_per_sec",
               "torch_cpu_reference_chain_steps_per_sec", "dtype", "card",
               "differences")
ROW_KEYS = ("domain", "n_chains", "expert", "sampler_steps_per_sec",
            "chain_steps_per_sec", "execution_s", "launches", "checks")


@pytest.mark.parametrize("baseline", ["skip", "cached", "measured"])
def test_main_prints_one_json_line(capsys, baseline):
    extra = {"skip": ["--skip-torch"], "cached": [],
             "measured": ["--measure-torch"]}[baseline]
    with open(bench.TORCH_BASELINE) as f:
        cached = f.read()
    line = bench.main([*CPU, "--chains", "8", "--steps", "3", "--warmup",
                       "1", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert all(k in line for k in KEYS)
    assert all(k in line["detail"] for k in DETAIL_KEYS)
    assert line["metric"] == "ppde_pas_chain_steps_per_sec_gfp_peak"
    assert line["unit"] == "chain-steps/s"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["detail"]["card"] == "cpu"
    (row,) = line["detail"]["configs"]
    assert all(k in row for k in ROW_KEYS)
    assert (row["domain"], row["n_chains"], row["expert"]) == \
        ("gfp", 8, "potts")
    assert line["value"] == row["chain_steps_per_sec"]
    assert len(row["execution_s"]) == 3 and row["warmup_executions"] == 1
    assert row["launches"] == dict.fromkeys(bench.COUNTERS, 0)
    assert 0 < row["checks"]["acceptance_rate"] < 1
    assert row["fused_cnn"] is False and row["cnn_chunk"] is None
    detail = line["detail"]
    with open(bench.TORCH_BASELINE) as f:  # read, never written
        assert f.read() == cached
    assert detail["torch_cpu_reference_measured"] == (baseline == "measured")
    if baseline == "skip":
        assert line["vs_baseline"] == 0.0
        assert detail["torch_cpu_reference_steps_per_sec"] is None
        return
    ref = json.loads(cached)
    if baseline == "cached":
        assert detail["torch_cpu_reference_steps_per_sec"] == \
            round(ref["torch_cpu_steps_per_sec"], 4)
    ref_cs = detail["torch_cpu_reference_chain_steps_per_sec"]
    assert ref_cs > 0
    assert abs(line["vs_baseline"] - line["value"] / ref_cs) <= 0.01


def test_bench_mnist_steps_and_checks():
    """8 chains x 50 steps: PAS on the EBM accepts about 99.7% of its
    proposals, so the acceptance gate (strictly inside (0, 1)) needs a
    thousand or so to see a rejection; 2 steps give 48."""
    row = bench.bench_mnist(50, 1, n_chains=8, device="cpu")
    assert (row["domain"], row["n_chains"]) == ("mnist", 8)
    assert row["sampler_steps_per_sec"] > 0
    assert row["launches"] == dict.fromkeys(bench.COUNTERS, 0)


def test_bench_torch_transformer_at_full_width():
    """transformer-S at full width and depth, 4 chains, on the CPU."""
    row = bench.bench_torch(2, 1, "bf16", 4, transformer=True, device="cpu")
    assert row["expert"] == "potts+transformer-S"
    assert row["chunk_size"] is None and row["pieces"] == 1
    assert row["sampler_steps_per_sec"] > 0
    assert 0 < row["checks"]["acceptance_rate"] < 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention", [0, 12])
def test_expected_launches_on_the_card(dtype, attention):
    """The launch counts the bench demands of a CUDA run (a device object
    only: nothing runs): A once a call, B once a piece, C and C'
    ``attention`` times a call, the qkv / rotary kernel as often each way,
    the layer-norm kernels ``norms`` times a call each way; at GFP's T =
    237 the key-tiled C and C' take every float32 call and no bf16 one (the
    register kernels take bf16 up to T = 256), B's wide kernel none; none
    at all on the CPU."""
    n, pieces = 7, 2
    norms = 2 * attention + 2 if attention else 0  # ESM2's, one piece
    got = bench.expected_launches(torch.device("cuda"), n, dtype, pieces,
                                  attention, norms)
    f32 = dtype == "f32"
    assert set(got) == set(bench.COUNTERS)
    assert got == {"potts_energy": n, "potts_energy_f32": n * f32,
                   "cnn_ensemble": n * pieces,
                   "cnn_ensemble_f32": n * pieces * f32,
                   "cnn_ensemble_wide": 0, "cnn_ensemble_wide_f32": 0,
                   "flash_attention_fwd": n * attention,
                   "flash_attention_bwd": n * attention,
                   "flash_attention_fwd_kt": n * attention * f32,
                   "flash_attention_bwd_kt": n * attention * f32,
                   "qkv_rotary_fwd": n * attention,
                   "qkv_rotary_bwd": n * attention,
                   "row_attention_fwd": 0, "row_attention_bwd": 0,
                   "layer_norm_fwd": n * norms, "layer_norm_bwd": n * norms}
    assert not any(bench.expected_launches(torch.device("cpu"), n, dtype,
                                           pieces, attention,
                                           norms).values())


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["--chains", "4", "--steps", "1", "--skip-torch"])


NAN_RUN = """
import dataclasses, sys
from ppde_tpu_torch.scripts import bench
real = bench.gfp_energy
def nan_energy(*args, **kw):
    en = real(*args, **kw)
    def energy_and_grad(p, x):
        e, fit, g = en.energy_and_grad(p, x)
        return e * float("nan"), fit, g
    return dataclasses.replace(en, energy_and_grad=energy_and_grad)
bench.gfp_energy = nan_energy
bench.main(sys.argv[1:])
"""


def test_failed_check_exits_nonzero_without_a_line():
    p = subprocess.run(
        [sys.executable, "-c", NAN_RUN, *CPU, "--chains", "4", "--steps",
         "2", "--warmup", "1", "--skip-torch"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "CheckFailed" in p.stderr and "non-finite" in p.stderr
    assert not any(ln.lstrip().startswith("{")
                   for ln in p.stdout.splitlines())
