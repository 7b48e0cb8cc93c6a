"""The port's sweep drivers and MNIST summariser against the JAX package's.

``ppde_tpu_torch/scripts/{sweep_dcn,run_cells,summarize_mnist_runs}.py``
mirror ``tests/test_sweep_dcn.py`` and ``tests/test_cli.py``'s run_cells
tests: the grids and specs equal the JAX ones cell for cell (the module
path apart), the partition is a disjoint cover, the host comes from the
same flags and environment, family artifacts are discovered alike (fake
checkpoints under ``tmp_path`` and the tracked ``results/esm_family/``
scorers), run_cells runs a mixed protein + MNIST grid in one process on
seeded stand-ins and skips it when done; the summariser's rows on a seeded
MNIST run's artifacts equal the JAX summariser's (the EBM log-probability,
printed to 0.1, within 0.1: float32 sums in another order)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scripts import run_cells as jrun_cells, sweep_dcn as jsweep
from ppde_tpu_torch.scripts import (directed_evolution as de, mnist_sum,
                                    run_cells, seeded_mnist, seeded_protein,
                                    summarize_mnist_runs, sweep_dcn)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UBE4B = "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio"
GFP = "GFP_AEQVI_Sarkisyan2016"


def test_grid_is_deterministic_and_equals_jax():
    a = sweep_dcn.build_grid([1, 2], 100, 10)
    assert a == sweep_dcn.build_grid([1, 2], 100, 10)
    # 3 proteins x 7 samplers (incl. beyond-reference PPDE-PT) x 2 seeds
    assert len(a) == 3 * 7 * 2 and len({c["name"] for c in a}) == len(a)
    assert a == jsweep.build_grid([1, 2], 100, 10)
    kw = dict(esm_weights="/x.pt", experts=("potts", "transformer-M"))
    assert sweep_dcn.build_grid([3], 50, 5, **kw) == \
        jsweep.build_grid([3], 50, 5, **kw)
    assert sweep_dcn.LAMBDA == jsweep.LAMBDA
    assert sweep_dcn.PROTEINS == jsweep.PROTEINS


def test_partition_is_disjoint_cover():
    cells = sweep_dcn.build_grid([1, 2, 3], 100, 10)
    for num_hosts in (1, 2, 3, 5, 8, len(cells) + 3):
        shards = [sweep_dcn.partition(cells, h, num_hosts)
                  for h in range(num_hosts)]
        names = [c["name"] for s in shards for c in s]
        assert sorted(names) == sorted(c["name"] for c in cells)
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1
        assert shards == [jsweep.partition(cells, h, num_hosts)
                          for h in range(num_hosts)]


def test_transformer_cells_gated_on_weights():
    no_w = sweep_dcn.build_grid([1], 100, 10,
                                experts=("potts", "transformer-M"))
    with_w = sweep_dcn.build_grid([1], 100, 10, esm_weights="/x.pt",
                                  experts=("potts", "transformer-M"))
    assert len(with_w) == 2 * len(no_w)
    assert any("--esm_weights" in c["argv"] for c in with_w)


def test_detect_host_env(monkeypatch):
    """The same flags and launcher variables as the JAX driver, in the
    same order."""
    for var in ("JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "SLURM_PROCID",
                "SLURM_NTASKS", "TPU_WORKER_ID", "TPU_WORKER_COUNT"):
        monkeypatch.delenv(var, raising=False)
    ns = sweep_dcn.argparse.Namespace(host_id=None, num_hosts=None)
    assert sweep_dcn.detect_host(ns) == (0, 1)
    monkeypatch.setenv("TPU_WORKER_ID", "5")
    monkeypatch.setenv("TPU_WORKER_COUNT", "6")
    assert sweep_dcn.detect_host(ns) == (5, 6)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "16")
    assert sweep_dcn.detect_host(ns) == (3, 16) == jsweep.detect_host(ns)
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    assert sweep_dcn.detect_host(ns) == (1, 4) == jsweep.detect_host(ns)
    ns2 = sweep_dcn.argparse.Namespace(host_id=2, num_hosts=8)
    assert sweep_dcn.detect_host(ns2) == (2, 8)


def test_dry_run_cli():
    p = subprocess.run(
        [sys.executable, "-m", "ppde_tpu_torch.scripts.sweep_dcn",
         "--dry_run", "--num_hosts", "4", "--host_id", "1",
         "--family_root", ""],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "host 1/4" in p.stdout
    # 21 cells (3 proteins x 7 samplers) over 4 hosts -> 5 or 6 per host
    assert "of 21 cells" in p.stdout


def _fake_family_root(tmp_path, prots, scorer_for=()):
    root = tmp_path / "fam"
    root.mkdir()
    for prot in prots:
        (root / f"{prot}_transformer-S_ckpt_4000.npz").write_bytes(b"x")
        (root / f"{prot}_transformer-S_ckpt_2000.npz").write_bytes(b"x")
        if prot in scorer_for:
            (root / f"{prot}_msat_S_ckpt_2000.npz").write_bytes(b"x")
    for stray in (f"{UBE4B}_transformer-S_ckpt_final.npz",
                  f"{UBE4B}_transformer-S_ckpt_4000_best.npz",
                  f"{UBE4B}_msat_S_ckpt_best.npz"):
        (root / stray).write_bytes(b"x")
    return str(root)


def test_family_cells_discovered_and_gridded(tmp_path):
    """Family-expert cells join the grid as in the JAX driver: two PPDE
    cells per protein with a checkpoint (the highest integer step; stray
    suffixes ignored), density scoring wired where a scorer and a family
    MSA exist; '_' run signatures; the same cells as the JAX grid. The
    tracked ``results/esm_family/`` scorers are found by short name."""
    root = _fake_family_root(tmp_path, [UBE4B, GFP], scorer_for=[GFP])
    fam = sweep_dcn.discover_family(root, sweep_dcn.PROTEINS)
    assert fam == jsweep.discover_family(root, jsweep.PROTEINS)
    assert set(fam) == {UBE4B, GFP}
    assert fam[UBE4B]["ckpt"].endswith("_ckpt_4000.npz")
    assert fam[GFP]["scorer"].endswith("_msat_S_ckpt_2000.npz")
    assert fam[GFP]["msa"].endswith(f"synthetic/{GFP}_synth.a2m")

    base = sweep_dcn.build_grid([1], 100, 10)
    cells = sweep_dcn.build_grid([1], 100, 10, family=fam)
    assert cells == jsweep.build_grid([1], 100, 10, family=fam)
    extra = [c for c in cells if "/family/" in c["name"]]
    assert len(cells) == len(base) + len(extra) and len(extra) == 4
    by_name = {c["name"]: c["argv"] for c in extra}
    assert "--msa_transformer_weights" in by_name[
        f"{GFP}/family/transformer-S/s1"]
    sigs = {a[a.index("--run_signature") + 1] for a in by_name.values()}
    assert sigs == {"potts_transformer-S_family", "transformer-S_family"}
    shards = [sweep_dcn.partition(cells, h, 3) for h in range(3)]
    assert sorted(c["name"] for s in shards for c in s) == sorted(
        c["name"] for c in cells)

    tracked = os.path.join(REPO, "results", "esm_family")
    got = sweep_dcn.discover_family(tracked, sweep_dcn.PROTEINS)
    assert got == jsweep.discover_family(tracked, jsweep.PROTEINS)


def test_specs_equal_the_jax_specs():
    """Every built-in spec of run_cells, cell for cell, and the lambdas
    single-sourced from sweep_dcn.LAMBDA."""
    for name in ("r4_evidence_spec", "r4_mnist_extras_spec",
                 "r5_family_spec", "r5_scalematch_spec",
                 "r5_baseline_seeds_spec", "r5_mnist_cmaes_spec"):
        assert getattr(run_cells, name)() == getattr(jrun_cells, name)(), \
            name
    assert run_cells.r5_family_spec(2500) == jrun_cells.r5_family_spec(2500)
    for prot in run_cells.PROTEINS:
        assert float(run_cells.LAMBDA_POTTS[prot]) == sweep_dcn.LAMBDA[
            (prot, "potts")]
    assert (run_cells.SUM, run_cells.STOP_FILE, run_cells.SEEDS) == (
        jrun_cells.SUM, jrun_cells.STOP_FILE, jrun_cells.SEEDS)


def test_r4_evidence_spec_parses():
    """Every cell of the round-4 evidence grid parses under the port's CLI
    parser, carries a summary_json matching its name, and is unique: 3
    proteins x (4 exact + 4 refrev seeds + SA/Random/MALA + CMAES + 2
    ablations + PT) = 45."""
    cells = run_cells.r4_evidence_spec()
    assert len(cells) == 45 and len({c["name"] for c in cells}) == 45
    parser = de.build_parser()
    for c in cells:
        ns = parser.parse_args(c["argv"])
        assert ns.summary_json.endswith(c["name"] + ".json")
        assert ns.disable_MSA_transformer_scoring and ns.n_chains == 128


def test_r4_mnist_extras_spec_parses():
    """Every cell of the round-4 MNIST extras grid parses under the port's
    MNIST parser, routes through module 'mnist', and names the done_file
    the MNIST CLI writes: 16 cells."""
    cells = run_cells.r4_mnist_extras_spec()
    assert len(cells) == 16 and len({c["name"] for c in cells}) == 16
    parser = mnist_sum.build_parser()
    abbrv = {"PPDE": "PPDE-PAS-10", "simulated_annealing": "SA",
             "MALA-approx": "MALA-approx", "CMAES": "CMAES"}
    for c in cells:
        assert c["module"] == "mnist"
        ns = parser.parse_args(c["argv"])
        expect = f"{abbrv[ns.sampler]}_{ns.energy_function}_{ns.suffix}"
        assert c["name"] == expect
        assert c["done_file"] == (
            f"results/mnist/{expect}_final_population.npy")


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("seeded")
    seeded_protein.write_protein_dir(str(root / "p"), "TOY",
                                     "MKTAYIAKQRQISFVKSHFS", seed=1)
    return {"protein_weights": str(root / "p"),
            "mnist_weights": seeded_mnist.write_weights_dir(
                str(root / "w"), seed=1),
            "mnist_data": seeded_mnist.write_data_dir(str(root / "d"),
                                                      seed=1)}


def test_run_cells_executes_mixed_grid_and_skips_done(seeded, tmp_path,
                                                      capsys):
    """A mixed protein + MNIST spec runs both cells in one process (the
    port's CLIs, --device cpu), then a re-run skips them (summary_json for
    the protein cell, done_file for the MNIST one)."""
    de_summary = tmp_path / "de_summary.json"
    mnist_done = tmp_path / "PPDE-PAS-2_supervised_t_final_population.npy"
    spec = [
        {"name": "de_tiny", "argv": [
            "--protein", "TOY", "--protein_weights",
            seeded["protein_weights"], "--results_path", str(tmp_path),
            "--n_iters", "6", "--n_chains", "4", "--log_every", "3",
            "--nmut_threshold", "10", "--energy_lamda", "0.5",
            "--disable_MSA_transformer_scoring", "--run_signature", "t",
            "--summary_json", str(de_summary), "--device", "cpu"]},
        {"name": "PPDE-PAS-2_supervised_t", "module": "mnist",
         "done_file": str(mnist_done), "argv": [
            "--mnist_weights", seeded["mnist_weights"],
            "--data_dir", seeded["mnist_data"],
            "--results_path", str(tmp_path),
            "--sampler", "PPDE", "--energy_function", "supervised",
            "--n_iters", "4", "--n_chains", "4", "--log_every", "2",
            "--ppde_pas_length", "2", "--wild_type", "0",
            "--suffix", "t", "--metrics", "viz", "--device", "cpu"]},
    ]
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    run_cells.main(["--spec", str(spec_path)])
    assert json.loads(de_summary.read_text())["diversity_pct"] >= 0
    assert mnist_done.exists()
    assert "done=2 skipped=0 failed=0" in capsys.readouterr().out
    run_cells.main(["--spec", str(spec_path)])  # idempotent re-run
    assert "done=0 skipped=2 failed=0" in capsys.readouterr().out


def test_run_cells_write_placeholders_skips_summaryless_cells(tmp_path,
                                                              capsys):
    """--write_placeholders skips done_file / MNIST cells and cells with no
    --summary_json, and creates missing parent directories."""
    deep = tmp_path / "not" / "yet" / "made" / "cell.json"
    spec = [
        {"name": "mnist_cell", "module": "mnist",
         "done_file": str(tmp_path / "nope.npy"), "argv": ["--n_iters", "4"]},
        {"name": "no_summary_de", "argv": ["--n_iters", "4"]},
        {"name": "deep_de", "argv": ["--summary_json", str(deep)]},
    ]
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    run_cells.main(["--spec", str(spec_path), "--write_placeholders"])
    out = capsys.readouterr().out
    assert "wrote 1 placeholders (2 cells have no summary path)" in out
    assert deep.read_text() == "{}"
    cells = [{"name": "a", "argv": ["--summary_json", str(deep)],
              "expect": {"n_iters": 5}}]
    assert run_cells.summary_state(cells[0]) == "placeholder" == \
        jrun_cells.summary_state(cells[0])
    deep.write_text(json.dumps({"n_iters": 4}))
    assert run_cells.summary_state(cells[0]) == "stale"
    deep.write_text(json.dumps({"n_iters": 5}))
    assert run_cells.summary_state(cells[0]) == "done"


def test_summarize_mnist_runs_matches_jax(seeded, tmp_path):
    """Two seeded MNIST runs' artifacts summarised by both packages: the
    same rows (diversity, ink, the oracle CSV's quantiles); the EBM
    log-probability of the final population within 0.1."""
    for sampler, sfx in (("PPDE", "sa"), ("simulated_annealing", "sb")):
        mnist_sum.main(mnist_sum.build_parser().parse_args([
            "--mnist_weights", seeded["mnist_weights"],
            "--data_dir", seeded["mnist_data"],
            "--results_path", str(tmp_path), "--sampler", sampler,
            "--n_iters", "4", "--n_chains", "6", "--log_every", "2",
            "--ppde_pas_length", "2", "--suffix", sfx, "--metrics", "csv+viz",
            "--device", "cpu"]))
    argv = ["--runs_glob", str(tmp_path / "*_s?"), "--score_ebm",
            "--mnist_weights", seeded["mnist_weights"],
            "--data_dir", seeded["mnist_data"]]
    ours = summarize_mnist_runs.main(
        summarize_mnist_runs.build_parser().parse_args(
            argv + ["--device", "cpu", "--out_json",
                    str(tmp_path / "ours.json")]))
    assert len(ours) == 2
    assert json.loads((tmp_path / "ours.json").read_text()) == ours
    jax_out = tmp_path / "jax.json"
    p = subprocess.run(
        [sys.executable, os.path.join("scripts", "summarize_mnist_runs.py"),
         *argv, "--out_json", str(jax_out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    theirs = json.loads(jax_out.read_text())
    for a, b in zip(ours, theirs):
        for k in ("ebm_logp_mean", "ebm_logp_std"):
            assert abs(a.pop(k) - b.pop(k)) <= 0.1 + 1e-9
        assert a == b
    assert np.isfinite([r["ink_fraction"] for r in ours]).all()
