"""The port's CLI (ppde_tpu_torch/scripts/directed_evolution.py) against the
JAX package's (scripts/directed_evolution.py): the flag surface, the
artifact contract of tests/test_cli.py:80 for each of the six samplers, the
printed wild-type energy, what the port refuses, and ``--checkpoint_dir``
(a cut run resumed writes the uncut run's artifacts). Runs on the CPU
(``--device cpu``) on a seeded protein directory (L = 20, 4-8 chains, a few
steps); the WT energies printed by the two CLIs agree to 1e-3 (the "%.3f"
they print)."""
import importlib
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from ppde_tpu import runtime as jruntime
from ppde_tpu_torch.scripts import directed_evolution as de
from ppde_tpu_torch.scripts import seeded_protein

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WT = "MKTAYIAKQRQISFVKSHFS"  # 20 residues
PROTEIN = "TOY_PROTEIN"
ARTIFACTS = ["config.txt", "population.npy", "pred_fitness_scores.npy",
             "oracle_fitness_scores.npy", "potts_scores.npy",
             "energy_scores.npy", "energy_history.npy",
             "fitness_history.npy", "summary.json"]


def _jax_cli():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    return importlib.import_module("directed_evolution")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("weights"))
    seeded_protein.write_protein_dir(root, PROTEIN, WT, seed=1)
    return root


def _argv(root, results, *extra):
    return ["--protein_weights", root, "--protein", PROTEIN,
            "--results_path", str(results), "--n_iters", "6",
            "--n_chains", "8", "--log_every", "3", "--nmut_threshold", "4",
            "--disable_MSA_transformer_scoring", "--run_signature", "test",
            *extra]


def _main(argv):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return de.main(de.build_parser().parse_args(argv))


def test_parser_defaults_match_jax():
    """Every flag of the JAX CLI, with its default; --device defaults to
    cuda in the port (it is honoured there); the MSA Transformer expert's
    weights, context and rows are the port's own flags, and it takes
    --allow_random_esm and --esm_chunk (also spelt --allow_random_msa and
    --msa_expert_chunk)."""
    ours = vars(de.build_parser().parse_args([]))
    theirs = vars(_jax_cli().build_parser().parse_args([]))
    assert {k: ours.pop(k) for k in (
        "msa_expert_weights", "msa_expert_context", "msa_expert_rows")} == {
        "msa_expert_weights": None, "msa_expert_context": None,
        "msa_expert_rows": 32}
    spelt = vars(de.build_parser().parse_args(
        ["--allow_random_msa", "--msa_expert_chunk", "8"]))
    assert (spelt["allow_random_esm"], spelt["esm_chunk"]) == (True, 8)
    assert ours.keys() == theirs.keys()
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
    assert ours == theirs
    # the reference defaults (scripts/directed_evolution.py:113-165)
    assert (ours["seed"], ours["n_chains"], ours["n_iters"]) == (
        1234567, 128, 10000)
    assert ours["compute_dtype"] == "f32" and ours["sampler"] == "PPDE"


@pytest.mark.parametrize("sampler,extra,n_hist", [
    ("PPDE", (), 7),
    ("PPDE-PT", ("--pt_levels", "4", "--pt_beta_min", "0.3"), 7),
    ("simulated_annealing", (), 7),
    ("Random", (), 7),
    ("MALA-approx", (), 7),
    ("CMAES", ("--cmaes_population_size", "8"), 3),
])
def test_each_sampler_writes_the_artifact_set(root, tmp_path, sampler, extra,
                                              n_hist):
    run_dir = _main(_argv(root, tmp_path, "--device", "cpu", "--sampler",
                          sampler, *extra))
    assert run_dir.parent == tmp_path / PROTEIN
    assert re.fullmatch(rf"{sampler}_test_1234567_\d{{4}}-\d\d-\d\d_"
                        r"\d\d-\d\d-\d\d", run_dir.name)
    assert sorted(os.listdir(run_dir)) == sorted(ARTIFACTS)
    cfg = json.loads((run_dir / "config.txt").read_text())
    assert cfg["n_iters"] == 6 and cfg["sampler"] == sampler
    pop = np.load(run_dir / "population.npy")
    assert pop.shape == (8, len(WT), 20)
    np.testing.assert_allclose(pop.sum(-1), 1.0, atol=1e-6)
    for name in ("pred_fitness_scores", "oracle_fitness_scores",
                 "potts_scores", "energy_scores"):
        a = np.load(run_dir / f"{name}.npy")
        assert a.shape == (8,) and np.isfinite(a).all(), name
    for name in ("energy_history", "fitness_history"):
        assert np.load(run_dir / f"{name}.npy").shape == (n_hist, 8)
    s = json.loads((run_dir / "summary.json").read_text())
    for k in ("diversity_pct", "exploration_mean", "oracle_logfit",
              "potts_provenance", "steps_per_sec", "reference_reverse"):
        assert k in s, k
    assert s["potts_provenance"] == "synthetic"
    assert s["oracle_logfit"]["p50"] <= s["oracle_logfit"]["p100"]


def test_wt_energy_line_matches_jax_cli(root, tmp_path, capsys, monkeypatch):
    """One tiny PPDE run of each CLI on the same directory: the same
    printed WT energy, and the same artifact names and shapes."""
    jde = _jax_cli()
    monkeypatch.setattr(jruntime, "enable_compile_cache", lambda: None)
    monkeypatch.chdir(tmp_path)
    argv = _argv(root, tmp_path / "jax", "--n_chains", "4",
                 "--summary_json", str(tmp_path / "s" / "jax.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jdir = jde.main(jde.build_parser().parse_args(argv))
    jout = capsys.readouterr().out
    argv = _argv(root, tmp_path / "port", "--n_chains", "4", "--device",
                 "cpu", "--summary_json", str(tmp_path / "s" / "port.json"))
    tdir = _main(argv)
    tout = capsys.readouterr().out

    def wt_energy(out):
        return float(re.search(r"WT protein energy: (\S+)", out).group(1))

    assert wt_energy(tout) == pytest.approx(wt_energy(jout), abs=1.5e-3)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in ARTIFACTS[1:-1]:
        assert np.load(tdir / f).shape == np.load(jdir / f).shape, f
    for out in (tout, jout):
        for line in ("energy quantiles", "oracle quantiles",
                     "potts quantiles", "sampler throughput", "done"):
            assert line in out
    assert (json.loads((tmp_path / "s" / "port.json").read_text()).keys()
            == json.loads((tmp_path / "s" / "jax.json").read_text()).keys())


def _scoring_argv(root, tmp_path, *extra):
    """The CLI with MSA-Transformer scoring on, over a 6-row alignment of
    the 20-residue wild type."""
    a2m = tmp_path / "toy.a2m"
    rows = [WT, WT[::-1], WT[5:] + WT[:5], WT.replace("K", "R"),
            WT.replace("S", "-"), WT[::2] + WT[1::2]]
    a2m.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(rows)))
    return [a for a in _argv(root, tmp_path / "res", "--device", "cpu",
                             "--n_iters", "2", "--msa_path", str(a2m),
                             "--msa_size", "4", *extra)
            if a != "--disable_MSA_transformer_scoring"]


def test_msa_scoring_is_skipped_and_named(root, tmp_path, capsys):
    """Without weights the run prints the JAX CLI's [skip] line with
    msa_transformer.load's FileNotFoundError and writes no scores."""
    from ppde_tpu_torch.models import msa_transformer

    run_dir = _main(_scoring_argv(root, tmp_path))
    out = capsys.readouterr().out
    with pytest.raises(FileNotFoundError) as e:
        msa_transformer.load(None, device="cpu")
    assert f"[skip] MSA-Transformer scoring unavailable: {e.value}\n" in out
    assert sorted(os.listdir(run_dir)) == sorted(ARTIFACTS)
    summary = json.loads((run_dir / "summary.json").read_text())
    assert "evolutionary_density" not in summary


def test_msa_scoring_writes_transformer_scores(root, tmp_path, capsys):
    """With an msa-tiny checkpoint (the JAX package's training.save_ckpt of
    float32 weights, as its trainer writes them)
    the run scores its best population: the quantile line,
    transformer_scores.npy, and the density keys in summary.json."""
    import jax
    import jax.numpy as jnp

    from ppde_tpu import training
    from ppde_tpu.models import msa_transformer as jmsat

    ck = str(tmp_path / "msat.npz")
    training.save_ckpt(ck, jmsat.init(jax.random.PRNGKey(0), jnp.float32,
                                      name="msa-tiny"), 0)
    run_dir = _main(_scoring_argv(root, tmp_path, "--msa_transformer_weights",
                                  ck, "--msa_transformer_model", "msa-tiny"))
    out = capsys.readouterr().out
    assert "MSATransformer quantiles: [" in out and "[skip]" not in out
    assert sorted(os.listdir(run_dir)) == sorted(
        ARTIFACTS + ["transformer_scores.npy"])
    scores = np.load(run_dir / "transformer_scores.npy")
    assert scores.shape == (8,) and np.isfinite(scores).all()
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["evolutionary_density"] == jruntime._q(scores)
    assert summary["msa_transformer_model"] == "msa-tiny"
    assert summary["msa_transformer_weights"] == ck


@pytest.mark.parametrize("extra,match", [
    (("--mesh_dp", "2"), "torchrun"),
    (("--mesh_tp", "2"), "torchrun"),
    (("--mesh_ep", "3"), "torchrun"),
    (("--mesh_sp", "2"), "torchrun"),
])
def test_unported_flags_are_refused(root, tmp_path, monkeypatch, extra,
                                    match):
    """A mesh run started without a launcher raises, naming torchrun,
    before it writes anything."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match=match):
        _main(_argv(root, tmp_path, "--device", "cpu", *extra))
    assert not (tmp_path / PROTEIN).exists()


def _torchrun(nproc, module, argv, timeout=300):
    """``torchrun --standalone --nproc-per-node nproc -m module argv``
    (a free port on localhost), one thread a rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


def _run_dir(results):
    (d,) = (results / PROTEIN).iterdir()
    return d


@pytest.mark.parametrize("sampler,extra,mesh", [
    ("PPDE", (), ("--mesh_dp", "2")),
    ("PPDE-PT", ("--pt_levels", "4"), ("--mesh_dp", "1", "--mesh_tp", "2")),
    ("MALA-approx", (), ("--mesh_dp", "2")),
])
def test_two_gloo_ranks_give_the_single_device_run(root, tmp_path, sampler,
                                                   extra, mesh):
    """The CLI launched on 2 CPU ranks (gloo) over dp or tp writes the
    single-device run's population (equal), energies (2e-5) and summary;
    rank 0 alone prints and writes."""
    _main(_argv(root, tmp_path / "one", "--device", "cpu", "--sampler",
                sampler, *extra))
    one = _run_dir(tmp_path / "one")
    out = _torchrun(2, "ppde_tpu_torch.scripts.directed_evolution",
                    _argv(root, tmp_path / "two", "--device", "cpu",
                          "--sampler", sampler, *extra, *mesh))
    assert out.returncode == 0, out.stderr[-3000:]
    two = _run_dir(tmp_path / "two")
    shape = {"dp": 2, "ep": 1, "tp": 1, "sp": 1, "pp": 1}
    if "--mesh_tp" in mesh:
        shape.update(dp=1, tp=2)
    assert out.stdout.count(f"mesh: {shape}") == 1
    assert out.stdout.count("WT protein energy") == 1
    assert out.stdout.count("done") == 1
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    np.testing.assert_array_equal(np.load(two / "population.npy"),
                                  np.load(one / "population.npy"))
    for name in ("energy_scores.npy", "energy_history.npy",
                 "oracle_fitness_scores.npy"):
        np.testing.assert_allclose(np.load(two / name), np.load(one / name),
                                   rtol=2e-5, atol=2e-5)
    s1, s2 = (json.loads((d / "summary.json").read_text())
              for d in (one, two))
    for s in (s1, s2):
        for k in ("run_dir", "steps_per_sec", "wall_steps_per_sec"):
            s.pop(k)
    assert s1 == s2


def test_mesh_size_other_than_the_world_raises(root, tmp_path):
    """--mesh_dp 3 on 2 ranks raises, naming both sizes."""
    out = _torchrun(2, "ppde_tpu_torch.scripts.directed_evolution",
                    _argv(root, tmp_path, "--device", "cpu", "--mesh_dp",
                          "3"))
    assert out.returncode != 0
    assert "mesh size 3 (dp=3, ep=1, tp=1, sp=1, pp=1) differs from the " \
        "world size 2" in out.stderr


@pytest.mark.parametrize("sampler,extra", [
    ("PPDE", ()), ("PPDE-PT", ("--pt_levels", "4")),
    ("simulated_annealing", ()), ("Random", ()), ("MALA-approx", ()),
    ("CMAES", ("--cmaes_population_size", "8")),
])
def test_checkpoint_dir_resumes_bit_exact(root, tmp_path, capsys, sampler,
                                          extra):
    """--checkpoint_dir: a run cut after 3 of 6 steps (generations) and
    resumed writes the uncut run's artifacts bit for bit."""
    def run(results, n, *ck):
        argv = _argv(root, tmp_path / results, "--device", "cpu",
                     "--sampler", sampler, *extra, *ck)
        argv[argv.index("--n_iters") + 1] = str(n)
        return _main(argv)
    ref = run("ref", 6)
    ck = ("--checkpoint_dir", str(tmp_path / "ck"))
    run("cut", 3, *ck)
    capsys.readouterr()
    got = run("resumed", 6, *ck)
    assert "[resume]" in capsys.readouterr().out
    for f in ARTIFACTS[1:-1]:
        np.testing.assert_array_equal(np.load(got / f), np.load(ref / f),
                                      err_msg=f)


def test_unknown_sampler_is_refused(root, tmp_path):
    with pytest.raises(ValueError, match="unknown sampler"):
        _main(_argv(root, tmp_path, "--device", "cpu", "--sampler", "Gibbs"))


def test_default_device_needs_a_gpu(root, tmp_path):
    """Without --device cpu the CLI runs on CUDA or raises: no silent CPU
    run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(_argv(root, tmp_path))
    assert not (tmp_path / PROTEIN).exists()


def test_module_entry_points(root, tmp_path):
    """``python -m`` runs both entry points: the seeded directory writer
    and the CLI (one PPDE run on the CPU)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "ppde_tpu_torch.scripts.seeded_protein",
         "--out", str(tmp_path / "w"), "--protein", "P", "--wt_seq", WT],
        capture_output=True, text=True, env=env, cwd=tmp_path, check=True)
    assert out.stdout.strip() == str(tmp_path / "w" / "P")
    argv = _argv(str(tmp_path / "w"), tmp_path / "res", "--device", "cpu",
                 "--n_iters", "2", "--n_chains", "2")
    argv[argv.index("--protein") + 1] = "P"
    out = subprocess.run(
        [sys.executable, "-m", "ppde_tpu_torch.scripts.directed_evolution",
         *argv], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "WT protein energy" in out.stdout and out.stdout.endswith("done\n")
    (run_dir,) = (tmp_path / "res" / "P").iterdir()
    assert sorted(os.listdir(run_dir)) == sorted(ARTIFACTS)
