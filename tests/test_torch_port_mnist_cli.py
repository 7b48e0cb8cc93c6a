"""The port's MNIST-sum CLI (ppde_tpu_torch/scripts/mnist_sum.py) against
the JAX package's (scripts/mnist_sum.py): the flag surface, the artifact set
of each sampler, the initial energies and step-0 oracle on the same seeded
stand-in directories (``scripts/seeded_mnist.py``; within 1e-5 of the
largest magnitude, float32 sums in another order), the CSVs byte for byte
against the JAX package's pandas writer, what the port refuses, and
``--checkpoint_dir``. Runs on the CPU (``--device cpu``) with the tracked
64-channel EBM / DAE, 2-8 chains, a few steps."""
import importlib
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ppde_tpu import metrics as jmetrics, runtime as jruntime
from ppde_tpu_torch import metrics
from ppde_tpu_torch.scripts import mnist_sum, seeded_mnist

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    return importlib.import_module("mnist_sum")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist")
    return (seeded_mnist.write_weights_dir(str(root / "w"), seed=1),
            seeded_mnist.write_data_dir(str(root / "d"), seed=1))


def _argv(dirs, results, *extra):
    return ["--mnist_weights", dirs[0], "--data_dir", dirs[1],
            "--results_path", str(results), "--n_iters", "4",
            "--n_chains", "4", "--log_every", "2", *extra]


def _main(argv):
    return mnist_sum.main(mnist_sum.build_parser().parse_args(argv))


def test_parser_defaults_match_jax():
    """Every flag of the JAX CLI with its default; --device defaults to
    cuda in the port (it is honoured there)."""
    ours = vars(mnist_sum.build_parser().parse_args([]))
    theirs = vars(_jax_cli().build_parser().parse_args([]))
    assert ours.keys() == theirs.keys()
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
    assert ours == theirs
    # the reference defaults (scripts/mnist_sum.py:143-178)
    assert (ours["n_chains"], ours["n_iters"], ours["energy_lamda"],
            ours["log_every"], ours["ppde_pas_length"]) == (128, 200, 10, 50,
                                                            10)
    assert mnist_sum.WT_FILES == _jax_cli().WT_FILES


def test_seeded_directories(dirs):
    """Six wild-type pairs of binary images at 13-19% ones, [1, 28, 28]
    as the seed and held-out digits that data/mnist.py reads, the tracked
    EBM's mean, the regression members and oracle in the reference
    state-dict layout, the two tracked trainer checkpoints."""
    w, d = dirs
    for pair in mnist_sum.WT_FILES.values():
        for f in pair:
            img = np.load(os.path.join(d, f))
            assert img.shape == (1, 28, 28) and set(np.unique(img)) <= {0, 1}
            assert 0.125 <= img.mean() <= 0.195
    np.testing.assert_array_equal(
        np.load(os.path.join(d, "mnist_mean.npy")),
        np.load(os.path.join(REPO, "weights/mnist_models/"
                             "mnist_ebm_ckpt_20000.npz"))["p38"])
    sd = torch.load(os.path.join(w, "ensemble_0_ckpt_25000.pt"))
    assert sorted(sd) == sorted(f"{p}.{k}" for p in ("net.0", "net.2",
                                                     "net.4", "net.6", "out")
                                for k in ("weight", "bias"))
    assert sd["net.0.weight"].shape == (16, 1, 4, 4)
    assert sd["out.weight"].shape == (1, 16)
    assert sorted(os.listdir(w)) == sorted(
        [f"ensemble_{i}_ckpt_25000.pt" for i in range(3)]
        + ["one-hot_GT_ckpt_60000.pt", "mnist_ebm_ckpt_20000.npz",
           "mnist_binary_dae_ckpt_40000.npz"])


def _artifacts(abbrv, gif=True):
    names = [f"{abbrv}_scores.pdf", f"{abbrv}_scores.png",
             f"{abbrv}_final_population.pdf",
             f"{abbrv}_final_population.png",
             f"{abbrv}_final_population.npy", f"{abbrv}_pred_sums.csv",
             f"{abbrv}_oracle_sums.csv"]
    return sorted(names + ([f"{abbrv}.gif"] if gif else []))


@pytest.mark.parametrize("sampler,extra,abbrv", [
    ("PPDE", ("--ppde_pas_length", "2"), "PPDE-PAS-2"),
    ("PPDE", ("--ppde_pas_length", "0", "--ppde_gwg_samples", "2"),
     "PPDE-GWG-2"),
    ("PPDE-PT", ("--ppde_pas_length", "2", "--pt_levels", "2"), "PPDE-PT"),
    ("simulated_annealing", (), "SA"),
    ("MALA-approx", (), "MALA-approx"),
    ("CMAES", ("--cmaes_population_size", "4"), "CMAES"),
])
def test_each_sampler_writes_the_artifact_set(dirs, tmp_path, capsys,
                                              sampler, extra, abbrv):
    res = _main(_argv(dirs, tmp_path, "--device", "cpu", "--sampler",
                      sampler, "--suffix", "t", *extra))
    out = capsys.readouterr().out
    assert "sampler throughput" in out and out.endswith("done\n")
    abbrv += "_product_of_experts_t"
    assert sorted(os.listdir(tmp_path)) == _artifacts(
        abbrv, gif=sampler != "CMAES")
    assert res.final_x.shape == (4, 784)
    assert set(np.unique(res.final_x)) <= {0.0, 1.0}
    pop = np.load(tmp_path / f"{abbrv}_final_population.npy")
    assert pop.shape == (4, 28, 28)
    rows = (tmp_path / f"{abbrv}_pred_sums.csv").read_text().splitlines()
    n_rec = len(res.oracle_history)
    assert rows[0] == ",0.5,0.6,0.7,0.8,0.9"
    assert [r.split(",")[0] for r in rows[1:]] == \
        [str(min(2 * i, 4)) for i in range(n_rec)]
    assert n_rec == (3 if sampler != "CMAES" else 2)


@pytest.mark.parametrize("expert", ["ebm", "dae", "supervised"])
def test_initial_energies_and_oracle_match_jax_cli(dirs, tmp_path,
                                                   monkeypatch, expert):
    """One tiny SA run of each CLI on the same directories: the same
    initial energies, the same step-0 oracle, the same CSV names."""
    jms = _jax_cli()
    monkeypatch.setattr(jruntime, "enable_compile_cache", lambda: None)
    flags = (["--energy_function", "supervised"] if expert == "supervised"
             else ["--unsupervised_expert", expert])
    argv = _argv(dirs, tmp_path / "jax", "--n_iters", "2", "--n_chains", "2",
                 "--metrics", "csv", *flags)
    rj = jms.main(jms.build_parser().parse_args(argv))
    argv = _argv(dirs, tmp_path / "port", "--n_iters", "2", "--n_chains",
                 "2", "--metrics", "csv", "--device", "cpu", *flags)
    rt = _main(argv)
    for a, b in ((rt.energy_history[0], rj.energy_history[0]),
                 (rt.fitness_history[0], rj.fitness_history[0]),
                 (rt.oracle_history[0], rj.oracle_history[0])):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_csv_equals_the_pandas_writer(tmp_path):
    """The numpy CSV writer gives the JAX package's pandas file byte for
    byte, a ragged tail (n_iters not a multiple of log_every) included."""
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(5, 16)).astype(np.float32)
    orc = rng.normal(size=(5, 16))
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    args = dict(log_every=50, n_iters=190)
    metrics.mnist_scores_to_csv(pred, orc, "m", SimpleNamespace(
        results_path=str(tmp_path / "port"), **args))
    jmetrics.mnist_scores_to_csv(pred, orc, "m", SimpleNamespace(
        results_path=str(tmp_path / "jax"), **args))
    for name in ("m_pred_sums.csv", "m_oracle_sums.csv"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("writer,package", [("plots", "matplotlib"),
                                            ("viz", "matplotlib"),
                                            ("gif", "PIL")])
def test_missing_plotting_package_is_refused_before_sampling(
        dirs, tmp_path, monkeypatch, writer, package):
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(RuntimeError,
                       match=rf"--metrics {writer} needs the package "
                             rf"{package}"):
        _main(_argv(dirs, tmp_path / "r", "--device", "cpu", "--metrics",
                    f"csv+{writer}"))
    assert not (tmp_path / "r").exists()
    mnist_sum.check_writers("csv")  # the CSVs need no package


def test_default_device_needs_a_gpu(dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(_argv(dirs, tmp_path / "r", "--metrics", "csv"))
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("sampler", ["PPDE", "CMAES"])
def test_checkpoint_dir_resumes_bit_exact(dirs, tmp_path, capsys, sampler):
    """--checkpoint_dir: cut at step 2 of 4 and resumed, the run equals the
    uncut one."""
    def run(n, *ck):
        return _main(_argv(dirs, tmp_path / "r", "--device", "cpu",
                           "--sampler", sampler, "--ppde_pas_length", "2",
                           "--cmaes_population_size", "4", "--metrics",
                           "csv", "--n_iters", str(n), *ck))
    ref = run(4)
    ck = ("--checkpoint_dir", str(tmp_path / "ck"))
    run(2, *ck)
    capsys.readouterr()
    res = run(4, *ck)
    assert "[resume]" in capsys.readouterr().out
    for k in ("final_x", "best_x", "best_energy", "energy_history",
              "fitness_history", "oracle_history"):
        np.testing.assert_array_equal(getattr(res, k), getattr(ref, k))


def test_module_entry_points(tmp_path):
    """``python -m`` runs both entry points: the stand-in writer and the
    CLI (one SA run on the CPU)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "ppde_tpu_torch.scripts.seeded_mnist",
         "--weights", str(tmp_path / "w"), "--data", str(tmp_path / "d")],
        capture_output=True, text=True, env=env, cwd=tmp_path, check=True)
    assert out.stdout.split() == [str(tmp_path / "w"), str(tmp_path / "d")]
    out = subprocess.run(
        [sys.executable, "-m", "ppde_tpu_torch.scripts.mnist_sum",
         *_argv((str(tmp_path / "w"), str(tmp_path / "d")), tmp_path / "r",
                "--device", "cpu", "--metrics", "csv", "--n_chains", "2")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.endswith("done\n")
    assert sorted(os.listdir(tmp_path / "r")) == [
        "SA_product_of_experts_oracle_sums.csv",
        "SA_product_of_experts_pred_sums.csv"]
