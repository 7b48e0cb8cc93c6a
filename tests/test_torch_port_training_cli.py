"""The port's training and fitting entry points (ppde_tpu_torch/scripts/
{finetune_esm,finetune_msa,fit_potts,sample_potts_msa,
train_binary_mnist_regression,train_binary_mnist_dae,train_binary_mnist_ebm,
eval_mnist_ebm}.py) against the JAX package's scripts: the flags, the
refusals, and tiny CPU runs of both that must write the same files under
the same names with the same npz keys (the JAX package's files also hold a
``treedef`` string, which no loader reads). ``eval_mnist_ebm`` of both
packages on one port-written EBM prints the same log-probabilities of the
deterministic sets (to the printed 0.1)."""
import argparse
import contextlib
import importlib
import io
import os
import re

import numpy as np
import pytest
import torch

from ppde_tpu.models import esm2 as jesm
from ppde_tpu_torch.models import esm2 as pesm
from ppde_tpu_torch.scripts import (eval_mnist_ebm, finetune_esm,
                                    finetune_msa, fit_potts,
                                    sample_potts_msa, seeded_mnist,
                                    seeded_protein,
                                    train_binary_mnist_dae,
                                    train_binary_mnist_ebm,
                                    train_binary_mnist_regression)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PABP_A2M = os.path.join(REPO, "data", "proteins", "synthetic",
                        "PABP_YEAST_Fields2013_synth.a2m")
jesm.CONFIGS["mlm-tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
pesm.CONFIGS["mlm-tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
MODULES = {
    "finetune_esm": finetune_esm, "finetune_msa": finetune_msa,
    "fit_potts": fit_potts, "sample_potts_msa": sample_potts_msa,
    "train_binary_mnist_regression": train_binary_mnist_regression,
    "train_binary_mnist_dae": train_binary_mnist_dae,
    "train_binary_mnist_ebm": train_binary_mnist_ebm,
    "eval_mnist_ebm": eval_mnist_ebm}


def _jax(name):
    return importlib.import_module(f"scripts.{name}")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 40-row PABP alignment (all 96 columns), its wild type in a seeded
    protein directory, and seeded MNIST weights and data directories."""
    root = tmp_path_factory.mktemp("inputs")
    lines = open(PABP_A2M).read().split("\n")[:80]
    a2m = str(root / "pabp40.a2m")
    with open(a2m, "w") as f:
        f.write("\n".join(lines) + "\n")
    seeded_protein.write_protein_dir(str(root), "PABP", lines[1])
    return {"a2m": a2m, "protein_weights": str(root),
            "wt": str(root / "PABP" / "wt.fasta"),
            "mnist_data": seeded_mnist.write_data_dir(str(root / "d"))}


def _argv(name, inputs, out):
    """Minimal arguments of each entry point (``out``: a directory)."""
    o = str(out)
    return {
        "finetune_esm": ["--msa", inputs["a2m"], "--wt_fasta", inputs["wt"],
                         "--esm_model", "mlm-tiny", "--out", f"{o}/esm",
                         "--n_iters", "2", "--batch_size", "4",
                         "--ckpt_every", "1", "--lora_rank", "2",
                         "--val_frac", "0.1", "--log_every", "1"],
        "finetune_msa": ["--msa", inputs["a2m"], "--msa_model", "msa-tiny",
                         "--out", f"{o}/msa", "--n_iters", "2",
                         "--block_rows", "4", "--val_frac", "0.1",
                         "--log_every", "1"],
        "fit_potts": ["--msa", inputs["a2m"], "--out", f"{o}/potts.npz",
                      "--steps", "3", "--max_seqs", "30"],
        "sample_potts_msa": ["--protein_weights", inputs["protein_weights"],
                             "--protein", "PABP", "--n_seqs", "6",
                             "--n_sweeps", "2", "--qc_msa", inputs["a2m"],
                             "--out", f"{o}/s.a2m", "--out_json",
                             f"{o}/qc.json"],
        "train_binary_mnist_regression": [
            "--output_dir", o, "--n_channels", "4", "--n_iters", "2",
            "--batch_size", "8", "--ckpt_every", "1"],
        "train_binary_mnist_dae": [
            "--mnist_source", "synthetic", "--output_dir", o,
            "--n_channels", "4", "--latent_dim", "4", "--n_iters", "2",
            "--batch_size", "8", "--ckpt_every", "1"],
        "train_binary_mnist_ebm": [
            "--mnist_source", "synthetic", "--output_dir", o,
            "--n_channels", "4", "--n_iters", "2", "--batch_size", "8",
            "--buffer_size", "16", "--sampling_steps", "1",
            "--ckpt_every", "1"],
        "eval_mnist_ebm": ["--weights_dir", o, "--data_dir",
                           inputs["mnist_data"], "--out_dir", f"{o}/r",
                           "--n_channels", "4", "--sample_steps", "2"],
    }[name]


def _run_port(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = MODULES[name].main(MODULES[name].build_parser().parse_args(
            argv + ["--device", "cpu"]))
    return res, out.getvalue()


def _run_jax(name, argv):
    """The JAX script's main on the port parser's namespace (the same
    flags) less --device; the scripts that parse in ``__main__`` make
    their output directory there."""
    args = vars(MODULES[name].build_parser().parse_args(argv))
    args.pop("device")
    if "output_dir" in args:
        os.makedirs(args["output_dir"], exist_ok=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax(name).main(argparse.Namespace(**args))
    return out.getvalue()


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _keys(path):
    return sorted(set(np.load(path).files) - {"treedef"})


@pytest.mark.parametrize("name", ["finetune_esm", "finetune_msa",
                                  "sample_potts_msa"])
def test_parser_defaults_match_jax(name):
    """Every flag of the JAX script with its default, plus --device
    (default cuda)."""
    required = {"finetune_esm": ["--msa", "a", "--out", "o"],
                "finetune_msa": ["--msa", "a", "--out", "o"],
                "sample_potts_msa": ["--protein", "P"]}[name]
    ours = vars(MODULES[name].build_parser().parse_args(required))
    theirs = vars(_jax(name).build_parser().parse_args(required))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(MODULES))
def test_default_device_needs_a_gpu(name, inputs, tmp_path):
    """--device defaults to cuda and raises where there is none (no CPU
    fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    argv = _argv(name, inputs, tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MODULES[name].main(MODULES[name].build_parser().parse_args(argv))


def test_mesh_dp_is_refused(inputs, tmp_path, monkeypatch):
    """--mesh_dp started without a launcher raises, naming torchrun, before
    it writes anything."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = _argv("finetune_esm", inputs, tmp_path) + ["--mesh_dp", "2",
                                                      "--device", "cpu"]
    with pytest.raises(RuntimeError, match="torchrun"):
        finetune_esm.main(finetune_esm.build_parser().parse_args(argv))
    assert not os.listdir(tmp_path)


def test_mesh_dp_2_trains_as_one_device(inputs, tmp_path):
    """finetune_esm --mesh_dp 2 on 2 gloo ranks trains: rank 0 writes the
    single-device run's files, and every rank returns its weights (rtol
    2e-4, atol 1e-5)."""
    from test_torch_port_parallel import ranks_finetune, spawn

    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir(), two.mkdir()
    single, _ = _run_port("finetune_esm", _argv("finetune_esm", inputs, one))
    got = spawn(ranks_finetune, 2, tmp_path,
                _argv("finetune_esm", inputs, two) + [
                    "--device", "cpu", "--mesh_dp", "2"])
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    final = "esm_ckpt_2.npz"
    a, b = np.load(one / final), np.load(two / final)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(b[k], a[k])
    for leaves in got:
        for x, y in zip(leaves, pesm._flatten(single)):
            np.testing.assert_allclose(x, y.detach().numpy(), rtol=2e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("name", ["finetune_esm", "finetune_msa",
                                  "fit_potts", "sample_potts_msa"])
def test_protein_runs_write_the_jax_files(name, inputs, tmp_path):
    if name == "sample_potts_msa":  # sample from a fit, as users do
        fit = str(tmp_path / "fit.npz")
        _run_port("fit_potts", ["--msa", inputs["a2m"], "--out", fit,
                                "--steps", "2"])
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir(), theirs.mkdir()  # fit_potts writes into an existing one
    extra = ["--potts_npz", fit] if name == "sample_potts_msa" else []
    _, log = _run_port(name, _argv(name, inputs, ours) + extra)
    jlog = _run_jax(name, _argv(name, inputs, theirs) + extra)
    assert _files(ours) == _files(theirs) and _files(ours)
    for f in _files(ours):
        if f.endswith(".npz"):
            assert _keys(ours / f) == _keys(theirs / f), f
    if name == "sample_potts_msa":
        import json

        a, b = (json.loads(open(d / "qc.json").read()) for d in (ours,
                                                                 theirs))
        assert a.keys() == b.keys() and a["wt_H"] == b["wt_H"]
        assert np.isfinite(a["single_site_freq_r"])
        heads = [[ln for ln in open(d / "s.a2m").read().split("\n")
                  if ln.startswith(">")] for d in (ours, theirs)]
        assert heads[0] == heads[1]
    if name == "fit_potts":
        a, b = np.load(ours / "potts.npz"), np.load(theirs / "potts.npz")
        for k in ("index_list", "offset", "reg_coef"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["J"].shape == b["J"].shape
    if name in ("finetune_esm", "finetune_msa"):
        ce = [float(v) for v in re.findall(r"held-out masked CE \w+: ([\d.]+)",
                                           log)]
        assert len(ce) == 2 and all(np.isfinite(ce))
        assert log.count("iter") == jlog.count("iter") == 2
    if name == "finetune_esm":  # the merged file loads in the JAX loader
        merged = jesm.load_npz_checkpoint(str(ours / "esm_ckpt_2.npz"),
                                          "mlm-tiny")
        assert len(merged["layers"]) == 2


@pytest.mark.parametrize("name", ["train_binary_mnist_regression",
                                  "train_binary_mnist_dae",
                                  "train_binary_mnist_ebm"])
def test_mnist_trainers_write_the_jax_files(name, inputs, tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    _, log = _run_port(name, _argv(name, inputs, ours))
    jlog = _run_jax(name, _argv(name, inputs, theirs))
    assert _files(ours) == _files(theirs) and len(_files(ours)) >= 2
    for f in _files(ours):
        assert _keys(ours / f) == _keys(theirs / f), f
        for k in _keys(ours / f):
            assert np.load(ours / f)[k].shape == np.load(theirs / f)[k].shape
    assert [ln.split()[:3] for ln in log.splitlines()] == \
        [ln.split()[:3] for ln in jlog.splitlines()]


def test_eval_mnist_ebm_of_a_port_ebm_matches_jax(inputs, tmp_path):
    """The port trains an EBM; both packages' eval_mnist_ebm load it."""
    w = tmp_path / "w"
    _run_port("train_binary_mnist_ebm",
              _argv("train_binary_mnist_ebm", inputs, w))
    rows, log = _run_port("eval_mnist_ebm", _argv("eval_mnist_ebm", inputs,
                                                  w))
    jlog = _run_jax("eval_mnist_ebm", _argv("eval_mnist_ebm", inputs, w))

    def logps(text):
        return {m[0]: float(m[1]) for m in re.findall(
            r"logp (\w+)\s+mean\s+(-?[\d.]+)", text)}

    ours, theirs = logps(log), logps(jlog)
    assert ours.keys() == theirs.keys() and len(ours) == 6
    for k in ("real_heldout", "aug_heldout", "bernoulli_mean", "uniform",
              "pixel_shuffled"):
        assert abs(ours[k] - theirs[k]) <= 0.1 + 1e-9, (k, ours, theirs)
        assert rows[k][0] == pytest.approx(ours[k], abs=0.05)
    assert np.isfinite(rows["gwg_samples"][0])
