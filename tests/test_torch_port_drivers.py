"""The port's experiment drivers (``ppde_tpu_torch/scripts/*.sh``) against
the JAX package's (``scripts/*.sh``): under the same environment and
arguments they make the same calls, in the same order, through the same
skip branches, with only ``scripts/X.py`` (behind ``tools/tpu_run.sh`` or
``$PY``) become ``-m ppde_tpu_torch.scripts.X``; and every call the port's
drivers make parses with that entry point's ``build_parser()``.

A stub ``python`` first on PATH (chip_smoke.py's ``DRIVER_STUB``, which
phase 14 uses to take its argument vectors from the port's drivers)
records each call's arguments and exits with ``STUB_RC``, so no entry
point runs. Both drivers run unmodified from
copies in a tree laid out as the repository (``scripts/``,
``ppde_tpu_torch/scripts/``; ``tools/tpu_run.sh`` there is a pass-through
to ``python``: it only retries TPU-claim races), in which the files the
skip checks look for are made or left out."""
import importlib
import os
import shutil
import subprocess

import pytest

from chip_smoke import DRIVER_STUB, recorded_calls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("run_protein_samplers", "run_r5_150m", "run_r4_650m",
           "run_esm_family", "train_mnist")


@pytest.fixture
def tree(tmp_path):
    """A repository-shaped tree with both packages' drivers and the stub."""
    for name in DRIVERS:
        for sub in ("scripts", os.path.join("ppde_tpu_torch", "scripts")):
            os.makedirs(tmp_path / sub, exist_ok=True)
            shutil.copy(os.path.join(ROOT, sub, name + ".sh"), tmp_path / sub)
    for path, text in (("bin/python", DRIVER_STUB),
                       ("tools/tpu_run.sh", '#!/bin/bash\nexec python "$@"\n')):
        os.makedirs(os.path.dirname(tmp_path / path), exist_ok=True)
        (tmp_path / path).write_text(text)
        os.chmod(tmp_path / path, 0o755)
    os.makedirs(tmp_path / "results" / "esm_family")
    return tmp_path


def run_driver(tree, script, args=(), env=None, rc=0):
    """(calls as argument lists, exit code, stderr) of one driver."""
    log = tree / "calls.log"
    if log.exists():
        log.unlink()
    full = dict(os.environ, PATH=f"{tree / 'bin'}:{os.environ['PATH']}",
                STUB_LOG=str(log), STUB_RC=str(rc), **(env or {}))
    for var in ("ESM_WEIGHTS", "EXTRA", "FT_EXTRA"):
        if env is None or var not in env:
            full.pop(var, None)
    p = subprocess.run(["bash", str(tree / script), *args], env=full,
                       capture_output=True, text=True, timeout=60)
    calls = recorded_calls(log.read_text() if log.exists() else "")
    return calls, p.returncode, p.stderr


def as_module_call(argv):
    """A JAX driver's ``scripts/X.py ...`` as the port's ``-m`` call."""
    script, rest = argv[0], argv[1:]
    assert script.startswith("scripts/") and script.endswith(".py"), argv
    return ["-m", "ppde_tpu_torch.scripts." + script[8:-3], *rest]


def both(tree, name, args=(), env=None, rc=0):
    """Run the JAX driver and its port the same way; assert the same calls,
    exit code and failure lines; return the port's calls."""
    jcalls, jrc, jerr = run_driver(tree, f"scripts/{name}.sh", args, env, rc)
    tcalls, trc, terr = run_driver(
        tree, f"ppde_tpu_torch/scripts/{name}.sh", args, env, rc)
    assert jcalls, f"{name}: the JAX driver made no call"
    assert tcalls == [as_module_call(c) for c in jcalls]
    assert trc == jrc
    assert terr.count("[sweep] FAILED") == jerr.count("[sweep] FAILED")
    return tcalls


def parses(calls):
    """Every call's flags parse with its entry point's parser."""
    for argv in calls:
        assert argv[0] == "-m", argv
        module = importlib.import_module(argv[1])
        args = module.build_parser().parse_args(argv[2:])
        assert args.device == "cuda"  # the drivers pass no device


@pytest.mark.parametrize("esm_weights", [None, "weights/esm2_t30.pt"])
def test_protein_sweep_makes_the_jax_calls(tree, esm_weights):
    env = {"N_ITERS": "3", "N_CHAINS": "8", "SEED": "5"}
    if esm_weights:
        env.update(ESM_WEIGHTS=esm_weights,
                   EXTRA="--disable_MSA_transformer_scoring --log_every 7")
    calls = both(tree, "run_protein_samplers", env=env)
    # 3 proteins x 6 potts runs (+ the transformer cell with weights)
    assert len(calls) == 3 * (6 + bool(esm_weights))
    tr = [c for c in calls if "transformer-M" in c]
    assert len(tr) == (3 if esm_weights else 0)
    cma = [c for c in calls if "CMAES" in c]
    assert all(c[c.index("--n_iters") + 1] == "1000" for c in cma)
    parses(calls)


def test_protein_sweep_goes_on_after_a_failed_cell(tree):
    calls = both(tree, "run_protein_samplers", env={"N_ITERS": "2"}, rc=3)
    assert len(calls) == 18


@pytest.mark.parametrize("name,model", [("run_r5_150m", "transformer-M"),
                                        ("run_r4_650m", "transformer-L")])
@pytest.mark.parametrize("ckpt,scorer", [(False, True), (True, False)])
def test_lora_rows_make_the_jax_calls(tree, name, model, ckpt, scorer):
    """The fine-tune runs unless its merged checkpoint exists; the cell
    scores with the newest msa-S file when there is one."""
    out = "UBE4B_150M_lora" if "150m" in name else "UBE4B_650M_lora"
    fam = tree / "results" / "esm_family"
    if ckpt:
        (fam / f"{out}_ckpt_5.npz").write_bytes(b"")
    if scorer:
        for step in (1000, 2000):
            (fam / f"UBE4B_msat_S_ckpt_{step}.npz").write_bytes(b"")
    calls = both(tree, name, ["5", "7"])
    entries = [c[1].rsplit(".", 1)[1] for c in calls]
    assert entries == ["finetune_esm"] * (not ckpt) + ["directed_evolution"]
    if not ckpt:
        ft = calls[0]
        assert ft[ft.index("--esm_model") + 1] == model
        assert ft[ft.index("--n_iters") + 1] == "5"
    cell = calls[-1]
    assert cell[cell.index("--unsupervised_expert") + 1] == "potts+" + model
    assert cell[cell.index("--esm_weights") + 1] == \
        f"results/esm_family/{out}_ckpt_5.npz"
    assert cell[cell.index("--n_iters") + 1] == "7"
    if scorer:
        assert cell[cell.index("--msa_transformer_weights") + 1] == \
            "results/esm_family/UBE4B_msat_S_ckpt_2000.npz"
    else:
        assert "--disable_MSA_transformer_scoring" in cell
    parses(calls)


@pytest.mark.parametrize("name", ["run_r5_150m", "run_r4_650m"])
def test_lora_rows_stop_when_the_fine_tune_fails(tree, name):
    calls = both(tree, name, ["5"], rc=1)
    assert len(calls) == 1 and calls[0][1].endswith("finetune_esm")


@pytest.mark.parametrize("args,env", [
    ((), {}),
    (("GFP_AEQVI_Sarkisyan2016", "transformer-M", "9"),
     {"MSA": "data/proteins/synthetic/GFP_AEQVI_Sarkisyan2016_synth.a2m",
      "OUT": "results/esm_family/gfp_M", "LAMBDA": "1", "SWEEP_ITERS": "11",
      "FT_EXTRA": "--lora_rank 8"})])
def test_family_pipeline_makes_the_jax_calls(tree, args, env):
    calls = both(tree, "run_esm_family", args, env)
    entries = [c[1].rsplit(".", 1)[1] for c in calls]
    assert entries == ["finetune_esm", "eval_expert_correlation",
                       "eval_expert_correlation", "directed_evolution"]
    parses(calls)


def test_family_pipeline_stops_at_the_first_failure(tree):
    calls = both(tree, "run_esm_family", rc=2)
    assert len(calls) == 1


def test_mnist_zoo_makes_the_jax_calls(tree):
    env = {"MNIST_SOURCE": "synthetic", "OUT": "weights/zoo",
           "ITERS_REG": "3", "ITERS_ORACLE": "4", "ITERS_DAE": "5",
           "ITERS_EBM": "6"}
    calls = both(tree, "train_mnist", env=env)
    entries = [c[1].rsplit(".", 1)[1] for c in calls]
    assert entries == ["train_binary_mnist_regression"] * 4 + [
        "train_binary_mnist_dae", "train_binary_mnist_ebm"]
    parses(calls)


def test_drivers_work_from_the_repository_root(tree):
    """The port's drivers sit one directory deeper than the JAX ones; both
    must see the same results/ (a skip check that missed it would run the
    fine-tune again)."""
    (tree / "results" / "esm_family" / "UBE4B_650M_lora_ckpt_4.npz") \
        .write_bytes(b"")
    other = tree / "ppde_tpu_torch" / "results" / "esm_family"
    os.makedirs(other)
    calls, rc, _ = run_driver(tree, "ppde_tpu_torch/scripts/run_r4_650m.sh",
                              ["4", "2"])
    assert rc == 0 and [c[1] for c in calls] == [
        "ppde_tpu_torch.scripts.directed_evolution"]
