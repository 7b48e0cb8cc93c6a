"""The port's experiment drivers (``ppde_tpu_torch/scripts/*.sh``) against
the JAX package's (``scripts/*.sh``): under the same environment and
arguments they make the same calls, in the same order, through the same
skip branches, with only ``scripts/X.py`` (behind ``tools/tpu_run.sh`` or
``$PY``) become ``-m ppde_tpu_torch.scripts.X`` and a nested driver or the
link script become the port's copy; they print the same progress and
failure lines (paths and the queue's clock aside); and every call the
port's drivers make parses with that entry point's ``build_parser()``.

A stub ``python`` first on PATH (chip_smoke.py's ``DRIVER_STUB``, which
phase 14 uses to take its argument vectors from the port's drivers)
records each call's arguments and exits with ``STUB_RC``, so no entry
point runs. Both drivers run unmodified from
copies in a tree laid out as the repository (``scripts/``,
``ppde_tpu_torch/scripts/``; ``tools/tpu_run.sh`` there is a pass-through
to ``python``: it only retries TPU-claim races), in which the files the
skip checks look for are made or left out. Both packages' copies of
``link_reference_weights.sh`` are recording stubs there too (the real ones
link a reference checkout), so a call of either shows as its path.
``run_r4_qc_pt.sh`` and ``run_r5_ljdecision.sh`` name ``/tmp/potts_lj*.npz``;
in the tree's copies of both packages' drivers that path becomes
``<tree>/tmp/potts_lj*.npz``, so the tests make and see only their own
files and nothing another process left in ``/tmp``."""
import importlib
import os
import re
import shutil
import subprocess

import pytest

from chip_smoke import DRIVER_STUB, recorded_calls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("run_protein_samplers", "run_r5_150m", "run_r4_650m",
           "run_esm_family", "train_mnist", "run_r4_scorer_eval",
           "run_r5_ljdecision", "run_r4_qc_pt", "run_r4_family_cells",
           "run_r4_evidence", "run_r5_family10k", "run_r5_remaining",
           "run_r4_all")
LINK = {"tools/link_reference_weights.sh":
        "ppde_tpu_torch/scripts/link_reference_weights.sh"}
LINK_STUB = """#!/bin/bash
{ printf '%s\\037' "$0" "$@"; printf '\\036'; } >> "$STUB_LOG"
"""
UBE4B = "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio"
PROTEINS = {"UBE4B": UBE4B, "PABP": "PABP_YEAST_Fields2013",
            "GFP": "GFP_AEQVI_Sarkisyan2016"}
LJ = ("0.001", "0.01")
LJ_NPZ = "/tmp/potts_lj"


@pytest.fixture
def tree(tmp_path):
    """A repository-shaped tree with both packages' drivers and the stub."""
    for name in DRIVERS:
        for sub in ("scripts", os.path.join("ppde_tpu_torch", "scripts")):
            os.makedirs(tmp_path / sub, exist_ok=True)
            dst = tmp_path / sub / (name + ".sh")
            shutil.copy(os.path.join(ROOT, sub, name + ".sh"), dst)
            dst.write_text(dst.read_text().replace(
                LJ_NPZ, str(tmp_path / LJ_NPZ[1:])))
    for path, text in (("bin/python", DRIVER_STUB),
                       ("tools/tpu_run.sh", '#!/bin/bash\nexec python "$@"\n'),
                       *((p, LINK_STUB) for p in (*LINK, *LINK.values()))):
        os.makedirs(os.path.dirname(tmp_path / path), exist_ok=True)
        (tmp_path / path).write_text(text)
        os.chmod(tmp_path / path, 0o755)
    os.makedirs(tmp_path / "results" / "esm_family")
    os.makedirs(tmp_path / "tmp")
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
    """A JAX driver's ``scripts/X.py ...`` as the port's ``-m`` call, and
    its link script's call as the port's copy's."""
    script, rest = argv[0], argv[1:]
    if script in LINK:
        return [LINK[script], *rest]
    assert script.startswith("scripts/") and script.endswith(".py"), argv
    return ["-m", "ppde_tpu_torch.scripts." + script[8:-3], *rest]


def lines(stderr):
    """A driver's stderr lines with the port's script paths written as the
    JAX package's and the queue's clock taken out."""
    return [re.sub(r"\d\d:\d\d:\d\d", "T", line).replace(
        "ppde_tpu_torch/scripts/", "scripts/")
        for line in stderr.splitlines()]


def both(tree, name, args=(), env=None, rc=0):
    """Run the JAX driver and its port the same way; assert the same calls,
    exit code and progress and failure lines; return the port's calls and
    stderr."""
    jcalls, jrc, jerr = run_driver(tree, f"scripts/{name}.sh", args, env, rc)
    tcalls, trc, terr = run_driver(
        tree, f"ppde_tpu_torch/scripts/{name}.sh", args, env, rc)
    assert jcalls, f"{name}: the JAX driver made no call"
    assert tcalls == [as_module_call(c) for c in jcalls]
    assert trc == jrc
    assert lines(terr) == lines(jerr)
    return tcalls, terr


def parses(calls):
    """Every call's flags parse with its entry point's parser."""
    for argv in calls:
        if argv[0] in LINK.values():
            continue
        assert argv[0] == "-m", argv
        module = importlib.import_module(argv[1])
        args = module.build_parser().parse_args(argv[2:])
        # the drivers pass no device (run_cells has none: its cells' CLIs
        # take theirs from each cell's argv)
        assert getattr(args, "device", "cuda") == "cuda"


def entries(calls):
    return [c[1].rsplit(".", 1)[1] if c[0] == "-m" else "link"
            for c in calls]


@pytest.mark.parametrize("esm_weights", [None, "weights/esm2_t30.pt"])
def test_protein_sweep_makes_the_jax_calls(tree, esm_weights):
    env = {"N_ITERS": "3", "N_CHAINS": "8", "SEED": "5"}
    if esm_weights:
        env.update(ESM_WEIGHTS=esm_weights,
                   EXTRA="--disable_MSA_transformer_scoring --log_every 7")
    calls, _ = both(tree, "run_protein_samplers", env=env)
    # 3 proteins x 6 potts runs (+ the transformer cell with weights)
    assert len(calls) == 3 * (6 + bool(esm_weights))
    tr = [c for c in calls if "transformer-M" in c]
    assert len(tr) == (3 if esm_weights else 0)
    cma = [c for c in calls if "CMAES" in c]
    assert all(c[c.index("--n_iters") + 1] == "1000" for c in cma)
    parses(calls)


def test_protein_sweep_goes_on_after_a_failed_cell(tree):
    calls, _ = both(tree, "run_protein_samplers", env={"N_ITERS": "2"}, rc=3)
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
    calls, _ = both(tree, name, ["5", "7"])
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
    calls, _ = both(tree, name, ["5"], rc=1)
    assert len(calls) == 1 and calls[0][1].endswith("finetune_esm")


@pytest.mark.parametrize("args,env", [
    ((), {}),
    (("GFP_AEQVI_Sarkisyan2016", "transformer-M", "9"),
     {"MSA": "data/proteins/synthetic/GFP_AEQVI_Sarkisyan2016_synth.a2m",
      "OUT": "results/esm_family/gfp_M", "LAMBDA": "1", "SWEEP_ITERS": "11",
      "FT_EXTRA": "--lora_rank 8"})])
def test_family_pipeline_makes_the_jax_calls(tree, args, env):
    calls, _ = both(tree, "run_esm_family", args, env)
    entries = [c[1].rsplit(".", 1)[1] for c in calls]
    assert entries == ["finetune_esm", "eval_expert_correlation",
                       "eval_expert_correlation", "directed_evolution"]
    parses(calls)


def test_family_pipeline_stops_at_the_first_failure(tree):
    calls, _ = both(tree, "run_esm_family", rc=2)
    assert len(calls) == 1


def test_mnist_zoo_makes_the_jax_calls(tree):
    env = {"MNIST_SOURCE": "synthetic", "OUT": "weights/zoo",
           "ITERS_REG": "3", "ITERS_ORACLE": "4", "ITERS_DAE": "5",
           "ITERS_EBM": "6"}
    calls, _ = both(tree, "train_mnist", env=env)
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


def touch(tree, *paths, text=""):
    for path in paths:
        os.makedirs(os.path.dirname(tree / path), exist_ok=True)
        (tree / path).write_text(text)


def lj_npz(tree, lj):
    """The tree's stand-in for the drivers' ``/tmp/potts_lj<lj>.npz``."""
    return tree / f"tmp/potts_lj{lj}.npz"


@pytest.mark.parametrize("case", ["all_missing", "some_done", "rc1"])
def test_scorer_eval_makes_the_jax_calls(tree, case):
    """Each protein with a ckpt_2000 scorer gets a random and a trained
    correlation run, each skipped when its JSON is there."""
    fam = "results/esm_family"
    short = ["UBE4B", "PABP"] if case == "some_done" else list(PROTEINS)
    touch(tree, *(f"{fam}/{s}_msat_S_ckpt_2000.npz" for s in short))
    if case == "some_done":
        touch(tree, f"{fam}/PABP_msat_S_tpu_corr_random.json", text="{}")
    calls, err = both(tree, "run_r4_scorer_eval", rc=int(case == "rc1"))
    n = {"all_missing": 6, "some_done": 3, "rc1": 6}[case]
    assert entries(calls) == ["eval_expert_correlation"] * n
    assert err.count("[scorer_eval] FAILED") == (6 if case == "rc1" else 0)
    assert err.count("[scorer_eval] missing") == (case == "some_done")
    trained = [c for c in calls if "--msat_weights" in c]
    assert len(trained) == n // 2 + (case == "some_done")
    for c in calls:
        assert c[c.index("--msa_size") + 1] == "256"
        assert c[c.index("--n_mutants") + 1] == "256"
    parses(calls)


@pytest.mark.parametrize("fits", [False, True])
def test_lj_decision_makes_the_jax_calls(tree, fits):
    """fit_potts runs only for a missing /tmp/potts_lj<lj>.npz; both
    records are appended to one JSONL."""
    if fits:
        touch(tree, *(f"tmp/potts_lj{lj}.npz" for lj in LJ))
    calls, _ = both(tree, "run_r5_ljdecision")
    want = ["calibrate_oracle_scale"] if fits else [
        "fit_potts", "calibrate_oracle_scale"]
    assert entries(calls) == want * 2
    for c in calls:
        if entries([c]) == ["calibrate_oracle_scale"]:
            assert c[c.index("--out_json") + 1] == \
                "results/qc/ube4b_lj_decision.jsonl"
            assert c[c.index("--potts_npz") + 1] in (
                str(lj_npz(tree, lj)) for lj in LJ)
        else:
            assert c[c.index("--lambda_J") + 1] in LJ
    parses(calls)


def test_lj_decision_stops_at_a_failure(tree):
    touch(tree, *(f"tmp/potts_lj{lj}.npz" for lj in LJ))
    calls, _ = both(tree, "run_r5_ljdecision", rc=1)
    assert entries(calls) == ["calibrate_oracle_scale"]
    for lj in LJ:
        lj_npz(tree, lj).unlink()
    calls, _ = both(tree, "run_r5_ljdecision", rc=1)
    assert entries(calls) == ["fit_potts"]


@pytest.mark.parametrize("phase", ["qc", "pt", "all", None])
@pytest.mark.parametrize("rc", [0, 1])
def test_qc_pt_makes_the_jax_calls(tree, phase, rc):
    """qc: the sample-depth ladder, then fit / select / sample for each
    lambda_J, all through ``tee -a``; pt: PPDE and PPDE-PT on the
    supervised-only energy. A failed step is logged and the queue goes
    on."""
    calls, _ = both(tree, "run_r4_qc_pt", [phase] if phase else [], rc=rc)
    qc = ["sample_potts_msa"] * 4 + [
        "fit_potts", "select_lambda", "sample_potts_msa"] * 3
    pt = ["directed_evolution"] * 2
    want = {"qc": qc, "pt": pt}.get(phase, qc + pt)
    assert entries(calls) == want
    ladder = [(c[c.index("--n_seqs") + 1], c[c.index("--n_sweeps") + 1])
              for c in calls[:4]] if phase != "pt" else []
    assert ladder in ([], [("2048", "300"), ("4096", "600"), ("8192", "600"),
                           ("8192", "1200")])
    for c in calls:
        if entries([c]) == ["directed_evolution"]:
            assert c[c.index("--energy_function") + 1] == "supervised"
    if phase != "pt":
        assert (tree / "results" / "qc" / "ube4b_qc_ladder.log").exists()
    parses(calls)


@pytest.mark.parametrize("case", ["nothing", "scorers", "done", "rc1"])
def test_family_cells_make_the_jax_calls(tree, case):
    """[0] UBE4B's scorer unless its ckpt_2000 exists, [1] PABP's and
    GFP's unless any msat_S_ckpt exists, [2] both family cells of each
    protein with an expert, scored by the newest scorer, each skipped when
    its summary exists."""
    fam = "results/esm_family"
    experts = ["UBE4B", "GFP"] if case == "nothing" else list(PROTEINS)
    touch(tree, *(f"{fam}/{PROTEINS[s]}_transformer-S_ckpt_4000.npz"
                  for s in experts))
    if case in ("scorers", "done"):
        touch(tree, f"{fam}/UBE4B_msat_S_ckpt_2000.npz",
              f"{fam}/PABP_msat_S_ckpt_1000.npz",
              f"{fam}/PABP_msat_S_ckpt_2000.npz")
    if case == "done":  # every scorer, every cell but one
        touch(tree, f"{fam}/GFP_msat_S_ckpt_1000.npz", *(
            f"{fam}/{s}_PPDE-{e}_family_s1234567.json" for s in PROTEINS
            for e in ("potts_transformer-S", "transformer-S")
            if (s, e) != ("GFP", "transformer-S")), text="{}")
    calls, err = both(tree, "run_r4_family_cells", rc=int(case == "rc1"))
    scorers = {"nothing": 3, "scorers": 1, "done": 0, "rc1": 3}[case]
    cells = {"nothing": 4, "scorers": 6, "done": 1, "rc1": 6}[case]
    assert err.count("[skip, summary exists]") == 5 * (case == "done")
    assert entries(calls) == ["finetune_msa"] * scorers + [
        "directed_evolution"] * cells
    if case == "rc1":
        assert err.count("[r4fam] scorer FAILED") == 3
        assert err.count("[r4fam] FAILED") == 6
    if case == "nothing":
        assert err.count("[r4fam] missing expert ckpt") == 1
        # no scorer file was written (the stub trains none): no scoring
        assert all("--disable_MSA_transformer_scoring" in c
                   for c in calls[scorers:])
    if case == "scorers":
        pabp = [c for c in calls if PROTEINS["PABP"] in c]
        assert pabp and all(
            c[c.index("--msa_transformer_weights") + 1]
            == f"{fam}/PABP_msat_S_ckpt_2000.npz" for c in pabp)
        assert calls[0][calls[0].index("--out") + 1] == \
            f"{fam}/GFP_msat_S"
    parses(calls)


@pytest.mark.parametrize("phase", ["proteins", "mnist", "all", None])
def test_evidence_makes_the_jax_calls(tree, phase):
    """proteins: 45 cells through cell(), each skipped on a summary;
    mnist: 8 mnist_sum runs, then the two EBM-scored summaries."""
    done = ["GFP_PPDE-exact_s7", "PABP_CMAES_s1234567",
            "UBE4B_PPDE-PT_s1234567"]
    touch(tree, *(f"results/proteins/summaries/{n}.json" for n in done),
          text="{}")
    calls, err = both(tree, "run_r4_evidence", [phase] if phase else [])
    prot = ["directed_evolution"] * (45 - len(done))
    mnist = ["mnist_sum"] * 8 + ["summarize_mnist_runs"] * 2
    want = {"proteins": prot, "mnist": mnist}.get(phase, prot + mnist)
    assert entries(calls) == want
    assert err.count("[skip, summary exists]") == len(done) * (
        phase != "mnist")
    for c in calls:
        if entries([c]) == ["summarize_mnist_runs"]:
            assert "--score_ebm" in c
            assert c[c.index("--runs_glob") + 1] in (
                "results/mnist/*_r4full", "results/mnist/*_r4refcfg")
        elif entries([c]) == ["directed_evolution"]:
            assert "--summary_json" in c and c[c.index("--n_chains") + 1] \
                == "128"
    flags = [f for c in calls for f in c if f.startswith("--")]
    if phase != "mnist":
        assert {"--ppde_reference_reverse", "--energy_function"} <= set(
            flags)
    parses(calls)


def test_evidence_logs_every_failed_cell(tree):
    """Each failed cell and mnist run prints its [r4] line; the
    summaries' calls have none."""
    calls, err = both(tree, "run_r4_evidence", rc=1)
    assert len(calls) == 45 + 10
    assert err.count("[r4] FAILED") == 45 + 8


@pytest.mark.parametrize("case", ["experts", "cells_done", "short", "none"])
def test_family10k_makes_the_jax_calls(tree, case):
    """finetune_esm for each protein whose expert is missing and whose 8
    cells are not all at 10,000 steps, then run_cells --r5_family."""
    fam = "results/esm_family"
    if case == "experts":
        touch(tree, *(f"{fam}/{p}_transformer-S_ckpt_4000.npz"
                      for p in PROTEINS.values()))
    if case in ("cells_done", "short"):
        n_iters = 10000 if case == "cells_done" else 2500
        touch(tree, *(f"{fam}/{s}_PPDE-{e}_family_s{seed}.json"
                      for s in PROTEINS
                      for e in ("potts_transformer-S", "transformer-S")
                      for seed in (1234567, 7, 42, 2024)),
              text=f'{{"n_iters": {n_iters}, "sampler": "PPDE"}}')
    calls, err = both(tree, "run_r5_family10k")
    n_ft = {"experts": 0, "cells_done": 0, "short": 3, "none": 3}[case]
    assert entries(calls) == ["finetune_esm"] * n_ft + ["run_cells"]
    assert calls[-1][2:] == ["--r5_family"]
    for c in calls[:-1]:
        assert [c[c.index(f) + 1] for f in (
            "--batch_size", "--lr", "--val_frac", "--ckpt_every")] == [
            "64", "3e-4", "0.05", "2000"]
    assert err.count("all 8 family cells done at 10k") == 3 * (
        case == "cells_done")
    parses(calls)


def test_family10k_stops_when_a_fine_tune_fails(tree):
    calls, err = both(tree, "run_r5_family10k", rc=1)
    assert entries(calls) == ["finetune_esm"]
    assert "[r5fam] expert training FAILED" in err


@pytest.mark.parametrize("wt,m_sum", [(False, False), (True, True)])
def test_remaining_queue_makes_the_jax_calls(tree, wt, m_sum):
    """The link script when GFP's wt.fasta is missing, the baseline seeds,
    the 150M row unless its summary exists, the family queue, the MNIST
    CMA-ES pairs: the nested drivers are the port's copies."""
    fam = "results/esm_family"
    if wt:
        touch(tree, "weights/GFP_AEQVI_Sarkisyan2016/wt.fasta")
    if m_sum:
        touch(tree, f"{fam}/UBE4B_PPDE-potts_transformer-M_family_"
              "s1234567.json", text="{}")
    calls, err = both(tree, "run_r5_remaining")
    want = ["link"] * (not wt) + ["run_cells"] + [
        "finetune_esm", "directed_evolution"] * (not m_sum) + [
        "finetune_esm"] * 3 + ["run_cells"] * 2
    assert entries(calls) == want
    if not wt:
        assert calls[0] == [LINK["tools/link_reference_weights.sh"]]
    assert [c[2:] for c in calls if entries([c]) == ["run_cells"]] == [
        ["--r5_baseline_seeds"], ["--r5_family"], ["--r5_mnist_cmaes"]]
    assert ("skip: 150M quality cell exists" in err) == m_sum
    parses(calls)


def test_remaining_queue_goes_on_after_failures(tree):
    calls, err = both(tree, "run_r5_remaining", rc=1)
    # the 150M row and the family queue stop at their first call
    assert entries(calls) == ["link", "run_cells", "finetune_esm",
                              "finetune_esm", "run_cells"]
    for line in ("stage 1 FAILED", "stage 2 FAILED", "stage 3 FAILED",
                 "stage 4 FAILED"):
        assert err.count(line) == 1


@pytest.mark.parametrize("rc", [0, 1])
def test_r4_queue_runs_the_port_phases(tree, rc):
    """The five phases, executed as programs: the port's copies (the
    calls are -m calls all through), each failure logged."""
    calls, err = both(tree, "run_r4_all", rc=rc)
    e = entries(calls)
    assert e[:3] == ["finetune_msa"] * 3
    # the evidence cells, run_r4_650m.sh's cell (not after its fine-tune
    # failed) and the pt pair
    assert e.count("directed_evolution") == 45 + (rc == 0) + 2
    assert e.count("mnist_sum") == 8 and e.count("sample_potts_msa") == 7
    assert err.count("PHASE FAILED") == rc  # run_r4_650m.sh's exit 1
    assert err.count("=== [queue") == 6 + rc
    parses(calls)


def test_driver_copies_are_executable():
    """run_r4_all.sh runs its phases as programs."""
    for name in (*DRIVERS, "link_reference_weights"):
        path = os.path.join(ROOT, "ppde_tpu_torch", "scripts", name + ".sh")
        assert os.access(path, os.X_OK), path


@pytest.mark.parametrize("given", [True, False])
def test_link_script_links_only_the_reference_it_is_given(tmp_path, given):
    """The port's link script, run for real from a repository-shaped copy
    beside a reference-shaped tree: given that tree's path (relative to
    the caller), it links the tree's weights and data into the copy;
    given nothing, it prints its usage and links nothing, not even the
    tree beside it."""
    repo = tmp_path / "repo"
    script = repo / LINK["tools/link_reference_weights.sh"]
    os.makedirs(script.parent)
    shutil.copy(os.path.join(ROOT, LINK["tools/link_reference_weights.sh"]),
                script)
    files = [*(f"weights/{p}/wt.fasta" for p in PROTEINS.values()),
             "weights/mnist_models/ebm.pt", "data/mnist/train.npz",
             "data/proteins/x.a2m"]
    touch(tmp_path / "reference", *files)
    p = subprocess.run(["bash", str(script), *(["reference"] * given)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=60)
    if given:
        assert p.returncode == 0, p.stderr
        for f in files:
            assert os.path.islink(repo / f)
            assert os.path.realpath(repo / f) == os.path.realpath(
                tmp_path / "reference" / f)
    else:
        assert p.returncode == 2 and "usage:" in p.stderr
        assert os.listdir(repo) == ["ppde_tpu_torch"]
