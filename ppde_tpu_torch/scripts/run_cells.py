"""Run many directed-evolution sweep cells inside one process.

    python -m ppde_tpu_torch.scripts.run_cells --spec cells.json
    python -m ppde_tpu_torch.scripts.run_cells --r4_evidence [--only GFP]

Counterpart of ``scripts/run_cells.py``, with its specs, names and flags:
each cell calls the port's CLI ``main`` in this process, so a grid pays
the interpreter's start and the kernels' load once, not once a cell (the
reference's sweep driver runs one process per cell,
run_protein_samplers.sh).

Spec: a JSON list of {"name": str, "argv": [str, ...]} where argv is the
``directed_evolution`` CLI's argument vector and SHOULD include
--summary_json (used for idempotent skip/restart). --r4_evidence
generates the round-4 evidence grid (the same cells as
scripts/run_r4_evidence.sh). --write_placeholders creates empty `{}`
summaries so a concurrently-queued per-process sweep skips those cells
([ -s ] check) and this runner fills them in properly later.

A cell may set "module": "mnist" to route its argv through the
``mnist_sum`` CLI instead (the MNIST CLI has no --summary_json;
idempotence uses an explicit "done_file": the run's
`<prefix>_final_population.npy`). --r4_mnist_extras generates the
round-4 MNIST evidence grid: the PoE-vs-supervised ablation trio and the
wild-type-pair replication matrix. Touching ``STOP_FILE`` makes a
running queue exit after its current cell.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# single source of truth for the calibrated lambdas: sweep_dcn.LAMBDA
# (recalibrating a protein there updates this grid too)
from ppde_tpu_torch.scripts.sweep_dcn import LAMBDA as _LAMBDA

SUM = "results/proteins/summaries"

# touch this file to make a running queue exit cleanly after its current
# cell (see the loop in main)
STOP_FILE = "/tmp/r5_stop"

PROTEINS = ["PABP_YEAST_Fields2013",
            "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio",
            "GFP_AEQVI_Sarkisyan2016"]
SHORT = {"PABP_YEAST_Fields2013": "PABP",
         "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio": "UBE4B",
         "GFP_AEQVI_Sarkisyan2016": "GFP"}
LAMBDA_POTTS = {p: format(_LAMBDA[(p, "potts")], "g") for p in PROTEINS}
SEEDS = ["1234567", "7", "42", "2024"]


def r4_evidence_spec() -> list[dict]:
    """The round-4 proteins evidence grid (mirrors run_r4_evidence.sh)."""
    cells = []

    def add(name, prot, *extra):
        cells.append({"name": name, "argv": [
            "--protein", prot, "--n_chains", "128",
            "--nmut_threshold", "10", "--disable_MSA_transformer_scoring",
            "--summary_json", f"{SUM}/{name}.json", *extra]})

    for prot in PROTEINS:
        s, lam = SHORT[prot], LAMBDA_POTTS[prot]
        for seed in SEEDS:
            add(f"{s}_PPDE-exact_s{seed}", prot, "--sampler", "PPDE",
                "--unsupervised_expert", "potts", "--energy_lamda", lam,
                "--n_iters", "10000", "--seed", seed,
                "--run_signature", "potts_exact")
        for seed in SEEDS:
            add(f"{s}_PPDE-refrev_s{seed}", prot, "--sampler", "PPDE",
                "--ppde_reference_reverse", "--unsupervised_expert",
                "potts", "--energy_lamda", lam, "--n_iters", "10000",
                "--seed", seed, "--run_signature", "potts")
        for sampler in ["simulated_annealing", "Random", "MALA-approx"]:
            add(f"{s}_{sampler}_s1234567", prot, "--sampler", sampler,
                "--unsupervised_expert", "potts", "--energy_lamda", lam,
                "--n_iters", "10000", "--seed", "1234567",
                "--run_signature", "potts")
        add(f"{s}_CMAES_s1234567", prot, "--sampler", "CMAES",
            "--unsupervised_expert", "potts", "--energy_lamda", lam,
            "--n_iters", "1000", "--seed", "1234567",
            "--run_signature", "potts")
        add(f"{s}_PPDE-pottsonly_s1234567", prot, "--sampler", "PPDE",
            "--ppde_reference_reverse", "--unsupervised_expert", "potts",
            "--energy_lamda", "0", "--n_iters", "10000",
            "--seed", "1234567", "--run_signature", "potts_only")
        add(f"{s}_PPDE-suponly_s1234567", prot, "--sampler", "PPDE",
            "--ppde_reference_reverse", "--energy_function", "supervised",
            "--unsupervised_expert", "potts", "--energy_lamda", lam,
            "--n_iters", "10000", "--seed", "1234567",
            "--run_signature", "sup_only")
    for prot in PROTEINS:
        s, lam = SHORT[prot], LAMBDA_POTTS[prot]
        add(f"{s}_PPDE-PT_s1234567", prot, "--sampler", "PPDE-PT",
            "--unsupervised_expert", "potts", "--energy_lamda", lam,
            "--n_iters", "10000", "--seed", "1234567",
            "--run_signature", "potts_pt")
    return cells


def r4_mnist_extras_spec() -> list[dict]:
    """Round-4 MNIST evidence extras (PARITY.md MNIST sections).

    Two blocks:
      * the PoE-vs-supervised ablation trio (3000 iters — EBM / DAE
        experts vs supervised-only; reference mnist scripts default
        product_of_experts, PARITY 'PoE-vs-supervised ablation'),
      * the wild-type-pair replication matrix (PPDE/SA/MALA on committed
        pairs 0/2/3/4 at the canonical 20k-iter config, plus CMA-ES on
        pair 0) — round 3 ran these but committed no machine-readable
        evidence.
    """
    cells = []

    def add(name, *extra):
        cells.append({"name": name, "module": "mnist",
                      "done_file": f"results/mnist/{name}"
                                   "_final_population.npy",
                      "argv": ["--n_chains", "128", "--log_every", "100",
                               "--seed", "1234567", *extra]})

    for expert, suffix in (("ebm", "poe_ebm_r4"), ("dae", "poe_dae_r4")):
        add(f"PPDE-PAS-10_product_of_experts_{suffix}",
            "--sampler", "PPDE", "--ppde_pas_length", "10",
            "--energy_lamda", "10", "--n_iters", "3000", "--wild_type",
            "1", "--unsupervised_expert", expert, "--suffix", suffix)
    add("PPDE-PAS-10_supervised_sup_only_r4",
        "--sampler", "PPDE", "--ppde_pas_length", "10",
        "--energy_lamda", "10", "--n_iters", "3000", "--wild_type", "1",
        "--energy_function", "supervised", "--suffix", "sup_only_r4")

    for wt in ("0", "2", "3", "4"):
        sfx = f"r4full_wt{wt}"
        add(f"PPDE-PAS-10_product_of_experts_{sfx}",
            "--sampler", "PPDE", "--ppde_pas_length", "10",
            "--energy_lamda", "10", "--n_iters", "20000",
            "--wild_type", wt, "--suffix", sfx)
        add(f"SA_product_of_experts_{sfx}",
            "--sampler", "simulated_annealing", "--energy_lamda", "10",
            "--n_iters", "20000", "--wild_type", wt, "--suffix", sfx)
        add(f"MALA-approx_product_of_experts_{sfx}",
            "--sampler", "MALA-approx", "--energy_lamda", "10",
            "--diffusion_step_size", "0.01", "--n_iters", "20000",
            "--wild_type", wt, "--suffix", sfx)
    add("CMAES_product_of_experts_r4full_wt0",
        "--sampler", "CMAES", "--energy_lamda", "10", "--n_iters",
        "20000", "--wild_type", "0", "--suffix", "r4full_wt0")
    return cells


def r5_family_spec(n_iters: int = 10000) -> list[dict]:
    """The 24 family-expert cells at the canonical sweep depth.

    Round 4 ran the 3-protein × {potts+transformer-S, transformer-S} ×
    4-seed family matrix at 2500 iters; the reference's canonical protein
    sweeps run 10,000 (reference scripts/run_protein_samplers.sh, README.md
    Tables 1-2 setup). Identical configs and summary paths to the committed
    round-4 cells (results/esm_family/*.json) so the PARITY tables
    regenerate in place; each cell carries expect={"n_iters": N} so a
    relaunch skips completed full-depth cells and re-runs shallow ones.

    Expert checkpoints (119 MB, untracked) must exist — regenerate with
    scripts/run_r5_family10k.sh (which wraps this spec).
    """
    msa = {
        "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio":
            "data/proteins/UBE4B_MOUSE.a2m",
        "PABP_YEAST_Fields2013":
            "data/proteins/synthetic/PABP_YEAST_Fields2013_synth.a2m",
        "GFP_AEQVI_Sarkisyan2016":
            "data/proteins/synthetic/GFP_AEQVI_Sarkisyan2016_synth.a2m",
    }
    cells = []
    # UBE4B first: it is the one real-MSA protein, so if a sweep is cut
    # short the flagship cells land before the synthetic-family ones.
    order = sorted(PROTEINS, key=lambda p: SHORT[p] != "UBE4B")
    for prot in order:
        s = SHORT[prot]
        lam = format(_LAMBDA[(prot, "transformer-M")], "g")  # published λ
        ckpt = f"results/esm_family/{prot}_transformer-S_ckpt_4000.npz"
        scorer = f"results/esm_family/{s}_msat_S_ckpt_2000.npz"
        for expert in ("potts+transformer-S", "transformer-S"):
            tag = expert.replace("+", "_")
            for seed in SEEDS:
                name = f"{s}_PPDE-{tag}_family_s{seed}"
                cells.append({
                    "name": name,
                    "expect": {"n_iters": n_iters},
                    "argv": [
                        "--protein", prot, "--sampler", "PPDE",
                        "--unsupervised_expert", expert,
                        "--esm_weights", ckpt,
                        "--energy_lamda", lam,
                        "--n_iters", str(n_iters), "--n_chains", "128",
                        "--nmut_threshold", "10", "--seed", seed,
                        "--run_signature", f"{tag}_family",
                        "--msa_transformer_model", "msa-S",
                        "--msa_transformer_weights", scorer,
                        "--msa_path", msa[prot], "--msa_size", "500",
                        "--summary_json", f"results/esm_family/{name}.json",
                    ]})
    return cells


def r5_scalematch_spec() -> list[dict]:
    """UBE4B canonical cells on the scale-matched Potts artifact.

    VERDICT r4 'Next #1': the refit UBE4B Potts ranks mutants like the
    missing original but its Hamiltonian is ~4.4x hotter, shifting absolute
    oracle log-fitness (PPDE p50 0.13 vs paper Table 2's 1.32).
    scripts/calibrate_oracle_scale.py built a scale-matched artifact
    (weights/.../potts_scalematched.npz, calibration record in
    results/qc/ube4b_oracle_scale_calibration.jsonl); these cells re-run the
    canonical UBE4B grid (PPDE ref-rev + corrected + the four baselines,
    published lambda=0.5, seed 1234567 — reference README.md:65-72,
    run_protein_samplers.sh) against it under fresh '-scalematch' summary
    names so the committed evidence rows stay untouched.
    """
    prot = "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio"
    npz = f"weights/{prot}/potts_scalematched.npz"
    lam = LAMBDA_POTTS[prot]
    cells = []

    def add(name, *extra):
        cells.append({"name": name, "argv": [
            "--protein", prot, "--n_chains", "128",
            "--nmut_threshold", "10", "--disable_MSA_transformer_scoring",
            "--potts_npz", npz, "--unsupervised_expert", "potts",
            "--energy_lamda", lam, "--seed", "1234567",
            "--summary_json", f"{SUM}/{name}.json", *extra]})

    add("UBE4B_PPDE-refrev-scalematch_s1234567", "--sampler", "PPDE",
        "--ppde_reference_reverse", "--n_iters", "10000",
        "--run_signature", "potts_scalematch")
    add("UBE4B_PPDE-exact-scalematch_s1234567", "--sampler", "PPDE",
        "--n_iters", "10000", "--run_signature", "potts_scalematch_exact")
    for sampler in ["simulated_annealing", "Random", "MALA-approx"]:
        add(f"UBE4B_{sampler}-scalematch_s1234567", "--sampler", sampler,
            "--n_iters", "10000", "--run_signature", "potts_scalematch")
    add("UBE4B_CMAES-scalematch_s1234567", "--sampler", "CMAES",
        "--n_iters", "1000", "--run_signature", "potts_scalematch")
    return cells


def r5_baseline_seeds_spec() -> list[dict]:
    """Seed-spread for the non-PPDE baselines (VERDICT r4 'Next #4').

    PPDE has a 12-cell seed-spread table; Random/SA/MALA/CMA-ES rows rest
    on seed 1234567 alone. These are the identical canonical configs
    (r4_evidence_spec) at seeds 7/42/2024, all three proteins — the
    baseline signatures (flat-line SA, degenerate CMA-ES population)
    should replicate like PPDE's.
    """
    cells = []

    def add(name, prot, *extra):
        cells.append({"name": name, "argv": [
            "--protein", prot, "--n_chains", "128",
            "--nmut_threshold", "10", "--disable_MSA_transformer_scoring",
            "--summary_json", f"{SUM}/{name}.json", *extra]})

    for prot in PROTEINS:
        s, lam = SHORT[prot], LAMBDA_POTTS[prot]
        for seed in ["7", "42", "2024"]:
            for sampler in ["simulated_annealing", "Random", "MALA-approx"]:
                add(f"{s}_{sampler}_s{seed}", prot, "--sampler", sampler,
                    "--unsupervised_expert", "potts", "--energy_lamda",
                    lam, "--n_iters", "10000", "--seed", seed,
                    "--run_signature", "potts")
            add(f"{s}_CMAES_s{seed}", prot, "--sampler", "CMAES",
                "--unsupervised_expert", "potts", "--energy_lamda", lam,
                "--n_iters", "1000", "--seed", seed,
                "--run_signature", "potts")
    return cells


def r5_mnist_cmaes_spec() -> list[dict]:
    """The missing MNIST CMA-ES wild-type pairs (VERDICT r4 'Next #7').

    PPDE/SA/MALA cover all five committed pairs at the canonical 20k-iter
    config; CMA-ES covers pairs 0 (r4fullwt) and 1 (r4full) only.
    Reference mnist_sum.py runs any pair (:92-109)."""
    cells = []
    for wt in ("2", "3", "4"):
        sfx = f"r4full_wt{wt}"
        name = f"CMAES_product_of_experts_{sfx}"
        cells.append({"name": name, "module": "mnist",
                      "done_file": f"results/mnist/{name}"
                                   "_final_population.npy",
                      "argv": ["--n_chains", "128", "--log_every", "100",
                               "--seed", "1234567", "--sampler", "CMAES",
                               "--energy_lamda", "10", "--n_iters",
                               "20000", "--wild_type", wt,
                               "--suffix", sfx]})
    return cells


def summary_state(cell) -> str:
    """'missing' | 'placeholder' | 'stale' | 'done' for the cell's summary.

    A cell may carry an "expect" dict ({summary_key: value}); an existing
    summary whose JSON disagrees on any expected key is 'stale' and gets
    re-run (used by --r5_family to upgrade the round-4 2500-iter family
    cells to the canonical 10,000 iters in place, idempotently — completed
    10k cells are skipped on relaunch, VERDICT r4 'Missing #3')."""
    if "done_file" in cell:
        path = cell["done_file"]
        return ("done" if os.path.exists(path)
                and os.path.getsize(path) > 0 else "missing")
    argv = cell["argv"]
    try:
        path = argv[argv.index("--summary_json") + 1]
    except ValueError:
        return "missing"
    if not os.path.exists(path):
        return "missing"
    with open(path) as f:
        content = f.read().strip()
    if content in ("", "{}"):
        return "placeholder"
    expect = cell.get("expect")
    if expect:
        try:
            summary = json.loads(content)
        except ValueError:
            return "placeholder"
        if not isinstance(summary, dict):
            return "placeholder"
        if any(summary.get(k) != v for k, v in expect.items()):
            return "stale"
    return "done"


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", type=str, default=None,
                    help="JSON list of {name, argv} cells")
    ap.add_argument("--r4_evidence", action="store_true",
                    help="use the built-in round-4 evidence grid")
    ap.add_argument("--r4_mnist_extras", action="store_true",
                    help="use the built-in round-4 MNIST extras grid "
                         "(ablation trio + wild-type replication)")
    ap.add_argument("--r5_family", action="store_true",
                    help="the 24 family-expert cells at canonical depth "
                         "(see r5_family_spec)")
    ap.add_argument("--r5_scalematch", action="store_true",
                    help="UBE4B canonical cells on the scale-matched "
                         "Potts artifact (see r5_scalematch_spec)")
    ap.add_argument("--r5_baseline_seeds", action="store_true",
                    help="seed-spread for the non-PPDE baselines "
                         "(see r5_baseline_seeds_spec)")
    ap.add_argument("--r5_mnist_cmaes", action="store_true",
                    help="the missing MNIST CMA-ES wild-type pairs "
                         "(see r5_mnist_cmaes_spec)")
    ap.add_argument("--family_iters", type=int, default=10000,
                    help="sweep depth for --r5_family cells")
    ap.add_argument("--write_placeholders", action="store_true",
                    help="create empty '{}' summaries for missing cells "
                         "(so a concurrent per-process sweep skips them), "
                         "then exit without running anything")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells whose summary is already real")
    ap.add_argument("--only", type=str, default=None,
                    help="substring filter on cell names")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.r4_evidence:
        cells = r4_evidence_spec()
    elif args.r4_mnist_extras:
        cells = r4_mnist_extras_spec()
    elif args.r5_family:
        cells = r5_family_spec(args.family_iters)
    elif args.r5_scalematch:
        cells = r5_scalematch_spec()
    elif args.r5_baseline_seeds:
        cells = r5_baseline_seeds_spec()
    elif args.r5_mnist_cmaes:
        cells = r5_mnist_cmaes_spec()
    elif args.spec:
        with open(args.spec) as f:
            cells = json.load(f)
    else:
        raise SystemExit("need --spec or --r4_evidence")
    if args.only:
        cells = [c for c in cells if args.only in c["name"]]

    if args.write_placeholders:
        n = skipped = 0
        for c in cells:
            argv = c["argv"]
            # done_file/mnist cells have no --summary_json to placeholder
            if "done_file" in c or "--summary_json" not in argv:
                skipped += 1
                continue
            if summary_state(c) == "missing":
                path = argv[argv.index("--summary_json") + 1]
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                with open(path, "w") as f:
                    f.write("{}")
                n += 1
        print(f"[run_cells] wrote {n} placeholders"
              + (f" ({skipped} cells have no summary path)" if skipped
                 else ""))
        return

    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import mnist_sum as ms

    parsers = {"de": de.build_parser(), "mnist": ms.build_parser()}
    mains = {"de": de.main, "mnist": ms.main}
    done = failed = skipped = 0
    for c in cells:
        if os.path.exists(STOP_FILE):
            # Graceful deadline stop: finish the current cell, leave the
            # rest for an idempotent relaunch.
            print(f"[run_cells] stop file {STOP_FILE} present — draining "
                  "queue early", flush=True)
            break
        state = summary_state(c)
        if state == "done" and not args.force:
            skipped += 1
            continue
        mod = c.get("module", "de")
        print(f"=== [run_cells {time.strftime('%H:%M:%S')}] {c['name']}",
              flush=True)
        try:
            mains[mod](parsers[mod].parse_args(c["argv"]))
            done += 1
        except SystemExit as e:
            # argparse rejects a malformed argv with sys.exit(2); a bad
            # cell must not abort the whole queue
            if e.code in (0, None):
                # exit 0 can also mean the cell never sampled (e.g. a
                # --help in its argv exits 0 before writing a summary);
                # only count it done if the summary actually materialized
                if summary_state(c) == "done":
                    done += 1
                else:
                    print(f"[run_cells] FAILED (exit 0 but summary "
                          f"{summary_state(c)}): {c['name']}", flush=True)
                    failed += 1
            else:
                traceback.print_exc()
                print(f"[run_cells] FAILED (exit {e.code}): {c['name']}",
                      flush=True)
                failed += 1
        except Exception:
            traceback.print_exc()
            print(f"[run_cells] FAILED: {c['name']}", flush=True)
            failed += 1
    print(f"[run_cells] done={done} skipped={skipped} failed={failed}")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
