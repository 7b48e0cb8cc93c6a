"""Predicted wall seconds of each evidence driver at its real settings on
one card, from a chip_smoke.py run's saved results.

    python -m ppde_tpu_torch.scripts.predict_driver_wall \
        chiprun_out/chip_smoke.json [--rest OTHER.json]

Phase 15's ``evidence`` results give the family cells, the batch-64
fine-tune, the evidence flags' runs, the Potts QC, the scorer evaluation
and the MNIST summary; phases 7, 9, 11 and 14 (``cli``, ``mnist``,
``training``, ``large``) give the runs phase 15 does not repeat. A file
written by phase 15 alone holds ``evidence`` only: ``--rest`` then names a
whole run's file to take the other phases from. Prints one JSON object,
driver → seconds, at GFP's length (L = 237; the drivers' UBE4B and PABP
cells run other lengths, not measured).
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def predict(ev, res):
    """Each evidence driver's predicted wall seconds, from phase 15's
    results ``ev`` and a whole run's results ``res``: each process a
    driver starts pays ``process_start_s``; a run of n steps its set-up
    and tail (the run's seconds less its steps over its steps/s) plus n
    over its steps/s; a family cell its scoring time and phase 15's set-up
    and tail outside sampling and scoring (the first cell's in a fresh
    process, the later cells' inside run_cells)."""
    start = ev["process_start_s"]
    fam = ev["family_cells"]
    rate = {e: float(np.mean([c["steps_per_sec"] for c in fam["cells"]
                              if c["expert"] == e]))
            for e in ("potts+transformer-S", "transformer-S")}
    score = float(np.mean([c["msa_s_scoring_s"] for c in fam["cells"]]))

    def cell(expert, n, first=True):
        """A family cell's work: set-up and tail, sampling, scoring."""
        return (fam["outside_first_cell_s"] if first else
                fam["outside_later_cells_mean_s"]) + n / rate[expert] + score

    def timed(r, n, process=True):
        """A run like ``r`` (its main_s over its steps at its steps/s) at
        n steps, in a process of its own or not."""
        sps = r["steps_per_sec"]
        return start * process + max(r["main_s"] - r["steps"] / sps,
                                     0.0) + n / sps

    flags = {r["run"]: r for r in ev["evidence_flags"]}
    cli = {r["run"]: r for r in res["cli"]}
    mn = {r["run"]: r for r in res["mnist"]}
    for r in ev["scorer_mnist"]["mnist"]:
        mn["r4full " + r["run"]] = dict(r)
    ft = ev["finetune"]
    msa_ft = res["training"]["finetune_msa_S"]
    qc = ev["qc"]
    fit = start + qc["fit_potts"]["main_s"]
    sel = start + qc["select_lambda"]["main_s"]
    cal = start + float(np.mean([r["main_s"] for r in
                                 qc["calibrate_oracle_scale"]]))
    smp = qc["sample_potts_msa"]

    def sample(sweeps):  # the 8192-sequence rate: an upper bound below it
        return start + smp["main_s"] - smp["gibbs_s"] + sweeps / smp[
            "sweeps_per_sec"]

    def large(script, ft_steps, cell_steps):
        row = res["large"][script]
        return (timed(row["finetune"], ft_steps) +
                timed(row["cell"], cell_steps))

    scorer_eval = 3 * sum(start + r["main_s"] for r in
                          ev["scorer_mnist"]["scorer_eval"].values())
    family10k = 3 * timed(ft, 4000) + start + sum(
        cell(e, 10000, first=(i == 0))
        for i, e in enumerate(["potts+transformer-S"] * 12
                              + ["transformer-S"] * 12))
    family_cells = 3 * timed(msa_ft, 2000) + 3 * sum(
        start + cell(e, 2500) for e in rate)
    ppde = flags["GFP_PPDE-refrev_s1234567"]
    proteins = 3 * (8 * timed(ppde, 10000) + timed(cli["SA"], 10000)
                    + timed(cli["Random"], 10000)
                    + timed(cli["MALA-approx"], 10000)
                    + timed(flags["GFP_CMAES_s1234567"], 1000)
                    + timed(flags["GFP_PPDE-pottsonly_s1234567"], 10000)
                    + timed(flags["GFP_PPDE-suponly_s1234567"], 10000)
                    + timed(flags["UBE4B_PPDE-PT-suponly_s1234567"], 10000))
    pas, pt = (r for k, r in mn.items() if k.startswith("r4full "))
    mnist = (timed(pas, 20000) + timed(pt, 20000)
             + 2 * (timed(mn["SA"], 20000) + timed(mn["MALA-approx"], 20000)
                    + timed(mn["CMAES"], 20000))
             + 2 * (start + ev["scorer_mnist"]["mnist_summary"]["main_s"]))
    qc_phase = (sample(300) + sample(600) + sample(600) + sample(1200)
                + 3 * (fit + sel + sample(600)))
    pt_phase = (timed(flags["UBE4B_PPDE-suponly-exact_s1234567"], 10000)
                + timed(flags["UBE4B_PPDE-PT-suponly_s1234567"], 10000))
    # run_cells: one process a grid
    baseline = start + 9 * (sum(
        timed(cli[k], 10000, False) for k in ("SA", "Random", "MALA-approx"))
        + timed(flags["GFP_CMAES_s1234567"], 1000, False))
    m150 = large("run_r5_150m", 1200, 1000)
    remaining = (baseline + m150 + family10k + start
                 + 3 * timed(mn["CMAES"], 20000, False))
    return {
        "run_r5_family10k.sh": family10k,
        "run_r4_family_cells.sh": family_cells,
        "run_r4_evidence.sh proteins": proteins,
        "run_r4_evidence.sh mnist": mnist,
        "run_r4_qc_pt.sh qc": qc_phase, "run_r4_qc_pt.sh pt": pt_phase,
        "run_r5_ljdecision.sh": 2 * (fit + cal),
        "run_r4_scorer_eval.sh": scorer_eval,
        "run_r5_remaining.sh": remaining,
        "run_r4_all.sh": (family_cells + proteins + mnist + qc_phase
                          + pt_phase + large("run_r4_650m", 800, 1000)),
        "process_start_s": start}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", nargs="?",
                   default="chiprun_out/chip_smoke.json",
                   help="chip_smoke.py's saved results (phase 15's "
                        "'evidence' at least)")
    p.add_argument("--rest", default=None,
                   help="a whole run's results, for phases 7-14 when "
                        "RESULTS holds phase 15 alone")
    return p


def main(args):
    with open(args.results) as f:
        res = json.load(f)
    if args.rest:
        with open(args.rest) as f:
            res = {**json.load(f), "evidence": res["evidence"]}
    out = predict(res["evidence"], res)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main(build_parser().parse_args())
