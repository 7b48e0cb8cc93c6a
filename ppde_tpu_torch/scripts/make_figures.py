"""Aggregate protein run artifacts into the paper's tables and figures.

    python -m ppde_tpu_torch.scripts.make_figures --runs_glob 'R/*/*' \
        --protein_weights W --protein P --out_json S.json [--plots]

Counterpart of ``scripts/make_figures.py`` (reference
scripts/make_figures.py): per run directory, diversity % (unique variants,
:38-49), exploration (:29-36) and the p50 / p100 of the oracle log-fitness,
the evolutionary density and the energy (:81-103), as one JSON list;
``--plots`` draws each run's per-chain running-max energy (:192-236) and
imports matplotlib only then. The same flags and defaults, plus
``--device`` (``cuda`` by default; raises without a GPU), which is only
checked: the summary is a few numpy reductions on the host.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ppde_tpu_torch import codec, io as pio, metrics, utils


def summarize_run(rd: str, wt_onehot):
    out = {"run": rd}
    pop = np.load(os.path.join(rd, "population.npy"))
    out["diversity_pct"] = metrics.diversity_pct(pop)
    mean_m, std_m = metrics.exploration(pop, wt_onehot)
    out["exploration_mean"] = mean_m
    out["exploration_std"] = std_m
    for name, key in [("oracle_fitness_scores.npy", "log_fitness"),
                      ("transformer_scores.npy", "evolutionary_density"),
                      ("energy_scores.npy", "energy")]:
        path = os.path.join(rd, name)
        if os.path.exists(path):
            v = np.load(path)
            out[f"{key}_p50"] = float(np.quantile(v, 0.5))
            out[f"{key}_p100"] = float(v.max())
    return out


def main(args):
    utils.resolve_device(args.device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    wt_onehot = codec.seqs_to_onehot([wt])[0]

    rows = []
    for rd in sorted(glob.glob(args.runs_glob)):
        if os.path.exists(os.path.join(rd, "population.npy")):
            rows.append(summarize_run(rd, wt_onehot))
    if not rows:
        print(f"no runs match {args.runs_glob}")
        return

    print(json.dumps(rows, indent=2))
    with open(args.out_json, "w") as f:
        json.dump(rows, f, indent=2)

    if args.plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for rd in sorted(glob.glob(args.runs_glob)):
            hist = os.path.join(rd, "energy_history.npy")
            if not os.path.exists(hist):
                continue
            e = np.load(hist)  # [steps, chains]
            running_max = np.maximum.accumulate(e, axis=0)
            plt.figure()
            plt.plot(running_max[:, : args.max_chains_plotted], alpha=0.5,
                     linewidth=0.8)
            plt.xlabel("step")
            plt.ylabel("running max energy")
            plt.title(os.path.basename(rd))
            plt.tight_layout()
            plt.savefig(os.path.join(rd, "chain_running_max.png"))
            plt.close()
    return rows


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs_glob", type=str, default="results/proteins/*/*")
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str, default="PABP_YEAST_Fields2013")
    p.add_argument("--out_json", type=str, default="results/summary.json")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--max_chains_plotted", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
    main(args)
