"""Summarize MNIST-sum runs into the cross-sampler comparison table.

For every run prefix matching --runs_glob (the CLI's artifact naming,
scripts/mnist_sum.py), reports:
  * oracle-sum quantiles at the first and last logged step (the
    reference's central MNIST figure, reference scripts/mnist_sum.py +
    metrics.py:103-134, is this trajectory);
  * EBM log-prob of the final population under the independently trained
    EBM expert (digit-manifold check — real held-out digits score
    −169 ± 17, uniform noise −964; see PARITY.md);
  * ink fraction (real MNIST ≈ 0.13) and population diversity %.

    python -m ppde_tpu_torch.scripts.summarize_mnist_runs --score_ebm \
        --runs_glob 'results/mnist/*_r3full' \
        --out_json results/mnist/r3full_summary.json [--device cpu]

Counterpart of ``scripts/summarize_mnist_runs.py``: the same flags, rows
and rounding, plus ``--device`` (``cuda`` by default; raises without a
GPU) for the EBM's log-probabilities, which go through
``models/mnist_nets.ebm_log_prob`` of the port's MNIST energy
(``scripts/mnist_sum.build_energy``).
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np
import torch

from ppde_tpu_torch import utils


def run_prefixes(pattern):
    return sorted(p[: -len("_final_population.npy")]
                  for p in glob.glob(pattern + "_final_population.npy"))


def main(args):
    rows = []
    prefixes = run_prefixes(args.runs_glob)
    for prefix in prefixes:
        pop = np.load(prefix + "_final_population.npy")
        pop = pop.reshape(pop.shape[0], -1)
        row = {"run": os.path.basename(prefix)}
        row["diversity_pct"] = round(
            100.0 * len(np.unique(pop.round().astype(np.int8), axis=0))
            / len(pop), 1)
        row["ink_fraction"] = round(float(pop.mean()), 3)
        oc = prefix + "_oracle_sums.csv"
        if os.path.exists(oc):
            with open(oc) as f:
                rows_csv = list(csv.reader(f))
            row["oracle_quantiles"] = rows_csv[0][1:]
            row["oracle_first"] = [round(float(v), 2)
                                   for v in rows_csv[1][1:]]
            row["oracle_final"] = [round(float(v), 2)
                                   for v in rows_csv[-1][1:]]
            row["final_step"] = int(float(rows_csv[-1][0]))
        rows.append(row)

    if args.score_ebm and prefixes:
        from ppde_tpu_torch.models import mnist_nets
        from ppde_tpu_torch.scripts import mnist_sum as ms

        device = utils.resolve_device(args.device)
        ns = argparse.Namespace(mnist_weights=args.mnist_weights,
                                data_dir=args.data_dir,
                                energy_function="product_of_experts",
                                unsupervised_expert="ebm", energy_lamda=1.0)
        en = ms.build_energy(ns, device)
        for row, prefix in zip(rows, prefixes):
            pop = np.load(prefix + "_final_population.npy")
            pop = torch.from_numpy(pop.reshape(pop.shape[0], -1)).to(
                device, torch.float32)
            with torch.no_grad():
                v = mnist_nets.ebm_log_prob(en.params["unsup"],
                                            pop).cpu().numpy()
            row["ebm_logp_mean"] = round(float(v.mean()), 1)
            row["ebm_logp_std"] = round(float(v.std()), 1)

    print(json.dumps(rows, indent=2))
    if args.out_json:
        if args.merge and os.path.exists(args.out_json):
            # Raw run artifacts (*_final_population.npy) are untracked and
            # may be deleted later; --merge upserts the freshly
            # scored rows into the tracked summary by "run" key instead of
            # clobbering rows whose artifacts no longer exist on disk.
            with open(args.out_json) as f:
                existing = {r["run"]: r for r in json.load(f)}
            existing.update({r["run"]: r for r in rows})
            rows = [existing[k] for k in sorted(existing)]
        with open(args.out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--runs_glob", type=str,
                   default="results/mnist/*_r3full")
    p.add_argument("--mnist_weights", type=str,
                   default="weights/mnist_models")
    p.add_argument("--data_dir", type=str, default="data/mnist")
    p.add_argument("--out_json", type=str, default="")
    p.add_argument("--score_ebm", action="store_true")
    p.add_argument("--merge", action="store_true",
                   help="upsert rows into an existing --out_json by run "
                        "name instead of overwriting the whole file")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu: "
                        "where --score_ebm evaluates the EBM")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
