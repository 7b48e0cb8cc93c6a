"""Re-score saved protein populations with the MSA Transformer.

    python -m ppde_tpu_torch.scripts.eval_proteins --runs_glob 'R/*/*' \
        --protein_weights W --protein P --msa_path A.a2m [--device cpu]

Counterpart of ``scripts/eval_proteins.py`` (reference
scripts/eval_proteins.py:27-45): the same flags and defaults, plus
``--device`` (``cuda`` by default; raises without a GPU). For each run
directory with a ``population.npy`` it writes ``transformer_scores.npy``;
with ``--update_summary`` it folds the density quantiles into the run's
``summary.json`` and its stable ``--summary_json`` copy.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ppde_tpu_torch import metrics, runtime, utils


def main(args):
    device = utils.resolve_device(args.device)
    run_dirs = sorted(glob.glob(args.runs_glob))
    if not run_dirs:
        print(f"no runs match {args.runs_glob}")
        return
    protein_dir = os.path.join(args.protein_weights, args.protein)
    for rd in run_dirs:
        pop_path = os.path.join(rd, "population.npy")
        if not os.path.exists(pop_path):
            continue
        pop = np.load(pop_path)
        scores = metrics.proteins_transformer_score(
            pop, protein_dir, args.msa_path, args.msa_size,
            weights_path=args.msa_transformer_weights,
            allow_random=args.allow_random_esm,
            msa_model=args.msa_transformer_model, device=device)
        np.save(os.path.join(rd, "transformer_scores.npy"), scores)
        print(f"{rd}: median {np.median(scores):.3f} "
              f"max {scores.max():.3f}")
        if args.update_summary:
            update_summaries(rd, scores, args)


def update_summaries(run_dir, scores, args):
    """Fold post-hoc evolutionary-density quantiles into the run's
    summary.json and its stable --summary_json copy, keeping the two
    identical. A stable copy that a newer run of the same cell owns (its
    other keys differ from this run's) is left as it is."""
    sp = os.path.join(run_dir, "summary.json")
    if not os.path.exists(sp):
        return
    with open(sp) as f:
        summary = json.load(f)
    summary["evolutionary_density"] = runtime._q(scores)
    summary["msa_transformer_model"] = args.msa_transformer_model
    summary["msa_transformer_weights"] = args.msa_transformer_weights
    summary["density_msa_path"] = args.msa_path
    summary["density_msa_size"] = args.msa_size
    added = ("evolutionary_density", "msa_transformer_model",
             "msa_transformer_weights", "density_msa_path",
             "density_msa_size")
    targets = [sp]
    if summary.get("summary_json"):
        targets.append(summary["summary_json"])
    for t in targets:
        if t != sp and os.path.exists(t):
            try:
                with open(t) as f:
                    stable = json.load(f)
            except ValueError:
                stable = None
            if not isinstance(stable, dict):
                stable = None  # non-dict JSON: corrupt or a placeholder
            if stable:  # {} placeholders are fair game
                def strip(d):
                    return {k: v for k, v in d.items() if k not in added}
                if strip(stable) != strip(summary):
                    print(f"  SKIPPED stale stable copy {t}: its contents "
                          f"no longer match {run_dir} (a newer run owns "
                          "it) — re-run eval against the owning run dir")
                    continue
        with open(t, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"  updated {t}")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs_glob", type=str,
                   default="results/proteins/*/*")
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str, default="PABP_YEAST_Fields2013")
    p.add_argument("--msa_path", type=str,
                   default="data/proteins/PABP_YEAST.a2m")
    p.add_argument("--msa_size", type=int, default=500)
    p.add_argument("--msa_transformer_weights", type=str, default=None)
    p.add_argument("--msa_transformer_model", type=str, default="msa-1b")
    p.add_argument("--allow_random_esm", action="store_true")
    p.add_argument("--update_summary", action="store_true",
                   help="fold density quantiles into each run's "
                        "summary.json and its stable --summary_json copy")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
