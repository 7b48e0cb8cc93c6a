"""Calibrate the product-of-experts weight lambda per (protein, expert).

    python -m ppde_tpu_torch.scripts.select_lambda --protein_weights W \
        --protein P [--potts_npz F] [--out_json J] [--device cpu]

Counterpart of ``scripts/select_lambda.py``, the JAX package's working
replacement for the reference's stale script: pick lambda so the scale
(stddev over random single mutants) of the supervised term matches the
unsupervised expert's. The same flags and defaults, plus ``--device``
(``cuda`` by default; raises without a GPU).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, runtime, utils
from ppde_tpu_torch.models import cnn, potts as potts_mod


def main(args):
    device = utils.resolve_device(args.device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    if args.potts_npz:
        # calibrate against an alternative fit without touching the
        # protein directory's own artifact
        pp = potts_mod.load_npz(args.potts_npz, wt, device=device)
    else:
        pp = runtime.load_potts(protein_dir, device=device)
    sup = runtime.load_supervised_ensemble(protein_dir, device=device)

    rng = np.random.default_rng(args.seed)
    wt_idx = codec.seqs_to_ints([wt])[0]
    muts = []
    for _ in range(args.n_mutants):
        x = wt_idx.copy()
        pos = rng.integers(pp.min_pos, pp.max_pos + 1)
        x[pos] = rng.integers(0, 20)
        muts.append(x)
    x = torch.from_numpy(codec.ints_to_onehot(np.stack(muts)).astype(
        np.float32)).to(device)

    with torch.no_grad():
        unsup = potts_mod.score(pp, x, delta=True).cpu().numpy()
        fit = cnn.ensemble_apply(sup, x).cpu().numpy()
    lam = float(unsup.std() / max(fit.std(), 1e-9))
    print(f"{args.protein}: std(unsup)={unsup.std():.4f} "
          f"std(fit)={fit.std():.4f} -> lambda ~= {lam:.2f}")
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "a") as f:
            f.write(json.dumps(
                {"protein": args.protein, "potts_npz": args.potts_npz or
                 None, "n_mutants": args.n_mutants, "seed": args.seed,
                 "std_unsup": round(float(unsup.std()), 4),
                 "std_fit": round(float(fit.std()), 4),
                 "lambda": round(lam, 3)}) + "\n")
    return lam


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str, default="PABP_YEAST_Fields2013")
    p.add_argument("--n_mutants", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--potts_npz", type=str, default="",
                   help="calibrate against this Potts fit instead of the "
                        "protein dir's artifact")
    p.add_argument("--out_json", type=str, default="",
                   help="append the calibration record as one JSON line")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
