"""Write a protein directory of seeded stand-ins in the reference layouts.

    python -m ppde_tpu_torch.scripts.seeded_protein --out DIR \
        --protein NAME --wt_seq SEQUENCE [--seed 0]

makes DIR/NAME/ with what ``runtime.build_protein_energy`` reads:
``wt.fasta``, ``onehot_cnn_seed={0,1,2}.pt`` (reference OnehotCNN state
dicts from a seeded ``cnn.init_ensemble``, hidden width len(wt)) and the 20
oracle pickles ``results-predictor=ev+onehot-train=-1-seed={s}-linear.pkl``
(coef_ [1+L*V], intercept_, reg_coef from a numpy seed). No Potts artifact
is written, so a run takes the deterministic synthetic Potts fallback, as
it does for the proteins whose potts.pkl is a missing blob. Both packages
read the same files, so their runs on such a directory can be compared.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ppde_tpu_torch import codec
from ppde_tpu_torch.models import cnn, oracle, torch_convert


def write_protein_dir(out: str, protein: str, wt_seq: str, seed: int = 0,
                      n_members: int = 3, n_heads: int = 20) -> str:
    """Write the directory; returns its path."""
    path = os.path.join(out, protein)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "wt.fasta"), "w") as f:
        f.write(f">{protein}\n{wt_seq}\n")
    ens = cnn.init_ensemble(torch.Generator().manual_seed(seed), n_members,
                            input_size=len(wt_seq))
    for m in range(n_members):
        member = {layer: {k: v[m] for k, v in ens[layer].items()}
                  for layer in ens}
        torch_convert.save_onehot_cnn(
            os.path.join(path, f"onehot_cnn_seed={m}.pt"), member)
    rng = np.random.default_rng(seed)
    d = 1 + len(wt_seq) * codec.VOCAB_SIZE
    for p in oracle.head_paths(path, n_heads):
        coef = rng.normal(0.0, 0.01, d)
        coef[0] += 0.5  # weight the evolutionary feature
        torch_convert.save_linear_oracle_head(
            p, coef, rng.normal(0.0, 0.1), rng.uniform(0.5, 2.0))
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--protein", required=True)
    p.add_argument("--wt_seq", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(write_protein_dir(args.out, args.protein, args.wt_seq, args.seed))


if __name__ == "__main__":
    main()
