"""Fit Potts model parameters from an .a2m MSA (plmDCA pseudolikelihood).

    python -m ppde_tpu_torch.scripts.fit_potts --msa A.a2m \
        --out W/PROTEIN/potts.npz [--steps 500] [--device cpu]

Counterpart of ``scripts/fit_potts.py``: the same flags and defaults, plus
``--device`` (``cuda`` by default; raises without a GPU). Writes the
``potts.npz`` artifact (J, h, index_list, reg_coef, offset) that
``potts.load_npz`` and ``runtime.load_potts`` of either package read.
"""
from __future__ import annotations

import argparse

from ppde_tpu_torch import utils
from ppde_tpu_torch.models import potts, potts_fit


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--msa", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lambda_J", type=float, default=0.01)
    p.add_argument("--lambda_h", type=float, default=0.01)
    p.add_argument("--max_seqs", type=int, default=8192)
    p.add_argument("--no_reweight", action="store_true")
    p.add_argument("--reg_coef", type=float, default=1.0,
                   help="stored scale used by the augmented oracle feature")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    """Returns the loss history of the fit."""
    device = utils.resolve_device(args.device)
    J, h, index_list, offset, hist = potts_fit.fit_from_a2m(
        args.msa, steps=args.steps, lr=args.lr, lambda_J=args.lambda_J,
        lambda_h=args.lambda_h, max_seqs=args.max_seqs,
        reweight=not args.no_reweight, seed=args.seed, verbose=True,
        device=device)
    potts.save_npz(args.out, J, h, index_list, args.reg_coef, offset)
    print(f"saved {args.out}: L={h.shape[0]}, window "
          f"{index_list[0]}..{index_list[-1]}, final loss {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main(build_parser().parse_args())
