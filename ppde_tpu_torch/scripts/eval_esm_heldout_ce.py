"""Held-out masked-LM cross-entropy for an ESM2 checkpoint vs random init.

    python -m ppde_tpu_torch.scripts.eval_esm_heldout_ce \
        --msa data/proteins/UBE4B_MOUSE.a2m \
        --wt_fasta weights/UBE4B_.../wt.fasta \
        --ckpt results/esm_family/..._ckpt_4000.npz [--device cpu]

Counterpart of ``tools/eval_esm_heldout_ce.py``: the same flags and
defaults, plus ``--device`` (``cuda`` by default; raises without a GPU).
Holds out the validation split ``finetune_esm --msa --wt_fasta --val_frac
--seed`` holds out (the family in wild-type context, a numpy draw from
``seed + 1``; taken from ``finetune_esm`` itself), then reports
``training.esm_mlm_heldout_ce`` for the random-init config and for each
given checkpoint, with the fine-tune's call and seed: on the same
``--seed`` the random-init line is the fine-tune's "before" line and a
checkpoint's line its "after" line (the before/after record when a
training log was lost, or checkpoints compared across runs). On the card
each CE runs kernel C, layers x 4 launches (forward only).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ppde_tpu_torch import io, training, utils
from ppde_tpu_torch.models import esm2
from ppde_tpu_torch.scripts import finetune_esm


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--msa", required=True)
    p.add_argument("--wt_fasta", required=True)
    p.add_argument("--esm_model", default="transformer-S")
    p.add_argument("--val_frac", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", nargs="*", default=[])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def heldout_split(msa: str, wt_fasta: str, val_frac: float,
                  seed: int) -> list[str]:
    """The sequences ``finetune_esm`` holds out with these flags."""
    wt = io.read_fasta(wt_fasta)[0]
    seqs = finetune_esm.family_in_wt_context(io.load_msa(msa), msa, wt)
    return finetune_esm.split_val(seqs, None, val_frac, seed)[2]


def main(args):
    """-> {"n_heldout", "length", "random_init", <checkpoint name>: CE}."""
    device = utils.resolve_device(args.device)
    val = heldout_split(args.msa, args.wt_fasta, args.val_frac, args.seed)
    print(f"{len(val)} held-out sequences of length {len(val[0])}",
          flush=True)
    out = {"n_heldout": len(val), "length": len(val[0])}

    def report(params, label):
        ce = training.esm_mlm_heldout_ce(params, val, name=args.esm_model,
                                         seed=args.seed)
        print(f"{label}: heldout CE {ce:.4f} (ppl {np.exp(ce):.1f})",
              flush=True)
        return ce

    out["random_init"] = report(esm2.init(
        torch.Generator(device=device).manual_seed(args.seed),
        args.esm_model, torch.float32), f"random-init {args.esm_model}")
    for path in args.ckpt:
        load = (esm2.load_npz_checkpoint if path.endswith(".npz")
                else esm2.load_torch_checkpoint)
        name = os.path.basename(path)
        out[name] = report(load(path, args.esm_model, torch.float32, device),
                           name)
    return out


if __name__ == "__main__":
    main(build_parser().parse_args())
