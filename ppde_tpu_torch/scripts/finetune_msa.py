"""Train a family-specific MSA-Transformer evolutionary-density scorer.

    python -m ppde_tpu_torch.scripts.finetune_msa --msa A.a2m \
        --msa_model msa-S --out OUT [--n_iters 3000] [--device cpu]

Counterpart of ``scripts/finetune_msa.py``: the same flags and defaults,
plus ``--device`` (``cuda`` by default; raises without a GPU). Masked-LM
training (``training.train_msa_mlm``, plain PyTorch) of a small
``msa_transformer.CONFIGS`` entry on the protein's own .a2m, writing
``<out>_ckpt_<step>.npz`` that the scoring path loads with
``--msa_transformer_weights`` (``msa_transformer.load`` of either
package). Training view = scoring view: raw focus-column alignment rows.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ppde_tpu_torch import io, training, utils
from ppde_tpu_torch.models import msa_transformer as msat, potts_fit


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--msa", type=str, required=True,
                   help=".a2m alignment; trains on focus-column rows")
    p.add_argument("--msa_model", type=str, default="msa-S",
                   help="an msa_transformer.CONFIGS key")
    p.add_argument("--msa_transformer_weights", type=str, default=None,
                   help="base checkpoint to fine-tune: fair-esm msa1b .pt "
                        "(msa-1b only) or a native .npz; omit to train "
                        "from random init")
    p.add_argument("--out", type=str, required=True,
                   help="checkpoint prefix; writes <out>_ckpt_<step>.npz")
    p.add_argument("--n_iters", type=int, default=3000)
    p.add_argument("--block_rows", type=int, default=16,
                   help="alignment rows per training block")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--max_seqs", type=int, default=0,
                   help="subsample the family to this many rows (0 = all)")
    p.add_argument("--reweight", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="draw training rows with 1/neighborhood-size "
                        "phylogenetic weights (potts_fit.sequence_weights)")
    p.add_argument("--reweight_identity", type=float, default=0.8)
    p.add_argument("--val_frac", type=float, default=0.0,
                   help="hold out this fraction of rows and report masked "
                        "CE before/after (training.msa_mlm_heldout_ce)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(args):
    from ppde_tpu_torch.scripts.finetune_esm import split_val

    device = utils.resolve_device(args.device)
    pairs = io.load_msa(args.msa)  # parse the alignment once
    rows = [s for _, s in pairs]
    weights = None
    if args.reweight:
        weights = potts_fit.sequence_weights(
            potts_fit.msa_to_onehot(pairs),
            identity=args.reweight_identity, device=device)
        print(f"[finetune_msa] phylogenetic reweighting: effective sample "
              f"size {weights.sum():.1f} of {len(rows)}", flush=True)
    if args.max_seqs and len(rows) > args.max_seqs:
        rng = np.random.default_rng(args.seed)
        keep = rng.choice(len(rows), args.max_seqs, replace=False)
        rows = [rows[i] for i in keep]
        if weights is not None:
            weights = weights[keep]
    rows, weights, val = split_val(rows, weights, args.val_frac, args.seed)
    print(f"[finetune_msa] {len(rows)} rows of width {len(rows[0])}"
          + (f" (+{len(val)} held out)" if val else ""), flush=True)

    params = None
    if args.msa_transformer_weights:
        params = msat.load(args.msa_transformer_weights,
                           dtype=torch.float32, name=args.msa_model,
                           device=device)

    def report_val(p, tag):
        if val is None:
            return
        ce = training.msa_mlm_heldout_ce(
            p, val, name=args.msa_model, block_rows=args.block_rows,
            seed=args.seed)
        print(f"[finetune_msa] held-out masked CE {tag}: {ce:.4f} "
              f"(ppl {np.exp(ce):.2f})", flush=True)

    if val is not None:  # the trainer's own init when no weights are given
        report_val(params if params is not None else msat.init(
            torch.Generator(device=device).manual_seed(args.seed),
            torch.float32, name=args.msa_model), "before")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    params = training.train_msa_mlm(
        rows, name=args.msa_model, params=params, n_iters=args.n_iters,
        block_rows=args.block_rows, lr=args.lr, warmup=args.warmup,
        weight_decay=args.weight_decay, mask_prob=args.mask_prob,
        seed=args.seed, log_every=args.log_every, ckpt_path=args.out,
        ckpt_every=args.ckpt_every, resume=args.resume,
        seq_weights=weights, device=device)
    report_val(params, "after")
    final = f"{args.out}_ckpt_{args.n_iters}.npz"
    print(f"[finetune_msa] done; score with --msa_transformer_weights "
          f"{final} --msa_transformer_model {args.msa_model}", flush=True)
    return params


if __name__ == "__main__":
    main(build_parser().parse_args())
