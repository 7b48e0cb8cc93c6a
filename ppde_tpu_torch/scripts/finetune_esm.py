"""Fine-tune an ESM2 transformer expert on a protein family MSA.

    python -m ppde_tpu_torch.scripts.finetune_esm --msa A.a2m \
        [--wt_fasta wt.fasta] --esm_model transformer-S --out OUT \
        [--n_iters 5000] [--lora_rank 8] [--val_frac 0.1] [--device cpu]

Counterpart of ``scripts/finetune_esm.py``: the same flags and defaults,
plus ``--device`` (``cuda`` by default; raises without a GPU). Masked-LM
fine-tuning (``training.train_esm_mlm``, kernels C and C' on the card) on
the .a2m alignment the Potts expert is fit from, writing
``<out>_ckpt_<step>.npz`` that the protein CLI loads with
``--esm_weights`` (``esm2.load_npz_checkpoint`` of either package). With
``--lora_rank`` the cadence checkpoints hold the adapters
(``<out>_lora_<step>.npz``) and the merged model is written as
``<out>_ckpt_<n_iters>.npz``. ``--mesh_dp N`` > 1 trains data-parallel
over N processes, one per device, started by a launcher:

    torchrun --nproc_per_node N -m ppde_tpu_torch.scripts.finetune_esm \
        ... --mesh_dp N

(the backend follows ``--device``: nccl on CUDA, gloo on the CPU); rank 0
prints and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ppde_tpu_torch import io, training, utils
from ppde_tpu_torch.models import esm2, potts_fit
from ppde_tpu_torch.parallel import mesh as pmesh


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--msa", type=str, default=None,
                     help=".a2m MSA; trains on focus columns (gaps map to "
                          "the ESM '-' token), the same view the Potts fit "
                          "uses")
    src.add_argument("--fasta", type=str, default=None,
                     help="FASTA of equal-length unaligned sequences")
    p.add_argument("--wt_fasta", type=str, default=None,
                   help="with --msa: embed each family row's focus-column "
                        "residues into this full wild-type sequence (gaps "
                        "impute the WT residue), the input format the "
                        "expert scores at sampling time")
    p.add_argument("--esm_model", type=str, default="transformer-S",
                   help="an esm2.CONFIGS key")
    p.add_argument("--esm_weights", type=str, default=None,
                   help="base checkpoint to fine-tune: fair-esm .pt or a "
                        "native .npz; omit to train from random init")
    p.add_argument("--out", type=str, required=True,
                   help="checkpoint prefix; writes <out>_ckpt_<step>.npz")
    p.add_argument("--n_iters", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a <out>_ckpt_<step>.npz")
    p.add_argument("--max_seqs", type=int, default=0,
                   help="subsample the family to this many sequences "
                        "(0 = all)")
    p.add_argument("--reweight", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="with --msa: draw training batches with "
                        "1/neighborhood-size phylogenetic weights at "
                        "--reweight_identity (potts_fit.sequence_weights)")
    p.add_argument("--reweight_identity", type=float, default=0.8)
    p.add_argument("--lora_rank", type=int, default=0,
                   help="train rank-N LoRA adapters over a frozen base; the "
                        "final <out>_ckpt_<n>.npz is the merged model")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--val_frac", type=float, default=0.0,
                   help="hold out this fraction of the family and report "
                        "masked-LM cross-entropy on it before and after "
                        "training (training.esm_mlm_heldout_ce)")
    p.add_argument("--mesh_dp", type=int, default=0,
                   help="data-parallel training over a dp mesh of this "
                        "size (0 = single device; one process a device, "
                        "started by torchrun --nproc_per_node N)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def family_in_wt_context(rows, msa_path: str, wt_seq: str) -> list[str]:
    """Embed each MSA row's focus-column residues into the full wild type:
    focus column j sits at full-sequence position focus_columns()[j];
    alignment gaps impute the WT residue. ``rows``: the loaded
    ``io.load_msa(msa_path)`` pairs."""
    fc = io.focus_columns(msa_path)
    if fc and fc[-1] >= len(wt_seq):
        raise SystemExit(
            f"--wt_fasta sequence (len {len(wt_seq)}) does not span the "
            f"MSA focus columns (max index {fc[-1]}) — wrong wild type "
            "for this alignment?")
    wt_focus = "".join(wt_seq[j] for j in fc)
    if rows[0][1].replace("-", "") != wt_focus.replace("-", "") and \
            rows[0][1] != wt_focus:
        print("[finetune_esm] warning: MSA focus sequence != WT at focus "
              "columns; proceeding (check --wt_fasta)", flush=True)
    out = []
    for _, row in rows:
        s = list(wt_seq)
        for j, c in zip(fc, row):
            if c != "-":
                s[j] = c
        out.append("".join(s))
    return out


def load_family(args, device="cpu"):
    """-> (seqs, weights-or-None). The weights come from the focus-column
    identity view (``potts_fit.sequence_weights`` on the alignment), so
    they measure family redundancy, not shared WT context."""
    weights = None
    if args.msa:
        rows = io.load_msa(args.msa)
        if getattr(args, "reweight", False):
            weights = potts_fit.sequence_weights(
                potts_fit.msa_to_onehot(rows),
                identity=args.reweight_identity, device=device)
            print(f"[finetune_esm] phylogenetic reweighting: effective "
                  f"sample size {weights.sum():.1f} of {len(rows)}",
                  flush=True)
        if args.wt_fasta:
            wt = io.read_fasta(args.wt_fasta)[0]
            seqs = family_in_wt_context(rows, args.msa, wt)
        else:
            seqs = [s for _, s in rows]
    else:
        seqs = io.read_fasta(args.fasta)
        if len({len(s) for s in seqs}) != 1:
            raise SystemExit("--fasta sequences must be equal length "
                             "(use --msa for alignments)")
    if args.max_seqs and len(seqs) > args.max_seqs:
        rng = np.random.default_rng(args.seed)
        keep = rng.choice(len(seqs), args.max_seqs, replace=False)
        seqs = [seqs[i] for i in keep]
        if weights is not None:
            weights = weights[keep]
    return seqs, weights


def split_val(seqs, weights, val_frac: float, seed: int):
    """(train seqs, train weights, held-out seqs or None): a numpy draw
    from ``seed + 1`` of round(val_frac * n) rows, at least one."""
    if val_frac <= 0:
        return seqs, weights, None
    rng = np.random.default_rng(seed + 1)
    n_val = max(1, int(round(val_frac * len(seqs))))
    vidx = set(rng.choice(len(seqs), n_val, replace=False).tolist())
    val = [seqs[i] for i in sorted(vidx)]
    seqs = [s for i, s in enumerate(seqs) if i not in vidx]
    if weights is not None:
        weights = np.asarray(
            [w for i, w in enumerate(weights) if i not in vidx])
    return seqs, weights, val


def main(args):
    mesh = None
    device = args.device
    if args.mesh_dp > 1:
        device = pmesh.init_distributed(device)
        mesh = pmesh.make_mesh(dp=args.mesh_dp, device=device)
    device = utils.resolve_device(device)
    lead = pmesh.is_lead()
    seqs, weights = load_family(args, device)
    seqs, weights, val = split_val(seqs, weights, args.val_frac, args.seed)
    if lead:
        print(f"[finetune_esm] {len(seqs)} sequences of length "
              f"{len(seqs[0])}" + (f" (+{len(val)} held out)" if val else ""),
              flush=True)

    params = None
    if args.esm_weights:
        load = (esm2.load_npz_checkpoint if args.esm_weights.endswith(".npz")
                else esm2.load_torch_checkpoint)
        params = load(args.esm_weights, args.esm_model, torch.float32,
                      device)

    def report_val(p, tag):
        if val is None or not lead:
            return
        ce = training.esm_mlm_heldout_ce(p, val, name=args.esm_model,
                                         seed=args.seed)
        print(f"[finetune_esm] held-out masked CE {tag}: {ce:.4f} "
              f"(ppl {np.exp(ce):.2f})", flush=True)

    if val is not None:  # the trainer's own init when no weights are given
        report_val(params if params is not None else esm2.init(
            torch.Generator(device=device).manual_seed(args.seed),
            args.esm_model, torch.float32), "before")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    params = training.train_esm_mlm(
        seqs, name=args.esm_model, params=params, n_iters=args.n_iters,
        batch_size=args.batch_size, lr=args.lr, warmup=args.warmup,
        weight_decay=args.weight_decay, mask_prob=args.mask_prob,
        seed=args.seed, log_every=args.log_every, ckpt_path=args.out,
        ckpt_every=args.ckpt_every, resume=args.resume,
        seq_weights=weights, lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha, device=device, mesh=mesh,
        quiet=not lead)
    final = f"{args.out}_ckpt_{args.n_iters}.npz"
    if not lead:
        return params
    if args.lora_rank:
        # cadence checkpoints hold adapters (_lora_<step>.npz, for
        # --resume); the merged full model goes under the usual name
        esm2.save_npz_checkpoint(final, params, args.n_iters)
    report_val(params, "after")
    print(f"[finetune_esm] done; load with --esm_weights {final}",
          flush=True)
    return params


if __name__ == "__main__":
    main(build_parser().parse_args())
