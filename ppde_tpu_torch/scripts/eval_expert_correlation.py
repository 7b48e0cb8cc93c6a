"""Correlate each energy expert's scores with the oracle over random mutants.

    python -m ppde_tpu_torch.scripts.eval_expert_correlation \
        --protein_weights W --protein P [--esm_model transformer-S] \
        [--msat_model msa-1b --msa_path A.a2m] [--device cpu]

Counterpart of ``scripts/eval_expert_correlation.py``: sample mutants
inside the Potts window, score them with every available expert (Potts
delta Hamiltonian, supervised CNN-ensemble mean, the ESM2 transformer's
delta PLL, the MSA Transformer's evolutionary density) and report the
Spearman rank correlation of each against the oracle, and of the experts
with each other. The same flags and defaults, plus ``--device`` (``cuda``
by default; raises without a GPU).

The transformer column runs ``esm2.load_expert``'s scorer under
``torch.no_grad()`` in chunks of ``--esm_chunk`` mutants: kernel C (the
attention forward) on the card, 12 launches (one a layer) for the wild
type and per chunk. A ragged last chunk runs at its own size.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, metrics, runtime, utils
from ppde_tpu_torch.models import cnn, oracle as oracle_mod
from ppde_tpu_torch.models import potts as potts_mod


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str, required=True)
    p.add_argument("--n_mutants", type=int, default=512)
    p.add_argument("--max_mutations", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--esm_model", type=str, default=None,
                   help="esm2.CONFIGS key; enables the transformer column")
    p.add_argument("--esm_weights", type=str, default=None,
                   help=".npz (finetune_esm output) or fair-esm .pt; "
                        "omit with --esm_model for random init (the "
                        "baseline the fine-tune should beat)")
    p.add_argument("--esm_chunk", type=int, default=64,
                   help="transformer scoring batch (memory bound)")
    p.add_argument("--msat_model", type=str, default=None,
                   help="msa_transformer.CONFIGS key; enables the "
                        "evolutionary-density column "
                        "(metrics.proteins_transformer_score)")
    p.add_argument("--msat_weights", type=str, default=None,
                   help="family-trained .npz (finetune_msa output) or "
                        "fair-esm msa1b .pt; omit with --msat_model for "
                        "random init (the baseline training should beat)")
    p.add_argument("--msa_path", type=str, default=None,
                   help="family alignment for the MSA-T context rows")
    p.add_argument("--msa_size", type=int, default=500)
    p.add_argument("--out_json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    d = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    return float((ra * rb).sum() / d) if d else 0.0


def sample_mutants(wt_int, min_pos, max_pos, n, max_mut, seed):
    """[n, L] int mutants: 1..max_mut distinct in-window substitutions."""
    rng = np.random.default_rng(seed)
    out = np.tile(wt_int, (n, 1))
    window = np.arange(min_pos, max_pos + 1)
    for i in range(n):
        k = int(rng.integers(1, max_mut + 1))
        pos = rng.choice(window, size=min(k, len(window)), replace=False)
        for j in pos:
            out[i, j] = (wt_int[j] + int(rng.integers(1, 20))) % 20
    return out


@torch.no_grad()
def main(args):
    device = utils.resolve_device(args.device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    wt_int = np.asarray([codec.AA_TO_INT[c] for c in wt], np.int32)

    pp = runtime.load_potts(protein_dir, device=device)
    muts = sample_mutants(wt_int, pp.min_pos, pp.max_pos,
                          args.n_mutants, args.max_mutations, args.seed)
    x = torch.nn.functional.one_hot(
        torch.from_numpy(muts).long(), codec.VOCAB_SIZE).float().to(device)
    n_mut = (muts != wt_int[None]).sum(-1)
    print(f"[eval_expert] {args.n_mutants} mutants, "
          f"{np.bincount(n_mut)[1:]} by mutation count", flush=True)

    orc = oracle_mod.load(protein_dir, potts_params=pp, device=device)
    y = oracle_mod.apply(orc, x).cpu().numpy()

    scores = {"potts": potts_mod.score(pp, x, delta=True).cpu().numpy()}

    sup = runtime.load_supervised_ensemble(protein_dir, device=device)
    scores["cnn_ensemble"] = cnn.ensemble_apply(sup, x).cpu().numpy()

    if args.esm_model:
        from ppde_tpu_torch.models import esm2

        params, apply_fn = esm2.load_expert(
            args.esm_model, wt, weights_path=args.esm_weights,
            allow_random=args.esm_weights is None, device=device)
        cs = [apply_fn(params, x[s:s + args.esm_chunk]).cpu().numpy()
              for s in range(0, args.n_mutants, args.esm_chunk)]
        tag = ("transformer_finetuned" if args.esm_weights
               else "transformer_random")
        scores[tag] = np.concatenate(cs)

    if args.msat_model:
        if not args.msa_path:
            raise SystemExit("--msat_model needs --msa_path (the family "
                             "alignment provides the MSA-T context rows)")
        tag = ("msat_trained" if args.msat_weights else "msat_random")
        scores[tag] = metrics.proteins_transformer_score(
            x.cpu().numpy(), protein_dir, args.msa_path, args.msa_size,
            weights_path=args.msat_weights,
            allow_random=args.msat_weights is None,
            msa_model=args.msat_model, seed=args.seed, device=device)

    result = {"protein": args.protein, "n_mutants": args.n_mutants,
              "max_mutations": args.max_mutations, "seed": args.seed,
              "esm_weights": args.esm_weights,
              "spearman_vs_oracle": {}, "spearman_by_n_mut": {}}
    for k, v in scores.items():
        rho = spearman(v, y)
        result["spearman_vs_oracle"][k] = rho
        by_k = {}
        for m in range(1, args.max_mutations + 1):
            idx = n_mut == m
            if idx.sum() >= 8:
                by_k[m] = spearman(v[idx], y[idx])
        result["spearman_by_n_mut"][k] = by_k
        detail = " ".join(f"k={m}:{r:+.3f}" for m, r in by_k.items())
        print(f"[eval_expert] spearman(oracle, {k}) = {rho:+.4f}  "
              f"[{detail}]", flush=True)
    # the experts' mutual agreement (the PoE terms should not be redundant)
    keys = list(scores)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            result["spearman_vs_oracle"][f"{a}~{b}"] = spearman(
                scores[a], scores[b])

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[eval_expert] wrote {args.out_json}", flush=True)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
