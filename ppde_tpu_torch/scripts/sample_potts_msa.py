"""Sample sequences from a fitted Potts model (Gibbs): fit QC and synthetic
families.

    python -m ppde_tpu_torch.scripts.sample_potts_msa --protein_weights W \
        --protein P [--potts_npz F] [--n_seqs 500] [--n_sweeps 200] \
        [--qc_msa A.a2m] [--out S.a2m] [--out_json J] [--device cpu]

Counterpart of ``scripts/sample_potts_msa.py``: the same flags and
defaults, plus ``--device`` (``cuda`` by default; raises without a GPU).
Draws from p(x) ∝ exp(β·H(x)) with the exact single-site Gibbs sweep
(``potts.gibbs_sample``; one [B,V]×[V,P] product a position), prints the
uniqueness and H quantiles, and with ``--qc_msa`` the Pearson r of the
samples' single-site frequencies and pair covariances against the
alignment's. ``--out`` writes the samples as an all-focus .a2m,
``--out_json`` appends the run's statistics as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, runtime, utils
from ppde_tpu_torch.models import potts, potts_fit


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str, required=True)
    p.add_argument("--n_seqs", type=int, default=500)
    p.add_argument("--n_sweeps", type=int, default=200,
                   help="systematic Gibbs sweeps (each resamples every "
                        "window position once)")
    p.add_argument("--beta", type=float, default=1.0,
                   help="inverse temperature; 1.0 = the model's own law")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="write samples as uppercase FASTA (valid all-focus "
                        ".a2m; WT window is the first/focus record)")
    p.add_argument("--qc_msa", type=str, default=None,
                   help="real .a2m to compare sampled statistics against "
                        "(Pearson r of single-site frequencies and of "
                        "pairwise covariances)")
    p.add_argument("--potts_npz", type=str, default=None,
                   help="sample from this Potts fit instead of the protein "
                        "dir's artifact")
    p.add_argument("--out_json", type=str, default=None,
                   help="append run stats (config, uniqueness, H quantiles, "
                        "QC correlations) as one JSON object per line")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def pair_covariances(onehot):
    """Flattened C[(i,a),(j,b)] = f_ij(a,b) − f_i(a)·f_j(b), i<j entries."""
    M, L, V = onehot.shape
    flat = onehot.reshape(M, L * V)
    f = flat.mean(0)
    C = flat.T @ flat / M - np.outer(f, f)
    iu = np.triu_indices(L, k=1)
    blocks = C.reshape(L, V, L, V)[iu[0], :, iu[1], :]
    return blocks.ravel()


def _round_or_none(v, digits: int = 4):
    """round() that maps None/nan/inf to None so json.dumps stays valid."""
    return round(v, digits) if v is not None and math.isfinite(v) else None


def main(args):
    """Returns (the sampled window sequences, the QC record)."""
    device = utils.resolve_device(args.device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    if args.potts_npz:
        pp = potts.load_npz(args.potts_npz, wt, device=device)
    else:
        pp = runtime.load_potts(protein_dir, device=device)
    wt_window = wt[pp.min_pos: pp.max_pos + 1]
    print(f"[sample_potts] {args.protein}: window L={pp.seq_len}, "
          f"{args.n_seqs} chains x {args.n_sweeps} sweeps, "
          f"beta={args.beta}", flush=True)

    xt = potts.gibbs_sample(
        pp, torch.Generator(device=device).manual_seed(args.seed),
        n_chains=args.n_seqs, n_sweeps=args.n_sweeps, beta=args.beta)
    with torch.no_grad():
        H = potts.hamiltonian(pp, xt).cpu().numpy()
    x = xt.cpu().numpy()
    seqs = codec.onehot_to_seqs(x)
    uniq = 100.0 * len(set(seqs)) / len(seqs)
    print(f"[sample_potts] unique {uniq:.1f}%  H quantiles "
          f"{np.quantile(H, [0.1, 0.5, 0.9])} (wt_H "
          f"{float(pp.wt_H):.2f})", flush=True)

    r1 = r2 = None
    if args.qc_msa:
        msa = pio.load_msa(args.qc_msa)
        data = potts_fit.msa_to_onehot(msa)
        fi_model = x.reshape(len(seqs), -1).mean(0)
        fi_data = data.reshape(len(msa), -1).mean(0)
        r1 = float(np.corrcoef(fi_model, fi_data)[0, 1])
        r2 = float(np.corrcoef(pair_covariances(x),
                               pair_covariances(data))[0, 1])
        print(f"[sample_potts] QC vs {args.qc_msa}: "
              f"single-site freq r={r1:+.4f}, pair covariance r={r2:+.4f}",
              flush=True)

    rec = {"protein": args.protein, "potts_npz": args.potts_npz,
           "n_seqs": args.n_seqs, "n_sweeps": args.n_sweeps,
           "beta": args.beta, "seed": args.seed,
           "unique_pct": round(uniq, 2),
           "H_q10_q50_q90": [round(float(q), 3) for q in
                             np.quantile(H, [0.1, 0.5, 0.9])],
           "wt_H": round(float(pp.wt_H), 3),
           "coupling_l2": round(float(pp.W.float().pow(2).sum().sqrt()), 3),
           "qc_msa": args.qc_msa,
           # None (JSON null) when QC was skipped or a correlation is
           # undefined (a fully conserved population gives nan)
           "single_site_freq_r": _round_or_none(r1),
           "pair_covariance_r": _round_or_none(r2)}
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "a") as f:
            f.write(json.dumps(rec) + "\n")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f">{args.protein}_WT/"
                    f"{pp.min_pos + 1}-{pp.max_pos + 1}\n{wt_window}\n")
            for i, s in enumerate(seqs):
                f.write(f">potts_sample_{i} beta={args.beta} "
                        f"sweeps={args.n_sweeps} seed={args.seed}\n{s}\n")
        print(f"[sample_potts] wrote {len(seqs) + 1} records to {args.out}",
              flush=True)
    return seqs, rec


if __name__ == "__main__":
    main(build_parser().parse_args())
