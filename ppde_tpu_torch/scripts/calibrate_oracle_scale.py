"""Scale-match a refit Potts model to the reference's (missing) original fit.

    python -m ppde_tpu_torch.scripts.calibrate_oracle_scale \
        --protein_weights W --protein P [--potts_npz F] [--out_npz O] \
        [--out_json J] [--device cpu]

Counterpart of ``scripts/calibrate_oracle_scale.py`` (whose docstring gives
the reasoning): the same flags, defaults, printed record and artifact,
plus ``--device`` (``cuda`` by default; raises without a GPU).

  1. Expert side: scale (J, h) by s so that std(s * dH) over random single
     mutants equals lambda_published * std(supervised fitness), with
     select_lambda's protocol (same default seed).
  2. Oracle side: the feature scale alpha that best explains the CNN
     ensemble's predictions by the oracle over a mixed-radius mutant cloud,
        min_alpha  sum_x ( mean_s(coef_s0) * alpha * dH(x) + c(x) - f(x) )^2,
     stored as reg_coef = (s / alpha)^2, so that the oracle's
     sqrt(1/reg_coef) * dH_scaled reproduces alpha * dH.

``--out_npz`` writes the ``potts.save_npz`` artifact and checks that it
round-trips (the expert's std hits the target, the oracle feature equals
alpha * dH); ``--out_json`` appends the record with the fit-quality
diagnostics (R^2 of oracle against CNN, Spearman(dH, fitness) by radius).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, runtime, utils
from ppde_tpu_torch.models import cnn, oracle as oracle_mod
from ppde_tpu_torch.models import potts as potts_mod


def sample_mutants(rng, wt_idx, min_pos, max_pos, n, max_muts):
    """Mixed-radius mutant cloud: k ~ U[1, max_muts] substitutions at
    distinct positions, values forced != wt (so k is the true radius)."""
    muts, ks = [], []
    for _ in range(n):
        k = int(rng.integers(1, max_muts + 1))
        x = wt_idx.copy()
        pos = rng.choice(np.arange(min_pos, max_pos + 1), size=k,
                         replace=False)
        for p in pos:
            v = int(rng.integers(0, 19))
            x[p] = v if v < wt_idx[p] else v + 1  # uniform over != wt
        muts.append(x)
        ks.append(k)
    return np.stack(muts), np.asarray(ks)


def _onehot(ints, device):
    return torch.from_numpy(codec.ints_to_onehot(ints).astype(
        np.float32)).to(device)


@torch.no_grad()
def single_mutant_std(pp, sup, wt, n_mutants=512, seed=0):
    """std(dH) and std(fitness) over random single mutants: select_lambda's
    protocol exactly (same default seed)."""
    rng = np.random.default_rng(seed)
    wt_idx = codec.seqs_to_ints([wt])[0]
    muts = []
    for _ in range(n_mutants):
        x = wt_idx.copy()
        x[rng.integers(pp.min_pos, pp.max_pos + 1)] = rng.integers(0, 20)
        muts.append(x)
    x = _onehot(np.stack(muts), pp.W.device)
    dh = potts_mod.score(pp, x, delta=True).cpu().numpy()
    fit = cnn.ensemble_apply(sup, x).cpu().numpy()
    return float(dh.std()), float(fit.std())


def main(args):
    from scipy import stats

    device = utils.resolve_device(args.device)
    protein_dir = os.path.join(args.protein_weights, args.protein)
    wt = pio.read_fasta(os.path.join(protein_dir, "wt.fasta"))[0]
    src = args.potts_npz or os.path.join(protein_dir, "potts.npz")
    pp = potts_mod.load_npz(src, wt, device=device)
    sup = runtime.load_supervised_ensemble(protein_dir, device=device)
    orc = oracle_mod.load(protein_dir, potts_params=pp, device=device)

    # expert side: the reference-implied single-mutant dH scale
    std_dh, std_fit = single_mutant_std(pp, sup, wt)
    target = args.lambda_published * std_fit
    s = target / std_dh

    # oracle side: the effective feature scale alpha
    rng = np.random.default_rng(args.seed)
    wt_idx = codec.seqs_to_ints([wt])[0]
    ints, ks = sample_mutants(rng, wt_idx, pp.min_pos, pp.max_pos,
                              args.n_mutants, args.max_muts)
    x = _onehot(ints, device)
    with torch.no_grad():
        dh = potts_mod.score(pp, x, delta=True).cpu().numpy()   # [N]
        f = cnn.ensemble_apply(sup, x).cpu().numpy()            # [N]
    xf = x.cpu().numpy().reshape(x.shape[0], -1)
    coef = orc.coef.cpu().numpy()                               # [S, 1+LV]
    onehot = (xf @ coef[:, 1:].T) * orc.inv_sqrt_reg.cpu().numpy()[None]
    c = (onehot + orc.intercept.cpu().numpy()[None]).mean(1)     # [N]
    k0 = float(coef[:, 0].mean())
    A = k0 * dh                                                 # [N]
    r = f - c
    alpha = float((A @ r) / (A @ A))

    def r2(pred):
        ss = float(((f - pred) ** 2).sum())
        return 1.0 - ss / float(((f - f.mean()) ** 2).sum())

    by_k = {int(k): round(float(stats.spearmanr(
        dh[ks == k], f[ks == k]).statistic), 4)
        for k in sorted(set(ks.tolist())) if (ks == k).sum() >= 16}

    rec = {
        "protein": args.protein, "potts_npz": src,
        "n_mutants": args.n_mutants, "max_muts": args.max_muts,
        "seed": args.seed,
        "std_dH_single": round(std_dh, 4), "std_fit_single": round(std_fit, 4),
        "lambda_published": args.lambda_published,
        "target_std": round(target, 4), "scale_s": round(s, 6),
        "alpha": round(alpha, 6),
        "reg_coef_out": round((s / alpha) ** 2, 6),
        "oracle_vs_cnn_r2": {"alpha_star": round(r2(A * alpha + c), 4),
                             "alpha_1": round(r2(A + c), 4),
                             "no_ev": round(r2(c), 4)},
        "spearman_dH_vs_fitness_by_k": by_k,
    }
    print(json.dumps(rec, indent=2))

    if args.out_npz:
        z = np.load(src)
        reg_out = (s / alpha) ** 2
        potts_mod.save_npz(args.out_npz, np.asarray(z["J"]) * s,
                           np.asarray(z["h"]) * s, z["index_list"],
                           reg_out, int(z["offset"]))
        # the artifact round-trips: the expert's std hits the target and
        # the oracle feature reproduces alpha * dH
        pp2 = potts_mod.load_npz(args.out_npz, wt, device=device)
        std2, _ = single_mutant_std(pp2, sup, wt)
        feat_ratio = float(np.sqrt(1.0 / pp2.reg_coef) * s / alpha)
        assert abs(std2 - target) < 0.02 * target, (std2, target)
        assert abs(feat_ratio - 1.0) < 1e-4, feat_ratio
        rec["out_npz"] = args.out_npz
        rec["verified_std_dH_single"] = round(std2, 4)
        print(f"wrote {args.out_npz}: expert std(dH)={std2:.4f} "
              f"(target {target:.4f}), oracle feature == alpha*dH")

    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "a") as fjson:
            fjson.write(json.dumps(rec) + "\n")
    return rec


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protein_weights", type=str, default="weights")
    p.add_argument("--protein", type=str,
                   default="UBE4B_MOUSE_Klevit2013-nscor_log2_ratio")
    p.add_argument("--potts_npz", type=str, default=None,
                   help="source fit (default: the protein dir's potts.npz)")
    p.add_argument("--lambda_published", type=float, default=0.5,
                   help="the reference's published PoE lambda for this "
                        "protein (README.md:65-72): implies the original "
                        "fit's dH scale via the paper's calibration method")
    p.add_argument("--n_mutants", type=int, default=4096)
    p.add_argument("--max_muts", type=int, default=10,
                   help="mutant-cloud radius (the sweep's nmut_threshold)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_npz", type=str, default=None,
                   help="write the scale-matched artifact here")
    p.add_argument("--out_json", type=str, default=None,
                   help="append the calibration record as one JSON line")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
