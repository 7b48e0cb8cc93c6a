#!/bin/bash
# Round-5: decide the Potts fitter's default lambda_J on measured grounds
# (VERDICT r4 "Next #6" / "Weak #2").
#
# The round-4 sweep (results/qc/ube4b_reg_sweep.jsonl) measured generative
# QC (pair-covariance r: 0.64 @ 0.001 vs 0.52 @ 0.01 vs 0.32 @ 0.1) and the
# select_lambda round-trip, but NOT the expert-quality statistic the oracle
# actually consumes — Spearman(dH, fitness) over a mixed-radius mutant
# cloud (calibrate_oracle_scale's protocol, scale-invariant so the raw fit
# is comparable without scale-matching). This script refits UBE4B at the
# two candidate lambda_J values with the pinned r4-sweep config and appends
# one identical-protocol record per fit to results/qc/ube4b_lj_decision.jsonl.
# The decision (and the PARITY note) reads from that file.
# Counterpart of scripts/run_r5_ljdecision.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default), run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
MSA=data/proteins/UBE4B_MOUSE.a2m
OUT=results/qc/ube4b_lj_decision.jsonl
mkdir -p results/qc

for lj in 0.001 0.01; do
  npz=/tmp/potts_lj${lj}.npz
  if [ ! -f "$npz" ]; then
    echo "=== refit lambda_J=$lj (pinned r4-sweep config)" >&2
    python -m ppde_tpu_torch.scripts.fit_potts --msa "$MSA" --out "$npz" \
      --lambda_J "$lj" || exit 1
  fi
  echo "=== expert-quality stats for lambda_J=$lj" >&2
  python -m ppde_tpu_torch.scripts.calibrate_oracle_scale --protein "$UBE4B" \
    --potts_npz "$npz" --out_json "$OUT" || exit 1
done
echo "=== lj decision data in $OUT" >&2
