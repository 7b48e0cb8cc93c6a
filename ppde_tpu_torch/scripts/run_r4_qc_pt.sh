#!/bin/bash
# Round-4 measurement tasks (VERDICT r3 "Next #5" and "#8"):
#   qc — run the UBE4B Potts pairwise-covariance QC to convergence
#        (sample-depth ladder until r plateaus) and a lambda_J
#        regularization sweep connecting coupling scale to the fit knob
#        (the lambda=2.2-vs-0.5 / 4.4x-Hamiltonian findings).
#   pt — PT's realistic value case: the supervised-only UBE4B landscape
#        (the one real-artifact energy where corrected-reverse PPDE
#        measurably traps: 37.5% diversity, ~1.8 edits) — plain corrected
#        PPDE vs PPDE-PT at the same chain budget.
# Usage: ppde_tpu_torch/scripts/run_r4_qc_pt.sh [qc|pt|all]
# Counterpart of scripts/run_r4_qc_pt.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default), run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."
PHASE=${1:-all}

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
MSA=data/proteins/UBE4B_MOUSE.a2m
SUM=results/proteins/summaries
mkdir -p "$SUM" results/qc

if [ "$PHASE" = qc ] || [ "$PHASE" = all ]; then
  # sample-depth ladder: pair-covariance r vs (chains x sweeps)
  for cfg in "2048 300" "4096 600" "8192 600" "8192 1200"; do
    set -- $cfg
    echo "=== QC depth $1 x $2" >&2
    python -m ppde_tpu_torch.scripts.sample_potts_msa --protein "$UBE4B" \
      --n_seqs "$1" --n_sweeps "$2" --seed 0 --qc_msa "$MSA" \
      --out_json results/qc/ube4b_qc_ladder.jsonl \
      2>&1 | tee -a results/qc/ube4b_qc_ladder.log
  done
  # lambda_J sweep: coupling scale + QC at 10x lighter/heavier l2
  for lj in 0.001 0.01 0.1; do
    out=/tmp/potts_lj${lj}.npz
    echo "=== fit lambda_J=$lj" >&2
    python -m ppde_tpu_torch.scripts.fit_potts --msa "$MSA" --out "$out" \
      --lambda_J "$lj" 2>&1 | tee -a results/qc/ube4b_reg_sweep.log
    python -m ppde_tpu_torch.scripts.select_lambda --protein "$UBE4B" \
      --potts_npz "$out" --out_json results/qc/ube4b_reg_sweep.jsonl \
      2>&1 | tee -a results/qc/ube4b_reg_sweep.log
    python -m ppde_tpu_torch.scripts.sample_potts_msa --protein "$UBE4B" \
      --potts_npz "$out" --n_seqs 4096 --n_sweeps 600 --seed 0 \
      --qc_msa "$MSA" --out_json results/qc/ube4b_reg_sweep.jsonl \
      2>&1 | tee -a results/qc/ube4b_reg_sweep.log
  done
fi

if [ "$PHASE" = pt ] || [ "$PHASE" = all ]; then
  # plain corrected-reverse supervised-only (the trap candidate) ...
  python -m ppde_tpu_torch.scripts.directed_evolution \
    --protein "$UBE4B" --sampler PPDE --energy_function supervised \
    --unsupervised_expert potts --energy_lamda 0.5 \
    --n_iters 10000 --n_chains 128 --nmut_threshold 10 --seed 1234567 \
    --disable_MSA_transformer_scoring --run_signature sup_only_exact \
    --summary_json "$SUM/UBE4B_PPDE-suponly-exact_s1234567.json"
  # ... vs PPDE-PT on the identical energy at the same chain budget
  python -m ppde_tpu_torch.scripts.directed_evolution \
    --protein "$UBE4B" --sampler PPDE-PT --energy_function supervised \
    --unsupervised_expert potts --energy_lamda 0.5 \
    --n_iters 10000 --n_chains 128 --nmut_threshold 10 --seed 1234567 \
    --disable_MSA_transformer_scoring --run_signature sup_only_pt \
    --summary_json "$SUM/UBE4B_PPDE-PT-suponly_s1234567.json"
fi
echo "=== r4 qc/pt phase '$PHASE' done" >&2
