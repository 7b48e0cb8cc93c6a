#!/bin/bash
# Full protein sweep: {PABP, UBE4B, GFP} x {potts, transformer} experts with
# the calibrated per-pair lambdas, all five samplers, hard nmut=10.
# Counterpart of scripts/run_protein_samplers.sh: the same variables,
# lambda tables, runs and flags, each run through the port's CLI
# (python -m ppde_tpu_torch.scripts.directed_evolution, on the GPU by
# default). Run from anywhere: it works from the repository root, where
# weights/ and results/ resolve.
set -euo pipefail
cd "$(dirname "$0")/../.."

N_ITERS=${N_ITERS:-10000}
N_CHAINS=${N_CHAINS:-128}
SEED=${SEED:-1234567}
EXTRA=${EXTRA:---disable_MSA_transformer_scoring}

declare -A LAMBDA_POTTS=(
  [PABP_YEAST_Fields2013]=5
  [UBE4B_MOUSE_Klevit2013-nscor_log2_ratio]=0.5
  [GFP_AEQVI_Sarkisyan2016]=15
)
declare -A LAMBDA_TRANSFORMER=(
  [PABP_YEAST_Fields2013]=5
  [UBE4B_MOUSE_Klevit2013-nscor_log2_ratio]=3
  [GFP_AEQVI_Sarkisyan2016]=1
)

run() {
  echo "=== $*" >&2
  # `|| echo` keeps one failed cell from aborting the whole sweep (set -e)
  python -m ppde_tpu_torch.scripts.directed_evolution "$@" \
    --n_iters "$N_ITERS" --n_chains "$N_CHAINS" --seed "$SEED" \
    --nmut_threshold 10 $EXTRA || echo "[sweep] FAILED: $*" >&2
}

for prot in "${!LAMBDA_POTTS[@]}"; do
  lam=${LAMBDA_POTTS[$prot]}
  # PPDE twice: the corrected-reverse default, and the reference's biased
  # reverse estimator for apples-to-apples comparison with the paper's
  # tables (PARITY.md "correctness discovery")
  run --protein "$prot" --sampler PPDE \
      --unsupervised_expert potts --energy_lamda "$lam" \
      --run_signature potts_exact
  run --protein "$prot" --sampler PPDE --ppde_reference_reverse \
      --unsupervised_expert potts --energy_lamda "$lam" \
      --run_signature potts
  for sampler in simulated_annealing Random MALA-approx; do
    run --protein "$prot" --sampler "$sampler" \
        --unsupervised_expert potts --energy_lamda "$lam" \
        --run_signature potts
  done
  # CMA-ES uses far fewer generations (reference README example: 1000)
  N_ITERS=1000 run --protein "$prot" --sampler CMAES \
      --unsupervised_expert potts --energy_lamda "$lam" \
      --run_signature potts

  # transformer expert runs need --esm_weights (fair-esm checkpoint)
  if [ -n "${ESM_WEIGHTS:-}" ]; then
    run --protein "$prot" --sampler PPDE \
        --unsupervised_expert transformer-M \
        --energy_lamda "${LAMBDA_TRANSFORMER[$prot]}" \
        --esm_weights "$ESM_WEIGHTS" --run_signature transformer
  fi
done
