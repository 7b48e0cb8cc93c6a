#!/bin/bash
# Round-5 remaining queue, strictly serial. Every stage is idempotent:
# interrupted runs are resumed/skipped, so after ANY interruption just
# relaunch this script.
#
# Order (value-first under a deadline):
#   1. finish the 2 missing baseline seed cells (GFP MALA/CMAES s2024)
#   2. transformer-M (150M) LoRA + quality cell  (VERDICT r4 missing #2)
#   3. the 24 family-expert cells at canonical 10k iters (missing #3,
#      UBE4B first)
#   4. the 3 missing MNIST CMA-ES wild-type pairs  (next #7)
# Counterpart of scripts/run_r5_remaining.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default); the nested drivers and the
# link script are the port's copies, run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."

# Reference-artifact symlinks (wt.fasta, oracle pkls, mnist ensemble .pt)
# are untracked and may be cleaned between runs — self-heal first.
[ -e weights/GFP_AEQVI_Sarkisyan2016/wt.fasta ] \
  || bash ppde_tpu_torch/scripts/link_reference_weights.sh

echo "=== [stage 1/4] baseline seed-spread stragglers" >&2
python -m ppde_tpu_torch.scripts.run_cells --r5_baseline_seeds \
  || echo "[r5rem] stage 1 FAILED (continuing)" >&2

M_SUM=results/esm_family/UBE4B_PPDE-potts_transformer-M_family_s1234567.json
if [ -s "$M_SUM" ]; then
  echo "=== [stage 2/4] skip: 150M quality cell exists" >&2
else
  echo "=== [stage 2/4] transformer-M (150M) LoRA + quality cell" >&2
  bash ppde_tpu_torch/scripts/run_r5_150m.sh || echo "[r5rem] stage 2 FAILED (continuing)" >&2
fi

echo "=== [stage 3/4] 24 family cells at 10k iters" >&2
bash ppde_tpu_torch/scripts/run_r5_family10k.sh \
  || echo "[r5rem] stage 3 FAILED (continuing)" >&2

echo "=== [stage 4/4] MNIST CMA-ES wild-type pairs 2-4" >&2
python -m ppde_tpu_torch.scripts.run_cells --r5_mnist_cmaes \
  || echo "[r5rem] stage 4 FAILED" >&2

echo "=== r5 remaining queue drained" >&2
