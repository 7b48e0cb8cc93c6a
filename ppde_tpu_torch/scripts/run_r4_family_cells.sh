#!/bin/bash
# Round-4 family-expert matrix (VERDICT r3 "Missing #1"): per-protein msa-S
# density scorers + the PPDE family-expert sweep cells for ALL THREE
# proteins, every cell writing a tracked summary JSON.
#
# Prereqs (ppde_tpu_torch/scripts/run_esm_family.sh stages):
#   results/esm_family/<prot>_transformer-S_ckpt_4000.npz   (expert)
#   data/proteins/synthetic/<prot>_synth.a2m                (PABP/GFP)
# UBE4B's scorer goes to 2000 iters ([0]); the PABP/GFP scorers train
# unless a checkpoint exists ([1]); then the cells ([2]).
# Counterpart of scripts/run_r4_family_cells.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default), run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
PABP=PABP_YEAST_Fields2013
GFP=GFP_AEQVI_Sarkisyan2016
CELLS=results/esm_family
mkdir -p "$CELLS"

declare -A LAMBDA=([$PABP]=5 [$UBE4B]=3 [$GFP]=1)  # published transformer λ
declare -A MSA=(
  [$UBE4B]=data/proteins/UBE4B_MOUSE.a2m
  [$PABP]=data/proteins/synthetic/${PABP}_synth.a2m
  [$GFP]=data/proteins/synthetic/${GFP}_synth.a2m
)
declare -A SHORT=([$PABP]=PABP [$UBE4B]=UBE4B [$GFP]=GFP)

# [0] UBE4B msa-S scorer to 2000 iters (the committed ckpt_1000 is
# the round-3 CPU run; PARITY's density column cites the CE-1.22-class
# 2000-iter scorer). --ckpt_every 2000 writes ONLY ckpt_2000, preserving
# the CPU ckpt_1000's provenance.
if [ ! -f results/esm_family/UBE4B_msat_S_ckpt_2000.npz ]; then
  echo "=== msa-S scorer: UBE4B (2000 iters, TPU)" >&2
  python -m ppde_tpu_torch.scripts.finetune_msa --msa "${MSA[$UBE4B]}" \
    --msa_model msa-S --out results/esm_family/UBE4B_msat_S \
    --n_iters 2000 --block_rows 16 --lr 3e-4 --val_frac 0.05 \
    --log_every 200 --ckpt_every 2000 \
    || echo "[r4fam] scorer FAILED: UBE4B" >&2
fi

# [1] per-protein msa-S density scorers
for prot in $PABP $GFP; do
  s=${SHORT[$prot]}
  if ls results/esm_family/${s}_msat_S_ckpt_*.npz >/dev/null 2>&1; then
    echo "=== [skip] ${s} msa-S scorer exists" >&2
    continue
  fi
  echo "=== msa-S scorer: $s" >&2
  python -m ppde_tpu_torch.scripts.finetune_msa --msa "${MSA[$prot]}" \
    --msa_model msa-S --out "results/esm_family/${s}_msat_S" \
    --n_iters 2000 --block_rows 16 --lr 3e-4 --val_frac 0.05 \
    --log_every 200 --ckpt_every 1000 \
    || echo "[r4fam] scorer FAILED: $s" >&2
done

# [2] the family-expert PPDE cells (potts+transformer-S and transformer-S
# only), density scored by the per-protein msa-S scorer
for prot in $UBE4B $PABP $GFP; do
  s=${SHORT[$prot]}; lam=${LAMBDA[$prot]}
  ckpt=results/esm_family/${prot}_transformer-S_ckpt_4000.npz
  scorer=$(ls results/esm_family/${s}_msat_S_ckpt_*.npz 2>/dev/null | sort | tail -1)
  [ -f "$ckpt" ] || { echo "[r4fam] missing expert ckpt for $prot" >&2; continue; }
  score_args=()
  if [ -n "$scorer" ]; then
    score_args=(--msa_transformer_model msa-S
                --msa_transformer_weights "$scorer"
                --msa_path "${MSA[$prot]}" --msa_size 500)
  else
    score_args=(--disable_MSA_transformer_scoring)
  fi
  for expert in "potts+transformer-S" "transformer-S"; do
    name="${s}_PPDE-$(echo "$expert" | tr '+' '_')_family_s1234567"
    if [ -s "$CELLS/$name.json" ]; then
      echo "=== [skip, summary exists] $name" >&2
      continue
    fi
    echo "=== family cell: $name (lambda=$lam)" >&2
    python -m ppde_tpu_torch.scripts.directed_evolution \
      --protein "$prot" --sampler PPDE \
      --unsupervised_expert "$expert" --esm_weights "$ckpt" \
      --energy_lamda "$lam" --n_iters 2500 --n_chains 128 \
      --nmut_threshold 10 --seed 1234567 \
      --run_signature "$(echo "$expert" | tr '+' '_')_family" \
      "${score_args[@]}" \
      --summary_json "$CELLS/$name.json" \
      || echo "[r4fam] FAILED: $name" >&2
  done
done
echo "=== r4 family cells done" >&2
