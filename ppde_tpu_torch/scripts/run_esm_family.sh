#!/bin/bash
# Family-specific transformer expert pipeline (beyond-reference capability;
# the reference's ESM2 expert is a frozen external fork it cannot adapt,
# reference nets.py:172-240):
#   1. masked-LM fine-tune an ESM2 config on the protein's own MSA
#      (phylogenetically reweighted, WT-context embedding, held-out CE)
#   2. quantify what that buys: expert-vs-oracle Spearman for the
#      fine-tuned checkpoint AND the random-init baseline on one mutant set
#   3. run the PPDE potts+transformer sweep cell with the fine-tuned expert
# Counterpart of scripts/run_esm_family.sh: the same arguments, variables
# and flags, each step through the port's entry points (python -m
# ppde_tpu_torch.scripts.<entry>, on the GPU by default), run from the
# repository root.
#
# Usage: ppde_tpu_torch/scripts/run_esm_family.sh [protein] [esm_model] [n_iters]
# Defaults: UBE4B, transformer-S, 4000.
set -euo pipefail
cd "$(dirname "$0")/../.."

PROT=${1:-UBE4B_MOUSE_Klevit2013-nscor_log2_ratio}
MODEL=${2:-transformer-S}
ITERS=${3:-4000}
MSA=${MSA:-data/proteins/UBE4B_MOUSE.a2m}
OUT=${OUT:-results/esm_family/${PROT}_${MODEL}}
LAMBDA=${LAMBDA:-3}          # calibrated UBE4B transformer lambda
SWEEP_ITERS=${SWEEP_ITERS:-2500}
mkdir -p "$(dirname "$OUT")"

echo "=== [1/3] fine-tune $MODEL on $MSA" >&2
python -m ppde_tpu_torch.scripts.finetune_esm \
  --msa "$MSA" --wt_fasta "weights/$PROT/wt.fasta" \
  --esm_model "$MODEL" --out "$OUT" --n_iters "$ITERS" \
  --batch_size 64 --lr 3e-4 --val_frac 0.05 \
  --log_every 200 --ckpt_every 2000 ${FT_EXTRA:-}

CKPT="${OUT}_ckpt_${ITERS}.npz"

echo "=== [2/3] expert-vs-oracle correlation (random baseline, then fine-tuned)" >&2
python -m ppde_tpu_torch.scripts.eval_expert_correlation \
  --protein "$PROT" --esm_model "$MODEL" \
  --n_mutants 512 --out_json "${OUT}_corr_random.json"
python -m ppde_tpu_torch.scripts.eval_expert_correlation \
  --protein "$PROT" --esm_model "$MODEL" --esm_weights "$CKPT" \
  --n_mutants 512 --out_json "${OUT}_corr_finetuned.json"

echo "=== [3/3] PPDE sweep cell with the fine-tuned expert" >&2
python -m ppde_tpu_torch.scripts.directed_evolution \
  --protein "$PROT" --sampler PPDE \
  --unsupervised_expert "potts+${MODEL}" --esm_weights "$CKPT" \
  --energy_lamda "$LAMBDA" --n_iters "$SWEEP_ITERS" --n_chains 128 \
  --nmut_threshold 10 --disable_MSA_transformer_scoring \
  --run_signature "potts_${MODEL}_family" --seed 1234567

echo "=== done: $CKPT + correlation JSONs + sweep cell" >&2
