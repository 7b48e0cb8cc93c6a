#!/bin/bash
# transformer-M (150M) quality row: rank-8 LoRA fine-tune on the UBE4B
# family, then a 1000-iter 128-chain PPDE PoE cell at the published
# transformer lambda (=3, reference README.md:65-72). Mirrors
# run_r4_650m.sh.
# Counterpart of scripts/run_r5_150m.sh: the same arguments, paths, skip
# checks and flags, each step through the port's entry points (python -m
# ppde_tpu_torch.scripts.<entry>, on the GPU by default), run from the
# repository root.
#
# Usage: ppde_tpu_torch/scripts/run_r5_150m.sh [lora_iters] [cell_iters]
set -uo pipefail
cd "$(dirname "$0")/../.."

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
ITERS=${1:-1200}
CELL_ITERS=${2:-1000}
OUT=results/esm_family/UBE4B_150M_lora

if [ ! -f "${OUT}_ckpt_${ITERS}.npz" ]; then
  echo "=== [1/2] 150M rank-8 LoRA fine-tune, $ITERS iters" >&2
  python -m ppde_tpu_torch.scripts.finetune_esm \
    --msa data/proteins/UBE4B_MOUSE.a2m --wt_fasta "weights/$UBE4B/wt.fasta" \
    --esm_model transformer-M --lora_rank 8 --lora_alpha 16 \
    --out "$OUT" --n_iters "$ITERS" --batch_size 16 --lr 3e-4 \
    --val_frac 0.05 --log_every 50 --ckpt_every "$ITERS" || exit 1
fi

SCORER=$(ls results/esm_family/UBE4B_msat_S_ckpt_*.npz 2>/dev/null | sort | tail -1)
if [ -n "$SCORER" ]; then
  SCORE_ARGS=(--msa_transformer_model msa-S
              --msa_transformer_weights "$SCORER"
              --msa_path data/proteins/UBE4B_MOUSE.a2m --msa_size 500)
else
  SCORE_ARGS=(--disable_MSA_transformer_scoring)
fi

echo "=== [2/2] PPDE PoE cell with the fine-tuned 150M" >&2
python -m ppde_tpu_torch.scripts.directed_evolution \
  --protein "$UBE4B" --sampler PPDE \
  --unsupervised_expert potts+transformer-M \
  --esm_weights "${OUT}_ckpt_${ITERS}.npz" \
  --energy_lamda 3 --n_iters "$CELL_ITERS" --n_chains 128 \
  --nmut_threshold 10 --seed 1234567 --compute_dtype bf16 \
  --esm_chunk 64 --log_every 100 \
  --run_signature potts_transformer-M_family \
  "${SCORE_ARGS[@]}" \
  --summary_json results/esm_family/UBE4B_PPDE-potts_transformer-M_family_s1234567.json
echo "=== r5 150M done" >&2
