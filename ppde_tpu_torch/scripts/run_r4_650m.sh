#!/bin/bash
# 650M (transformer-L) quality row: LoRA fine-tune the reference's largest
# expert config on the UBE4B family to convergence, then a real
# (1000-iter, 128-chain) PPDE PoE sweep cell with it.
# Counterpart of scripts/run_r4_650m.sh: the same arguments, paths, skip
# checks and flags, each step through the port's entry points (python -m
# ppde_tpu_torch.scripts.<entry>, on the GPU by default), run from the
# repository root.
#
# Usage: ppde_tpu_torch/scripts/run_r4_650m.sh [lora_iters] [cell_iters]
set -uo pipefail
cd "$(dirname "$0")/../.."

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
ITERS=${1:-800}
CELL_ITERS=${2:-1000}
OUT=results/esm_family/UBE4B_650M_lora

if [ ! -f "${OUT}_ckpt_${ITERS}.npz" ]; then
  echo "=== [1/2] 650M rank-8 LoRA fine-tune, $ITERS iters" >&2
  python -m ppde_tpu_torch.scripts.finetune_esm \
    --msa data/proteins/UBE4B_MOUSE.a2m --wt_fasta "weights/$UBE4B/wt.fasta" \
    --esm_model transformer-L --lora_rank 8 --lora_alpha 16 \
    --out "$OUT" --n_iters "$ITERS" --batch_size 8 --lr 3e-4 \
    --val_frac 0.05 --log_every 25 --ckpt_every "$ITERS" || exit 1
fi

SCORER=$(ls results/esm_family/UBE4B_msat_S_ckpt_*.npz 2>/dev/null | sort | tail -1)
if [ -n "$SCORER" ]; then
  SCORE_ARGS=(--msa_transformer_model msa-S
              --msa_transformer_weights "$SCORER"
              --msa_path data/proteins/UBE4B_MOUSE.a2m --msa_size 500)
else
  SCORE_ARGS=(--disable_MSA_transformer_scoring)
fi

echo "=== [2/2] PPDE PoE cell with the fine-tuned 650M" >&2
python -m ppde_tpu_torch.scripts.directed_evolution \
  --protein "$UBE4B" --sampler PPDE \
  --unsupervised_expert potts+transformer-L \
  --esm_weights "${OUT}_ckpt_${ITERS}.npz" \
  --energy_lamda 3 --n_iters "$CELL_ITERS" --n_chains 128 \
  --nmut_threshold 10 --seed 1234567 --compute_dtype bf16 \
  --esm_chunk 64 --log_every 100 \
  --run_signature potts_transformer-L_family \
  "${SCORE_ARGS[@]}" \
  --summary_json results/esm_family/UBE4B_PPDE-potts_transformer-L_family_s1234567.json
echo "=== r4 650M done" >&2
