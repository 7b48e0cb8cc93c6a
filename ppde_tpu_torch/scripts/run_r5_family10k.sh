#!/bin/bash
# Round-5: the family-expert matrix at the canonical sweep depth
# (VERDICT r4 "Missing #3" / "Next #2").
#
# 1. Regenerate any missing ESM2-S family expert checkpoint (119 MB each,
#    deliberately untracked — .gitignore) with the pinned-seed round-4
#    training commands (PARITY.md "Family-trained ESM2 expert": seed 0,
#    batch 64, lr 3e-4, 4000 iters).
# 2. Run the 24 family cells at 10,000 iters in ONE process
#    (run_cells --r5_family). Cells whose committed summary
#    already says n_iters=10000 are skipped, so this script is
#    idempotently relaunchable after any interruption.
# Counterpart of scripts/run_r5_family10k.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default), run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."

UBE4B=UBE4B_MOUSE_Klevit2013-nscor_log2_ratio
PABP=PABP_YEAST_Fields2013
GFP=GFP_AEQVI_Sarkisyan2016

declare -A MSA=(
  [$UBE4B]=data/proteins/UBE4B_MOUSE.a2m
  [$PABP]=data/proteins/synthetic/${PABP}_synth.a2m
  [$GFP]=data/proteins/synthetic/${GFP}_synth.a2m
)

cells_pending () {  # any of the protein's 8 family summaries missing/short?
  local prot=$1 f
  local short=${prot%%_*}
  for expert in "potts_transformer-S" "transformer-S"; do
    for seed in 1234567 7 42 2024; do
      f="results/esm_family/${short}_PPDE-${expert}_family_s${seed}.json"
      grep -q '"n_iters": 10000' "$f" 2>/dev/null || return 0
    done
  done
  return 1
}

for prot in $UBE4B $PABP $GFP; do
  ckpt=results/esm_family/${prot}_transformer-S_ckpt_4000.npz
  if [ -f "$ckpt" ]; then
    echo "=== [skip] expert exists: $ckpt" >&2
    continue
  fi
  if ! cells_pending "$prot"; then
    echo "=== [skip] all 8 family cells done at 10k, expert not needed: $prot" >&2
    continue
  fi
  echo "=== retrain family expert: $prot" >&2
  python -m ppde_tpu_torch.scripts.finetune_esm \
    --msa "${MSA[$prot]}" --wt_fasta "weights/$prot/wt.fasta" \
    --esm_model transformer-S \
    --out "results/esm_family/${prot}_transformer-S" \
    --n_iters 4000 --batch_size 64 --lr 3e-4 --val_frac 0.05 \
    --log_every 200 --ckpt_every 2000 \
    || { echo "[r5fam] expert training FAILED: $prot" >&2; exit 1; }
done

echo "=== 24 family cells at 10k iters (one claim)" >&2
python -m ppde_tpu_torch.scripts.run_cells --r5_family
