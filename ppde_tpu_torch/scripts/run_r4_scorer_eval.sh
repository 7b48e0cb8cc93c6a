#!/bin/bash
# Scorer-quality evidence for the per-protein msa-S density scorers
# (PARITY "Evolutionary-density column"): expert-vs-oracle Spearman for the
# trained ckpt_2000 scorer AND its random-init baseline, per protein.
# Counterpart of scripts/run_r4_scorer_eval.sh: the same arguments, paths, skip
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
declare -A SHORT=([$PABP]=PABP [$UBE4B]=UBE4B [$GFP]=GFP)

for prot in $UBE4B $PABP $GFP; do
  s=${SHORT[$prot]}
  ckpt=results/esm_family/${s}_msat_S_ckpt_2000.npz
  [ -f "$ckpt" ] || { echo "[scorer_eval] missing $ckpt" >&2; continue; }
  for mode in random trained; do
    out=results/esm_family/${s}_msat_S_tpu_corr_${mode}.json
    if [ -s "$out" ]; then
      echo "=== [skip] $out" >&2
      continue
    fi
    w=()
    [ "$mode" = trained ] && w=(--msat_weights "$ckpt")
    echo "=== scorer eval: $s $mode" >&2
    python -m ppde_tpu_torch.scripts.eval_expert_correlation \
      --protein "$prot" --msat_model msa-S --msa_path "${MSA[$prot]}" \
      --msa_size 256 --n_mutants 256 "${w[@]}" \
      --out_json "$out" || echo "[scorer_eval] FAILED: $s $mode" >&2
  done
done
echo "=== r4 scorer eval done" >&2
