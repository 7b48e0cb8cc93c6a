#!/bin/bash
# Build local weights/ and data/ trees from the reference's committed
# artifacts (symlinks; the reference mount is read-only). Our own artifacts
# (potts.npz from fit_potts, retrained EBM/DAE) live alongside.
# Counterpart of tools/link_reference_weights.sh: the same links, made from
# the repository root. The reference root is the one argument, and has no
# default: without it the script prints its usage and links nothing.
#   ppde_tpu_torch/scripts/link_reference_weights.sh REFERENCE_ROOT
set -euo pipefail
if [ $# -ne 1 ]; then
  echo "usage: $0 REFERENCE_ROOT (the reference checkout whose weights/" \
       "and data/ are linked into this repository)" >&2
  exit 2
fi
REF=$(cd "$1" && pwd)
cd "$(dirname "$0")/../.."

for prot in PABP_YEAST_Fields2013 GFP_AEQVI_Sarkisyan2016 \
            UBE4B_MOUSE_Klevit2013-nscor_log2_ratio; do
  mkdir -p "weights/$prot"
  for f in "$REF/weights/$prot"/*; do
    ln -sf "$f" "weights/$prot/$(basename "$f")"
  done
done

mkdir -p weights/mnist_models data/mnist data/proteins
for f in "$REF/weights/mnist_models"/*; do
  ln -sf "$f" "weights/mnist_models/$(basename "$f")"
done
for f in "$REF/data/mnist"/*; do
  ln -sf "$f" "data/mnist/$(basename "$f")"
done
for f in "$REF/data/proteins"/*; do
  ln -sf "$f" "data/proteins/$(basename "$f")"
done
echo "linked reference artifacts from $REF"
