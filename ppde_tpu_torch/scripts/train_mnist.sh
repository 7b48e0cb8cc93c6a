#!/bin/bash
# Train the full MNIST model zoo: 3 sum-regression ensemble members
# (sumTo=10), the held-out oracle (sumTo=18, 64 channels), the DAE and the
# EBM unsupervised experts.
# Counterpart of scripts/train_mnist.sh: the same variables and flags, each
# trainer through the port's entry points (python -m
# ppde_tpu_torch.scripts.<entry>, on the GPU by default), run from the
# repository root. Set MNIST_SOURCE to a directory with raw MNIST (idx or
# npy); the default 'synthetic' runs the full pipeline on deterministic
# fake data.
set -euo pipefail
cd "$(dirname "$0")/../.."

MNIST_SOURCE=${MNIST_SOURCE:-synthetic}
OUT=${OUT:-weights/mnist_models_retrained}
ITERS_REG=${ITERS_REG:-25000}
ITERS_ORACLE=${ITERS_ORACLE:-60000}
ITERS_DAE=${ITERS_DAE:-40000}
ITERS_EBM=${ITERS_EBM:-10000}

PY="python"
export PYTHONPATH=.:${PYTHONPATH:-}

for seed in 0 1 2; do
  $PY -m ppde_tpu_torch.scripts.train_binary_mnist_regression \
    --mnist_source "$MNIST_SOURCE" --output_dir "$OUT" \
    --name "ensemble_${seed}" --sum_to 10 --n_channels 16 \
    --n_iters "$ITERS_REG" --seed "$seed"
done

$PY -m ppde_tpu_torch.scripts.train_binary_mnist_regression \
  --mnist_source "$MNIST_SOURCE" --output_dir "$OUT" \
  --name one-hot_GT --sum_to 18 --n_channels 64 \
  --n_iters "$ITERS_ORACLE" --seed 7

$PY -m ppde_tpu_torch.scripts.train_binary_mnist_dae \
  --mnist_source "$MNIST_SOURCE" --output_dir "$OUT" \
  --n_iters "$ITERS_DAE"

$PY -m ppde_tpu_torch.scripts.train_binary_mnist_ebm \
  --mnist_source "$MNIST_SOURCE" --output_dir "$OUT" \
  --n_iters "$ITERS_EBM"
