#!/bin/bash
# Round-4 master queue: regenerate every evidence artifact serially. Each
# phase script skips cells whose summary already exists, so the queue is
# cheap to re-run after an interruption.
#
# Usage: ppde_tpu_torch/scripts/run_r4_all.sh  (logs to logs/r4_queue.log)
# Counterpart of scripts/run_r4_all.sh: the same arguments, paths, skip
# checks, failure lines and flags, each step through the port's entry
# points (python -m ppde_tpu_torch.scripts.<entry>, on the GPU by
# default); its phases are the port's
# copies, run as executables, run from the repository root.
set -uo pipefail
cd "$(dirname "$0")/../.."
mkdir -p logs

run() {
  echo "=== [queue $(date +%H:%M:%S)] $*" >&2
  "$@" || echo "=== [queue] PHASE FAILED (continuing): $*" >&2
}

run ppde_tpu_torch/scripts/run_r4_family_cells.sh        # VERDICT #1: Tables 1-2 family rows
run ppde_tpu_torch/scripts/run_r4_evidence.sh proteins   # VERDICT #2: committed summaries
run ppde_tpu_torch/scripts/run_r4_650m.sh                # VERDICT #3: 650M quality row
run ppde_tpu_torch/scripts/run_r4_evidence.sh mnist      # VERDICT #2: MNIST matrices
run ppde_tpu_torch/scripts/run_r4_qc_pt.sh all           # VERDICT #5/#8: QC + PT value case
echo "=== [queue $(date +%H:%M:%S)] r4 queue complete" >&2
