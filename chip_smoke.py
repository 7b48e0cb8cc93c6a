#!/usr/bin/env python3
"""Drive ppde_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises; the script then exits non-zero and prints
no result line):
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. kernel A (fused Potts energy + gradient) against its plain version at
     GFP width (P = 4864), B in {128, 1024, 1000}, float32 (three bf16
     planes) and bfloat16, each on the symmetric couplings and on a copy
     made asymmetric (the kernel must give xf @ W, not xf @ W.T); from
     couplings prepared once, as the sampler has them, and from W and h
     (the same bits); timed beside torch.addmm;
  3. kernel B (fused CNN-ensemble fitness + input gradient) against its
     plain version at GFP width (M=3, C=237, L=237), same batches and types,
     both max-pool backward modes, plus an input with exact ties and, in
     float32, one that is not one-hot; weights prepared once, as the
     sampler has them, and in the stacked layout; then B's wide kernels
     at the reference width of longer wild types (C = L = 400 and 1022),
     128 random and 128 tied sequences (and at 400, 128 that are not
     one-hot), both types and modes;
  4. the PPDE-PAS sampler on GFP with the Potts + CNN-ensemble energy
     (synthetic seeded Potts, seeded 3-member ensemble, bf16, lambda=15,
     pas_length=2, nmut_threshold=10): 128 chains and 1024 chains. The
     kernels' launch counters are set to 0 just before and read just after;
  5. kernels C and C' (attention forward and backward) against their plain
     versions at ESM2's head shapes and past T = 512 (T = 1024 at hd 24
     and 64, T = 513), float32 and bfloat16, each run twice
     (bit-for-bit repeatable), held elementwise and by the relative norm
     of the difference, timed beside the plain version and
     scaled_dot_product_attention, with the floor the special function
     units set on exp beside the bound; then the qkv / rotary kernels
     (the head-major layout, q scale and rotary between ESM2's
     projections and kernel C, forward and backward) at ROTARY_CASES,
     float32 and bfloat16, bit for bit against the plain composition,
     timed beside it and against their bytes bound; then kernels T and T'
     (the MSA Transformer's tied row attention, forward and backward)
     against their plain versions at the msa-1b cell's launch (ROW_CASES:
     bf16, and float32 at 4 chains), run twice, held as C and C', timed
     beside the plain versions and one scaled_dot_product_attention over
     the [N, H, C, R hd] view; and one potts + msa-1b energy_and_grad at
     128 chains and 32 rows (counters as in 4: T, T', C and C' 12 x the
     pieces each, the layer-norm kernels 3 x 12 + 3 x the pieces each way,
     A once, the qkv / rotary kernels never); then the layer-norm kernels
     at LN_CASES (the cells' norms), float32 and bfloat16, forward and
     backward (and g's and b's gradients) against the plain composition,
     timed beside it, against their bytes bound and beside F.layer_norm on
     the bf16 tensor (the library's yardstick, which the port never calls);
  6. the same sampler with the potts + transformer-S product of experts
     (random-init ESM2 at full width and depth, bf16, lambda=1): 128 chains
     with the transformer's gradient in chain chunks of 16 and in one
     piece; counters as in 4;
  7. the directed-evolution CLI (``ppde_tpu_torch.scripts.directed_
     evolution.main``, called in-process at its defaults but for the flags
     below) on a GFP protein directory of seeded stand-ins in the reference
     layouts (``scripts/seeded_protein.py``; no Potts artifact, so the
     synthetic fallback), 128 chains, nmut_threshold 10, lambda 15: PPDE at
     the default float32 and at bf16, PPDE-PT (8 levels, bf16), simulated
     annealing and Random (200 steps), MALA-approx (100), CMA-ES (100
     generations of 16). Each run's artifact set, shapes, finite values,
     nmut budget (PPDE, PPDE-PT, SA) and saved best energies (against a fresh
     evaluation, phase 4's tolerances) are checked; PPDE and PPDE-PT must
     launch kernels A and B exactly once a step and once for the initial
     state, A in float32 (the CLI's Potts model) and B in the run's type
     (counters as in 4). The CLI's own
     output goes to chiprun_out/chip_smoke_cli.log;
  8. checkpoint/resume through the same CLI on the same directory, 128
     chains, log_every 20: PPDE at the default float32 (kernels A and B in
     float32, launched in both halves), PPDE-PT (8 levels, bf16), SA and
     CMA-ES, each cut at 40 steps (generations) with --checkpoint_dir and
     resumed to 80, held bit for bit against an uncut 80-step run (best_x,
     best_energy, final population, energy, fitness and oracle
     histories); each save's time and size, at 128 chains and for PPDE at
     1024; one warm PPDE segment inside ``profiling.trace``, whose trace
     must hold kernels under the spans ``kernel.a`` and ``kernel.b``;
  9. the MNIST-sum CLI (``ppde_tpu_torch.scripts.mnist_sum.main``) at the
     reference defaults (128 chains, 200 steps, lambda 10, log_every 50)
     on seeded stand-ins (``scripts/seeded_mnist.py``) and the tracked
     64-channel EBM, ``--metrics csv``: PPDE-PAS (pas_length 10),
     PPDE-GWG, PPDE-PT, SA, MALA-approx, CMA-ES, and PPDE-PAS on the
     tracked DAE. Gates: finite energies, a binary [128, 784] final_x, an
     acceptance rate strictly inside (0, 1) for the PPDE runs, each chain's
     best energy at least its start, the saved bests against a fresh
     evaluation (phase 4's tolerances), one CSV row per oracle record; no
     port kernel launched (counters as in 4); launches per step and the
     device busy share from two traced short runs. The CLI's output goes
     to chiprun_out/chip_smoke_mnist.log;
 10. protein evaluation on the same seeded GFP directory: the protein CLI
     (PPDE, 200 steps, 128 chains) with MSA-Transformer scoring on over
     500 rows of the tracked GFP synthetic alignment, once without weights
     (the [skip] line) and once with an msa-S file written here (scores);
     ``eval_proteins.main`` on the first run at full width (msa-1b, random
     init, bf16, --update_summary): finite scores, the summary's density
     keys, ms per masked column, the share of the bf16 peak, peak memory,
     and one masked column in bf16 against float32 (EVAL_LOGP_TOL);
     ``eval_expert_correlation.main`` (512 mutants, transformer-S and
     msa-1b columns): every rho finite, kernel C launched 12 x (1 +
     512 / 64) = 108 times and C', A, B never; ``select_lambda``,
     ``calibrate_oracle_scale --out_npz`` (its round-trip assertions) on a
     UBE4B-layout directory with the tracked fit, and ``make_figures``.
     Output: chiprun_out/chip_smoke_eval.log.
 11. training and fitting, each entry point's main on the tracked GFP
     alignment: finetune_esm at transformer-S (full width and depth,
     random init, batch 32, 200 steps, --val_frac 0.1): every logged loss
     finite, the held-out CE after below the one before, kernel C launched
     12 x (200 + 2 x 4) and C' 12 x 200 times, the checkpoint reloaded
     and run in the protein CLI as --esm_weights; at transformer-L cut to
     4 layers with --lora_rank 8 (20 steps, remat: C 2 x 4 x 20 and C'
     4 x 20 launches, the _lora_ files and the merged file); fit_potts at
     its defaults (the loss falls) and sample_potts_msa from the fit (500
     sequences, finite QC correlations); finetune_msa at msa-S (200 steps,
     reloaded); the three MNIST trainers (synthetic source), their
     checkpoints read back equal and loaded by mnist_sum and
     eval_mnist_ebm. Steps/s, tokens/s, the ESM runs' share of the bf16
     peak (model FLOPs over the training time) and peak memory. Output:
     chiprun_out/chip_smoke_training.log.
 12. multi-device, at GFP width (the card is one, so the collectives run at
     world size 1; kernels at the shapes a shard gives them): (a) kernel A
     on every column block of the couplings at tp = 2 and 4 (P re-padded to
     a multiple of 128 tp), 128 and 1024 chains, float32 and bf16, each
     block held against its plain version and the blocks, assembled in
     rank order (gradients side by side, energy shares summed), against
     the whole call, with phase 2's tolerances; each block's time beside
     the whole call's; (b) kernel B on both member blocks of a seeded
     4-member ensemble at ep = 2, combined (each block's mean weighted by
     its half) and held against the whole ensemble's call, phase 3's
     tolerances; (c) kernels C and C' at transformer-S's Megatron shapes at
     tp = 4 (5 heads a rank: Z = 128 x 5, hd = 24) against their plain
     versions, phase 5's tolerances; (d) a child started by ``torchrun
     --nproc_per_node 1`` (world size 1, backend nccl, which it asserts)
     runs the CLI with --mesh_dp 1 for PPDE f32 at phase 7's settings and
     ``training.train_esm_mlm(mesh=make_mesh(dp=1))`` at transformer-S, and
     reports its launch counts: the PPDE run must equal the same run
     without a mesh (here, in process) bit for bit (best_x, energies,
     histories) and launch A and B once a step (and once for the initial
     state); steps/s with and without the mesh; (e) the peak memory
     (``torch.cuda.max_memory_allocated``) of the one-piece transformer
     gradient, random-init bf16 at full width and depth: transformer-S, -M
     and -L at 128 chains, S and M at 1024 (a run that does not fit is
     recorded so); L at 1024 is predicted from its slope per chain. Output:
     chiprun_out/chip_smoke_mesh.log.
 13. the port's benchmark, ``python -m ppde_tpu_torch.scripts.bench`` at
     its defaults but for the steps of BENCH_ARGV (potts at 128 chains
     600 of 2,000, MNIST 300 of 2,000), in a subprocess (GFP potts PoE
     at 128 and 1024 chains,
     potts + transformer-S at 128, MNIST PPDE-PAS-10 on the EBM at 128;
     bf16): exit code 0, its one JSON line with every key, the four
     configurations with finite positive rates and three execution times,
     the run checks passed, the headline rule, and each kernel's launches
     exactly as the configuration makes them: A and B once for the initial
     state and once a step over the untimed and the timed executions, C
     and C' 12 times as often on the transformer configuration (one piece
     at 128 chains), none on MNIST. The bench's launches join the kernels
     line; its line goes to chiprun_out/chip_smoke.json (its stderr to
     chiprun_out/chip_smoke_bench.log), beside phases 4 and 6's ppde.run
     rates of the same configurations;
 14. the large ESM2 experts at full width and depth (transformer-M: 30
     layers, hd 32; transformer-L: 33 layers, hd 64, remat) through the
     calls the port's experiment drivers make (``driver_calls``: each
     driver run with a stub python that records its arguments; paths,
     step counts and log cadences substituted), each entry point's main
     in process on the seeded GFP directory and the tracked GFP synthetic
     alignment: (a) run_protein_samplers.sh's transformer cell for GFP
     (transformer-M alone from a seeded random-init file, lambda 1, 128
     chains, the CLI's float32 CNN, one piece, 60 steps); (b)
     run_r5_150m.sh: finetune_esm transformer-M, LoRA 8, batch 16 (60 of
     1,200 steps), then the potts+transformer-M PPDE cell on the merged
     file it wrote (bf16 CNN, chunks of 64, msa-S scoring, 40 of 1,000
     steps); (c) run_r4_650m.sh: the same at transformer-L, batch 8 (40
     and 30 steps). Exact launches of A, B, C and C' in every run
     (``cell_launches``; a fine-tune step: C (1 + remat) and C' once a
     layer, plus 4 forwards a layer for each held-out CE); the cells'
     artifacts by phase 7's checks; the fine-tunes' logged losses and
     held-out CEs finite, their files, and the merged file equal to the
     LoRA file merged anew (every weight, and the PLL of 8 sequences);
     steps/s, wall steps/s, peak memory and the share of the bf16 peak
     (model FLOPs: 2 forwards a step, ``esm_forward_flops``; the
     fine-tunes': ``esm_train_flops``). Phase 5 holds kernels C and C' at
     these runs' shapes (``LARGE_ATTN_CASES``). Output:
     chiprun_out/chip_smoke_large.log;
 15. the evidence drivers (``ppde_tpu_torch/scripts/run_r4_*.sh``,
     ``run_r5_{family10k,ljdecision}.sh``): their calls recorded with the
     stub python in a temporary tree laid out as the repository (the
     tracked GFP alignment and msa-S scorer copied in, seeded GFP and
     MNIST stand-ins at the drivers' paths; UBE4B's calls on the GFP
     stand-in), each entry point's main run in process from that tree:
     (a) run_r5_family10k.sh: finetune_esm transformer-S, batch 64, lr
     3e-4, val_frac 0.05 (EVID_FT_STEPS of 4,000), then ``run_cells
     --r5_family --only GFP`` on its file: 8 cells (potts+transformer-S
     and transformer-S x 4 seeds, msa-S scoring over 500 rows,
     EVID_CELL_STEPS of 10,000) in one process; each cell's launches exact
     (``cell_launches``), phase 7's artifact checks, its summary at the
     cut n_iters, its peak memory flat over its expert's cells within
     EVID_MEM_MARGIN; one cell run again alone equal to its grid run bit
     for bit; the grid run again skipping every cell (no launch, no file
     rewritten); (b) ``eval_esm_heldout_ce`` on random init and the
     fine-tune's checkpoint: the fine-tune's held-out count and its
     before / after CEs to the printed 4 decimals, C 12 x 4 a CE; (c)
     run_r4_evidence.sh's GFP ref-rev, lambda-0, supervised-only and
     CMA-ES cells and run_r4_qc_pt.sh's supervised PPDE and PPDE-PT
     (EVID_STEPS, EVID_CMAES_GENS): launches exact (A 0 without a Potts
     term, none for CMA-ES), phase 7's checks, the summaries; (d)
     fit_potts --lambda_J 0.001, select_lambda, both calibrate_oracle_
     scale records of run_r5_ljdecision.sh, sample_potts_msa at 8192
     sequences (EVID_QC_SWEEPS of 1,200 sweeps) with a finite QC r; (e)
     run_r4_scorer_eval.sh's msa-S correlations (random and the tracked
     scorer), two r4full mnist_sum runs and the EBM-scored summary of
     them: finite values, no port kernel launched in (d) or (e) but the
     msa-S scorer's layer norms (a multiple of ``msa_norms``). The
     repository's results/ must be unchanged. From this run's rates, the
     drivers' predicted wall times at their real settings. Output:
     chiprun_out/chip_smoke_evidence.log.
 16. long proteins: the protein CLI (PPDE, 128 chains, phase 7's flags) on
     seeded wild types drawn from a numpy seed with the reference-width
     CNN (C = L): 400 residues with the potts expert, the CNN in float32
     and in bf16 (kernel A and B's wide kernel), and 1022 residues with
     potts+transformer-S (random init, one piece) and the float32 CNN (A,
     B's wide kernel, and the key-tiled C and C' at T = 1022). Launches
     exact (``cell_launches``), phase 7's checks, an acceptance rate
     inside (0, 1); steps/s (the CLI's, over segments of LONG_LOG_EVERY
     steps, the first left out), peak memory, the device time of A, B, C
     and C' in one traced energy_and_grad, and at 1022 the one-piece
     transformer gradient's peak memory against runtime.ESM_GRAD_MEMORY.
     Output: chiprun_out/chip_smoke_long.log.
Wherever a phase holds ESM2's kernels C and C' to a launch count, it
holds the qkv / rotary kernels to the same count (ESM2 launches one of each
a layer beside C and C'; ``with_rotary``); the MSA Transformer's column
attention launches C and C' without them (phase 5's energy call). Where it
holds a run's every counter, the layer-norm kernels too: 2 x layers + 2 a
forward of ESM2 each way (the layers' twice under remat), 3 x layers + 3
of the MSA Transformer (``esm_norms``, ``msa_norms``).
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.
Detailed results go to chiprun_out/chip_smoke.json. Phase 5 alone (the
kernels build at first use):

    python3 -c 'import torch, chip_smoke
    from ppde_tpu_torch.ops import attention_fused as a
    chip_smoke.phase_attention(torch, a, torch.device("cuda"))'
"""
from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# the run checks, shared with the port's benchmark (one copy)
from ppde_tpu_torch.scripts.bench import (  # noqa: E402
    COUNTERS, check, check_run)

# GFP wild type (L = 237), the sequence the JAX package's bench.py uses
GFP_WT = (
    "SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTLSYGVQCFSRY"
    "PDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNS"
    "HNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVL"
    "LEFVTAAGITHGMDELYK"
)
BATCHES = (128, 1024, 1000)  # the sampler's two populations and a ragged B
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # no-TC f32, dense bf16 TC
# phase 4: (chains, steps, log_every); two warm segments each, beside the
# bench's rates of the same configurations (phase 13)
SAMPLER_RUNS = ((128, 300, 100), (1024, 300, 100))
# phase 14's calls of kernels C and C' (GFP, T = 237: the experts take no
# BOS / EOS), 20 heads a sequence: transformer-M (hd 32) and -L (hd 64) in
# one piece of 128 chains and in chunks of 64, the fine-tunes' batches (16
# at M, 8 at L), their held-out CE (100 sequences) and the wild type alone
LARGE_ATTN_CASES = (
    ("M_one_piece", (2560, 237, 32)), ("M_chunk_64", (1280, 237, 32)),
    ("L_chunk_64", (1280, 237, 64)), ("L_one_piece", (2560, 237, 64)),
    ("finetune_M", (320, 237, 32)), ("finetune_L", (160, 237, 64)),
    ("heldout_ce_M", (2000, 237, 32)), ("heldout_ce_L", (2000, 237, 64)),
    ("wild_type_M", (20, 237, 32)), ("wild_type_L", (20, 237, 64)))
# (Z, T, hd) of kernels C and C': the transformer path's calls at chunk 16
# and in one piece (ESM2-S: 20 heads, hd 24), the M and L head widths, the
# longest T, a small ragged case, eval_expert_correlation's calls (a chunk
# of 64 mutants, and the wild type alone), and finetune_esm's: a batch of
# 32 at transformer-S and -L (hd 64), and the held-out CE's 200 sequences
ATTN_CASES = ((320, 237, 24), (2560, 237, 24), (320, 237, 32),
              (320, 237, 64), (20, 512, 64), (7, 33, 16),
              (1280, 237, 24), (20, 237, 24), (640, 237, 24),
              (640, 237, 64), (4000, 237, 24))
ATTN_CASES += tuple(case for _, case in LARGE_ATTN_CASES
                    if case not in ATTN_CASES)
# proteins past the register kernels' T = 256 (the key-tiled kernels):
# ESM2's trained context at transformer-S's and -L's head widths, one
# piece of 128 chains, the shape phase 16's wild type of 1022 residues
# gives them (the expert adds no BOS / EOS: T = L, a partial last 64-row
# tile), and a wild type of 513 residues alone
LONG_ATTN_CASES = ((2560, 1024, 24), (2560, 1024, 64), (2560, 1022, 24),
                   (20, 513, 24))
ATTN_CASES += LONG_ATTN_CASES
# phase 5: (B, T, heads, hd) of the qkv / rotary kernels: ESM2-150M's call
# at GFP in one piece of 128 chains (the benchmark's ESM cell; the kernels
# line's headline), transformer-S's in one piece and in chunks of 16,
# transformer-L's, M's at tp 2 (10 heads a rank), phase 16's 1022 residues
# at S, the wild type alone, a small ragged case
ROTARY_CASES = ((128, 237, 20, 32), (128, 237, 20, 24), (16, 237, 20, 24),
                (128, 237, 20, 64), (128, 237, 10, 32), (128, 1022, 20, 24),
                (1, 237, 20, 32), (7, 33, 4, 8))
# phase 5: (N, R, C, H, hd, dtype) of kernels T and T' (tied row
# attention): the msa-1b cell's launch (a piece of 26 of 128 chains, 32
# rows, GFP's 238 columns with <cls>, 12 heads of 64; the kernels line's
# headline), and float32 at the same layer (the SIMT kernels), 4 chains
ROW_CASES = ((26, 32, 238, 12, 64, "bfloat16"),
             (4, 32, 238, 12, 64, "float32"))
# phase 5: (rows, D) of the layer-norm kernels: the ESM2-150M cell's norm
# (128 chains of GFP's 237 positions, 640; the kernels line's headline),
# the 35M cell's (512 chains, 480), the msa-1b cell's (a piece of 26
# chains, 32 rows, 238 columns, 768), transformer-L's (1280) and a row
# count that is not a multiple of a block's 8 rows
LN_CASES = ((128 * 237, 640), (512 * 237, 480), (26 * 32 * 238, 768),
            (128 * 237, 1280), (1001, 640))
ROW_ENERGY = ("msa-1b", 128, 32)  # expert, chains, rows of the energy call
# phase 3: kernel B's wide kernel at the reference width (C = L) of
# wild types of these lengths
LONG_CNN_LENGTHS = (400, 1022)
TRANSFORMER_RUN = (128, 40, 20)                    # chains, steps, log_every
TRANSFORMER_CHUNKS = (16, None)
# phase 7: (label, sampler, steps, extra CLI flags) at CLI_CHAINS chains
CLI_RUNS = (
    ("PPDE-f32", "PPDE", 200, ()),
    ("PPDE-bf16", "PPDE", 200, ("--compute_dtype", "bf16")),
    ("PPDE-PT-bf16", "PPDE-PT", 200, ("--compute_dtype", "bf16",
                                      "--pt_levels", "8")),
    ("SA", "simulated_annealing", 200, ()),
    ("Random", "Random", 200, ()),
    ("MALA-approx", "MALA-approx", 100, ()),
    ("CMAES", "CMAES", 100, ("--cmaes_population_size", "16")),
)
CLI_CHAINS, CLI_LOG_EVERY, CLI_NMUT = 128, 50, 10
CLI_PROTEIN = "GFP_AEQVI_Sarkisyan2016"
# phase 8: (label, sampler, extra CLI flags), each cut at CKPT_CUT of
# CKPT_STEPS and resumed; CKPT_BIG_CHAINS: the save time at 1024 chains
CKPT_RUNS = (
    ("PPDE-f32", "PPDE", ()),
    ("PPDE-PT-bf16", "PPDE-PT", ("--compute_dtype", "bf16",
                                 "--pt_levels", "8")),
    ("SA", "simulated_annealing", ()),
    ("CMAES", "CMAES", ("--cmaes_population_size", "16")),
)
CKPT_CUT, CKPT_STEPS, CKPT_LOG_EVERY, CKPT_BIG_CHAINS = 40, 80, 20, 1024
CKPT_COMPARED = ("best_x", "best_energy", "final_x", "energy_history",
                 "fitness_history", "oracle_history")
# phase 9: the MNIST-sum CLI at the reference defaults (128 chains, 200
# steps, lambda 10, log_every 50): (label, sampler, extra CLI flags)
MNIST_RUNS = (
    ("PPDE-PAS", "PPDE", ("--ppde_pas_length", "10")),
    ("PPDE-GWG", "PPDE", ("--ppde_pas_length", "0")),
    ("PPDE-PT", "PPDE-PT", ()),
    ("SA", "simulated_annealing", ()),
    ("MALA-approx", "MALA-approx", ()),
    ("CMAES", "CMAES", ()),
    ("PPDE-PAS-dae", "PPDE", ("--ppde_pas_length", "10",
                              "--unsupervised_expert", "dae")),
)
MNIST_CHAINS, MNIST_STEPS, MNIST_LOG_EVERY = 128, 200, 50
MNIST_TRACE_STEPS = (10, 20)  # two traced runs: launches per step between
# phase 10: protein evaluation at full width. The scorer is msa-1b (random
# init, bf16) with 500 alignment rows of the tracked GFP synthetic
# alignment; the population is a 200-step PPDE CLI run at 128 chains
EVAL_MSA = os.path.join("data", "proteins", "synthetic",
                        "GFP_AEQVI_Sarkisyan2016_synth.a2m")
EVAL_MSAT, EVAL_MSA_SIZE, EVAL_STEPS = "msa-1b", 500, 200
EVAL_SMALL_MSAT = "msa-S"       # the CLI's scoring run with a weights file
EVAL_MUTANTS, EVAL_MAX_MUT, EVAL_ESM_CHUNK = 512, 4, 64
EVAL_LOGP_TOL = 0.1  # msa-1b bf16 log-probs against float32, one column
# phase 11: training and fitting on the tracked GFP alignment (2,000 rows
# and the wild type). finetune_esm at transformer-S (full width and depth,
# random init, the CLI's defaults: batch 32, lr 1e-4, warmup 100,
# reweighting) cut from 5,000 to TRAIN_S_STEPS steps; at transformer-L
# (full width, cut to TRAIN_L_LAYERS layers: the merged 33-layer file alone
# is 2.6 GB to compress) with LoRA; fit_potts at its defaults (500 steps);
# sample_potts_msa with POTTS_SEQS chains and POTTS_SWEEPS sweeps (200 at
# its default); finetune_msa at msa-S cut from 3,000 steps; the MNIST
# trainers on the synthetic source, cut from 25,000 / 40,000 / 10,000
TRAIN_S_STEPS, TRAIN_VAL_FRAC, TRAIN_LOG_EVERY = 200, 0.1, 50
TRAIN_L_STEPS, TRAIN_L_LAYERS, TRAIN_LORA_RANK = 20, 4, 8
TRAIN_CLI_STEPS = 10  # the protein CLI on the fine-tuned expert
POTTS_SEQS, POTTS_SWEEPS = 500, 50
TRAIN_MSA_STEPS = 200
MNIST_TRAIN_STEPS = {"regression": 200, "dae": 100, "ebm": 40}
EBM_EVAL_STEPS = 200
# phase 12: kernel A's column blocks (tp) and kernel B's member blocks
# (ep) at these populations; the world-size-1 mesh run of the CLI (phase
# 7's PPDE f32) and MESH_TRAIN_STEPS steps of train_esm_mlm at
# transformer-S (batch 32) with and without the mesh; the one-piece
# transformer gradient's peak memory at (config, chains)
MESH_TPS, MESH_BATCHES, MESH_EP_MEMBERS = (2, 4), (128, 1024), 4
MESH_CLI_STEPS, MESH_TRAIN_STEPS, MESH_TRAIN_BATCH = 200, 20, 32
MEM_RUNS = (("transformer-S", 128), ("transformer-M", 128),
            ("transformer-L", 128), ("transformer-S", 1024),
            ("transformer-M", 1024))
MEM_PREDICTED = (("transformer-L", 1024),)
UBE4B = "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio"
CLI_ARTIFACTS = ("config.txt", "population.npy", "pred_fitness_scores.npy",
                 "oracle_fitness_scores.npy", "potts_scores.npy",
                 "energy_scores.npy", "energy_history.npy",
                 "fitness_history.npy", "summary.json")

# phase 13: the port's benchmark at its defaults, in a subprocess; its four
# configurations (domain, chains, expert) and its time limit in seconds
BENCH_CONFIGS = (("gfp", 128, "potts"), ("gfp", 1024, "potts"),
                 ("gfp", 128, "potts+transformer-S"),
                 ("mnist", 128, "ebm_poe_pas10"))
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
BENCH_DETAIL_KEYS = ("configs", "headline_n_chains",
                     "torch_cpu_reference_steps_per_sec",
                     "torch_cpu_reference_chain_steps_per_sec", "dtype",
                     "card")
BENCH_ROW_KEYS = ("domain", "n_chains", "expert", "sampler_steps_per_sec",
                  "chain_steps_per_sec", "execution_s", "launches", "checks")
BENCH_TIMEOUT = 700
# the bench's flags in phase 13: its defaults but for the steps of the
# potts 128-chain and the MNIST configurations (2,000 each), cut to keep
# the whole script under 1,000 s with phase 16
BENCH_ARGV = ("--steps", "600", "--steps-mnist", "300")
# phase 14: the large ESM2 experts at full width and depth, through the
# calls the port's experiment drivers make (recorded with a stub python,
# ``driver_calls``; paths, step counts and log cadences substituted): the
# paper's transformer cell of run_protein_samplers.sh for GFP
# (transformer-M alone, one piece of 128 chains: LARGE_SWEEP_STEPS of
# 10,000), and run_r5_150m.sh / run_r4_650m.sh: (driver, expert,
# fine-tune steps of 1,200 / 800, cell steps of 1,000); their cells'
# --esm_chunk
LARGE_SWEEP_STEPS, LARGE_LOG_EVERY = 60, 10
LARGE_ROWS = (("run_r5_150m.sh", "transformer-M", 60, 40),
              ("run_r4_650m.sh", "transformer-L", 40, 30))
LARGE_CHUNK = 64
# phase 15: the evidence drivers' calls, recorded in a temporary tree laid
# out as the repository (``driver_calls(root=)``) and run in process from
# it, cut: the fine-tune of run_r5_family10k.sh (EVID_FT_STEPS of 4,000);
# GFP's 8 family cells of run_cells --r5_family (EVID_CELL_STEPS of
# 10,000); run_r4_evidence.sh's and run_r4_qc_pt.sh's flags (EVID_STEPS of
# 10,000; CMA-ES EVID_CMAES_GENS of 1,000); sample_potts_msa at the QC
# ladder's largest rung (EVID_QC_SWEEPS of 1,200 sweeps); two mnist_sum
# r4full runs (EVID_MNIST_STEPS of 20,000). EVID_MEM_MARGIN: the bytes by
# which a family cell's peak memory may exceed the first cell of its
# expert (a leaked bf16 copy of transformer-S's weights is 70 MB)
EVID_FT_STEPS, EVID_CELL_STEPS, EVID_STEPS, EVID_CMAES_GENS = 200, 60, 200, 100
EVID_QC_SWEEPS, EVID_MNIST_STEPS, EVID_MNIST_LOG_EVERY = 60, 200, 50
EVID_MEM_MARGIN = 64 << 20
EVID_RERUN = 0  # the grid's cell run again alone, after the grid
EVID_CELLS = 8  # GFP's cells of r5_family_spec
# (c): the cells of run_r4_evidence.sh proteins taken (their summaries'
# names), and all of run_r4_qc_pt.sh pt
EVID_FLAG_CELLS = ("GFP_PPDE-refrev_s1234567", "GFP_PPDE-pottsonly_s1234567",
                   "GFP_PPDE-suponly_s1234567", "GFP_CMAES_s1234567")
# phase 15's calls of kernels C and C' (transformer-S, hd 24): a family
# cell's one piece of 128 chains, the fine-tune's batch of 64, the held-out
# CE's 100 sequences and the wild type alone
EVID_ATTN_CASES = (
    ("family_cell_one_piece", (2560, 237, 24)),
    ("finetune_batch_64", (1280, 237, 24)),
    ("heldout_ce_S", (2000, 237, 24)), ("wild_type_S", (20, 237, 24)))
ATTN_CASES += tuple(case for _, case in EVID_ATTN_CASES
                    if case not in ATTN_CASES)
# phase 16: proteins of more than 256 residues through the protein CLI
# (PPDE at CLI_CHAINS chains, phase 7's flags), wild types of these lengths
# drawn from a numpy seed (LONG_SEED + L), seeded stand-ins with the
# reference-width CNN (C = L): (label, L, expert, --compute_dtype, steps)
LONG_RUNS = (("L400 potts f32", 400, "potts", "f32", 40),
             ("L400 potts bf16", 400, "potts", "bf16", 40),
             ("L1022 potts+transformer-S f32", 1022, "potts+transformer-S",
              "f32", 30))
LONG_SEED = 14
# segments of this many steps: the CLI's steps/s leaves out the first
# (its first launches), so the first run in a process reads as the others
LONG_LOG_EVERY = 10
DRIVER_STUB = """#!/bin/bash
{ printf '%s\\037' "$@"; printf '\\036'; } >> "$STUB_LOG"
exit "${STUB_RC:-0}"
"""


def reps_for(ms):
    """Repetitions of a timed call: at least 20 below 1 ms, 10 above."""
    return 20 if ms < 1.0 else 10


def time_ms(fn, reps=None):
    """Mean device milliseconds of fn over reps launches (default: by
    ``reps_for`` of a first estimate), by CUDA events, after a warm-up call.
    The device is kept busy while the host enqueues the launches, so a
    wrapper whose host side is slower than its kernels is still timed by its
    kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # enqueue time of one call
    torch.cuda.synchronize()
    if reps is None:
        reps = reps_for((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin the device (about 1.7 cycles a nanosecond) for as long as the
    # host needs to enqueue all reps, at most 0.3 s
    torch.cuda._sleep(int(min(host_s * reps * 1.2, 0.3) * 1.7e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_onehot(torch, gen, B, L, dev):
    toks = torch.randint(0, 20, (B, L), generator=gen, device=dev)
    return torch.nn.functional.one_hot(toks, 20).float()


def phase_potts(torch, potts, potts_fused, dev):
    """Kernel A vs plain at GFP width: float32 (three bf16 planes) and bf16
    on the model's symmetric couplings and on a W that is not symmetric;
    from couplings prepared once, as the sampler has them, and from W and h
    (prepared on the spot: the same bits)."""
    p32 = potts.synthetic(GFP_WT, seed=0, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    P = p32.padded_dim
    out = []
    for dtype, w_kind in itertools.product(
            (torch.float32, torch.bfloat16), ("symmetric", "upper triangle")):
        W, h = p32.W.to(dtype), p32.h.to(dtype)
        if w_kind == "upper triangle":
            W = torch.triu(W).contiguous()
        check(torch.equal(W, W.T) == (w_kind == "symmetric"),
              f"W is not as asked: {w_kind}")
        dn = str(dtype).split(".")[-1]
        prep = potts_fused.prepare(W, h)
        if dtype == torch.float32:
            check(torch.equal(prep.planes.float().sum(0), W),
                  "kernel A: the planes do not sum to W")
            # rows of one 1 each: the plain float32 result is W[k] + h,
            # exactly, and so must the kernel's be, every plane (lo
            # included) added without loss; all P rows (no split over K)
            # and 128 of them (split)
            eye = torch.eye(P, dtype=torch.bfloat16, device=dev)
            for rows in (eye, eye[::P // 128][:128]):
                He, ge = potts_fused.energy_and_grad(prep, None, rows)
                He0, ge0 = potts_fused.energy_and_grad_plain(W, h, rows)
                want = W[rows.float().argmax(-1)] + h
                check(torch.equal(ge, ge0) and torch.equal(ge, want)
                      and torch.equal(He, He0),
                      f"kernel A {w_kind}, {rows.shape[0]} one-1 rows: not "
                      f"W[k] + h bit for bit (max abs err "
                      f"{(ge - ge0).abs().max().item()})")
            del eye, rows, He, ge, He0, ge0, want
        for B in BATCHES:
            x = random_onehot(torch, gen, B, len(GFP_WT), dev)
            # as the sampler's path does: one-hots padded and cast to bf16
            xf = potts._pad_flat(p32, x, torch.bfloat16)
            xw = xf.to(dtype)

            def kernel():
                return potts_fused.energy_and_grad(prep, None, xf)

            H, g = kernel()
            H0, g0 = potts_fused.energy_and_grad_plain(W, h, xw)
            torch.cuda.synchronize()
            err_g = (g - g0).abs().max().item()
            err_H = (H - H0).abs().max().item()
            rel_H = ((H - H0).abs() / H0.abs().clamp_min(1.0)).max().item()
            # float32 sums in another order; products with one-hots exact
            check(torch.allclose(g, g0, rtol=1e-5, atol=1e-4),
                  f"kernel A grad B={B} {dn} {w_kind}: max abs err {err_g}")
            check(torch.allclose(H, H0, rtol=1e-5, atol=1e-3),
                  f"kernel A energy B={B} {dn} {w_kind}: max abs err "
                  f"{err_H}")
            H2, g2 = kernel()
            check(torch.equal(H, H2) and torch.equal(g, g2),
                  "kernel A is not deterministic")
            H3, g3 = potts_fused.energy_and_grad(W, h, xf)
            check(torch.equal(H, H3) and torch.equal(g, g3),
                  "kernel A: W as it is and prepared disagree")
            ms = time_ms(kernel)
            plain = time_ms(
                lambda: potts_fused.energy_and_grad_plain(W, h, xw))
            lib = time_ms(lambda: torch.addmm(h, xw, W))
            # bytes: each input read once at its own size (xf bf16, W and
            # h), outputs written once (grad, H float32); operations: the
            # multiply-adds this one-hot input needs (2 per nonzero of xf
            # per column of W)
            nnz = int(torch.count_nonzero(xf).item())
            n_bytes = (xf.numel() * xf.element_size()
                       + W.numel() * W.element_size()
                       + h.numel() * h.element_size()
                       + g.numel() * g.element_size()
                       + H.numel() * H.element_size())
            bms, by = bound_ms(n_bytes, 2 * nnz * P + 4 * B * P, dn)
            out.append({"B": B, "dtype": dn,
                        "W": w_kind,
                        "max_abs_err_grad": err_g, "max_abs_err_H": err_H,
                        "max_rel_err_H": rel_H, "tol": "rtol 1e-5, atol "
                        "1e-4 (grad) / 1e-3 (H)", "kernel_ms": ms,
                        "plain_ms": plain, "library_ms_addmm_grad_only": lib,
                        "kernel_over_addmm": ms / lib,
                        "bound_ms": bms, "bound_by": by,
                        "dense_ops_bound_ms": 2 * B * P * P / PEAK_OPS[dn]
                        * 1e3})
            print("kernel A", json.dumps(out[-1]), flush=True)
    return out


def cnn_compare(torch, fit, dx, fit0, dx0, dtype_name):
    """fit close everywhere; dx close except rare near-tie routing flips
    (summation order decides which of two nearly equal rows holds a
    channel's max): at most 0.1% of entries may differ, directions agree."""
    if dtype_name == "float32":
        f_tol, d_atol, d_rtol, cos_min = (1e-4, 1e-5), 1e-6, 1e-4, 0.9999
    else:
        f_tol, d_atol, d_rtol, cos_min = (1e-2, 1e-3), 1e-5, 2e-2, 0.999
    fit_ok = torch.allclose(fit, fit0, rtol=f_tol[0], atol=f_tol[1])
    bad = ((dx - dx0).abs() > d_atol + d_rtol * dx0.abs()).float().mean()
    cos = ((dx * dx0).sum() / (dx.norm() * dx0.norm())).item()
    return {"fit_ok": bool(fit_ok), "bad_fraction": bad.item(), "cos": cos,
            "max_abs_err_fit": (fit - fit0).abs().max().item(),
            "max_abs_err_dx": (dx - dx0).abs().max().item(),
            "ok": bool(fit_ok and bad.item() <= 1e-3 and cos >= cos_min),
            "tol": f"fit rtol {f_tol[0]} atol {f_tol[1]}; dx entries within "
                   f"atol {d_atol} + rtol {d_rtol} for >= 99.9%, cos >= "
                   f"{cos_min}"}


def cnn_ops(torch, cnn, x, M, C, C2, K):
    """Operations this input needs: the conv on the one-hot patches' nonzeros,
    the dense embed layer, and one routed row of emb_w per (sample, member,
    channel) in the backward pass."""
    B, L, V = x.shape
    T = L - K + 1
    nnz_patches = int(torch.count_nonzero(cnn.im2col(x)).item())
    return 2 * M * (nnz_patches * C + B * T * C * C2 + B * C2 * C)


def phase_cnn(torch, cnn, cnn_fused, dev):
    """Kernel B vs plain at GFP width."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ens = cnn.init_ensemble(gen, 3, input_size=len(GFP_WT))
    M, K, V, C = ens["encoder"]["w"].shape
    C2 = ens["embed"]["w"].shape[-1]
    L = len(GFP_WT)
    xgen = torch.Generator(device=dev).manual_seed(12)
    # period-5 sequences: every 5-mer window repeats, so every channel's
    # max-pool has exact ties (split and first differ there)
    base = torch.randint(0, 20, (128, 5), generator=xgen, device=dev)
    ties = torch.nn.functional.one_hot(
        base.repeat(1, -(-L // 5))[:, :L], 20).float()
    inputs = [(B, random_onehot(torch, xgen, B, L, dev)) for B in BATCHES]
    inputs.append(("128-ties", ties))
    # not one-hot: several nonzero letters at a position, or none (the
    # float32 kernel's general conv path)
    r = torch.rand((128, L, V), generator=xgen, device=dev)
    relaxed = ("128-relaxed", r * (r > 0.7))
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        w_bytes = M * (K * V * C + C * C2 + C2) * s + M * (C + C2 + 1) * 4
        prep = cnn_fused.prepare_ensemble(ens, dtype)
        for pool in ("split", "first"):
            for name, x in inputs + [relaxed] * (dtype == torch.float32):
                B = x.shape[0]
                fit, dx = cnn_fused.ensemble_apply_and_grad(prep, x, None,
                                                            pool)
                fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(
                    ens, x, dtype, pool)
                torch.cuda.synchronize()
                res = cnn_compare(torch, fit, dx, fit0, dx0, dn)
                check(res["ok"], f"kernel B B={name} {dn} {pool}: {res}")
                # again from the stacked layout (prepared on the spot): the
                # same bits, and the kernel repeats itself
                fit2, dx2 = cnn_fused.ensemble_apply_and_grad(ens, x, dtype,
                                                              pool)
                check(torch.equal(fit, fit2) and torch.equal(dx, dx2),
                      "kernel B is not deterministic")
                if name == "128-ties" and pool == "first":
                    _, dx_split = cnn_fused.ensemble_apply_and_grad(
                        prep, x, None, "split")
                    check(not torch.allclose(dx, dx_split),
                          "tie input: split and first routing agree")
                ms = time_ms(lambda: cnn_fused.ensemble_apply_and_grad(
                    prep, x, None, pool))
                plain = time_ms(
                    lambda: cnn_fused.ensemble_apply_and_grad_plain(
                        ens, x, dtype, pool))
                n_bytes = B * L * V * s + w_bytes + B * 4 + B * L * V * 4
                bms, by = bound_ms(n_bytes, cnn_ops(torch, cnn, x, M, C, C2,
                                                    K), dn)
                res.update({"B": name, "dtype": dn, "pool_bwd": pool,
                            "kernel_ms": ms, "plain_ms": plain,
                            "library_ms": None, "bound_ms": bms,
                            "bound_by": by})
                out.append(res)
                print("kernel B", json.dumps(res), flush=True)
    out += phase_cnn_long(torch, cnn, cnn_fused, dev)
    return out


def phase_cnn_long(torch, cnn, cnn_fused, dev):
    """Kernel B's wide kernel: wild types of LONG_CNN_LENGTHS residues at the
    reference width (C = L), 128 random sequences, 128 of period 5 (exact
    ties in every channel) and, at the first length, 128 that are not
    one-hot (several letters or none at a position: the general conv, in
    the forward and in the backward's relu mask), both types and pool
    modes, against the plain version at phase 3's tolerances; repeatable,
    launched once a call (on the wide kernel), split and first apart on the
    ties; the random inputs timed beside the plain version, with their
    bound."""
    out = []
    for L in LONG_CNN_LENGTHS:
        ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(L), 3,
                                input_size=L)
        M, K, V, C = ens["encoder"]["w"].shape
        C2 = ens["embed"]["w"].shape[-1]
        xgen = torch.Generator(device=dev).manual_seed(L + 1)
        base = torch.randint(0, 20, (128, 5), generator=xgen, device=dev)
        ties = torch.nn.functional.one_hot(
            base.repeat(1, -(-L // 5))[:, :L], 20).float()
        inputs = [("128", random_onehot(torch, xgen, 128, L, dev)),
                  ("128-ties", ties)]
        if L == LONG_CNN_LENGTHS[0]:
            r = torch.rand((128, L, 20), generator=xgen, device=dev)
            inputs.append(("128-relaxed", r * (r > 0.7)))
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            s = 2 if dtype == torch.bfloat16 else 4
            w_bytes = M * (K * V * C + C * C2 + C2) * s + M * (C + C2 + 1) * 4
            prep = cnn_fused.prepare_ensemble(ens, dtype)
            for pool in ("split", "first"):
                for name, x in inputs:
                    n0 = cnn_fused.launches_wide
                    fit, dx = cnn_fused.ensemble_apply_and_grad(prep, x, None,
                                                                pool)
                    check(cnn_fused.launches_wide == n0 + 1,
                          f"kernel B L={L}: not the wide kernel")
                    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(
                        ens, x, dtype, pool)
                    torch.cuda.synchronize()
                    res = cnn_compare(torch, fit, dx, fit0, dx0, dn)
                    check(res["ok"], f"kernel B L={L} B={name} {dn} {pool}: "
                          f"{res}")
                    del fit0, dx0
                    fit2, dx2 = cnn_fused.ensemble_apply_and_grad(prep, x,
                                                                  None, pool)
                    check(torch.equal(fit, fit2) and torch.equal(dx, dx2),
                          f"kernel B L={L} is not deterministic")
                    if name == "128-ties" and pool == "first":
                        _, dx_split = cnn_fused.ensemble_apply_and_grad(
                            prep, x, None, "split")
                        check(not torch.allclose(dx, dx_split),
                              f"L={L} tie input: split and first agree")
                    res.update({"L": L, "C": C, "B": name, "dtype": dn,
                                "pool_bwd": pool})
                    if name == "128":
                        B = x.shape[0]
                        n_bytes = (B * L * V * s + w_bytes + B * 4
                                   + B * L * V * 4)
                        bms, by = bound_ms(n_bytes, cnn_ops(
                            torch, cnn, x, M, C, C2, K), dn)
                        res.update({
                            "kernel_ms": time_ms(
                                lambda: cnn_fused.ensemble_apply_and_grad(
                                    prep, x, None, pool)),
                            "plain_ms": time_ms(
                                lambda: cnn_fused.
                                ensemble_apply_and_grad_plain(
                                    ens, x, dtype, pool)),
                            "library_ms": None, "bound_ms": bms,
                            "bound_by": by})
                    out.append(res)
                    print("kernel B wide", json.dumps(res), flush=True)
            del prep
    return out


def checked(en, res, cfg, wt_oh, steps, n_chains, chunk, dev):
    """``check_run`` on a ``SamplerResult``: the checks' numbers beside the
    run's rates."""
    return {"n_chains": n_chains, "steps": steps,
            "steps_per_sec": res.steps_per_sec,
            "chain_steps_per_sec": res.steps_per_sec * n_chains,
            "wall_steps_per_sec": res.wall_steps_per_sec,
            **check_run(en, res.energy_history, res.best_energy, res.best_x,
                        res.final_x, res.n_accepted.sum(), cfg, wt_oh, steps,
                        n_chains, chunk, dev)}


_COUNTS_BASE: dict = {}  # profiling.counters() at the last reset_counters


def reset_counters(counters):
    """Start counting the launches ``read_counters`` reads (``counters``:
    names of ``profiling``'s registry)."""
    from ppde_tpu_torch import profiling

    _COUNTS_BASE.clear()
    _COUNTS_BASE.update(profiling.counters())


def read_counters(counters):
    """Each named counter's launches since the last ``reset_counters``."""
    from ppde_tpu_torch import profiling

    now = profiling.counters()
    return {name: now[name] - _COUNTS_BASE.get(name, 0)
            for name in counters}


def esm_norms(layers, forwards, recomputed=0):
    """ESM2's layer-norm launches (each way) in ``forwards`` forwards: two
    a layer and two in the head; ``recomputed`` of them also run their
    layers' forward again (remat's recompute in the backward)."""
    return (2 * layers + 2) * forwards + 2 * layers * recomputed


def msa_norms(layers, forwards):
    """The MSA Transformer's: three a layer, the embedding's and the
    head's two, in ``forwards`` forwards."""
    return (3 * layers + 3) * forwards


def scorer_norms_only(got, name):
    """No port kernel in ``got`` but the MSA Transformer ``name``'s layer
    norms as a scorer runs them: forwards of ``msa_norms`` launches (a
    batch of masked columns each, their number the data's), no backward."""
    from ppde_tpu_torch.models import msa_transformer as msat

    n = got["layer_norm_fwd"]
    return (not any(dict(got, layer_norm_fwd=0).values()) and n > 0
            and n % msa_norms(msat.CONFIGS[name]["layers"], 1) == 0)


def with_rotary(want):
    """``want`` with the qkv / rotary kernels' launches: ESM2 launches them
    once a layer beside kernel C (forward) and C' (backward), and nothing
    else launches C or C'."""
    return dict(want, qkv_rotary_fwd=want["flash_attention_fwd"],
                qkv_rotary_bwd=want["flash_attention_bwd"])


def phase_sampler(torch, codec, utils, energy_mod, potts, cnn, ppde,
                  counters, dev, card):
    """The main path: GFP PPDE-PAS, 128 and 1024 chains, kernels only."""
    t0 = time.perf_counter()
    pp = potts.synthetic(GFP_WT, seed=0, dtype=torch.bfloat16, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    en = energy_mod.protein_poe(pp, ens, lam=15.0, wt_onehot=wt_oh,
                                compute_dtype=torch.bfloat16)
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
    print(f"sampler set-up {time.perf_counter() - t0:.2f} s", flush=True)
    runs, launches = [], {name: 0 for name in counters}
    for n_chains, steps, log_every in SAMPLER_RUNS:
        pop = wt_oh.repeat(n_chains, 1, 1)
        reset_counters(counters)
        res = ppde.run(en, pop, steps, 0, len(GFP_WT) - 1, cfg=cfg,
                       generator=torch.Generator(device=dev).manual_seed(1),
                       log_every=log_every, quiet=True, device=dev)
        got = read_counters(counters)
        for name, n in got.items():
            launches[name] += n
        a_n, b_n = got["potts_energy"], got["cnn_ensemble"]
        check(a_n >= steps and b_n >= steps,
              f"{n_chains} chains: kernel launches A={a_n} B={b_n} < "
              f"{steps} steps")
        r = checked(en, res, cfg, wt_oh, steps, n_chains, None, dev)
        r.update({"log_every": log_every, "launches_potts_energy": a_n,
                  "launches_cnn_ensemble": b_n, "card": card})
        runs.append(r)
        print("sampler", json.dumps(r), flush=True)
    return runs, launches


def exp_rate(torch):
    """exp results per second of the card's special function units: 16 per
    clock per SM at the SM clock's maximum (nvidia-smi clocks.max.sm)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 16 * mhz * 1e6


def rel_norm(x, x0):
    """|x - x0| / |x0| over the whole tensor, in float32."""
    d = (x.float() - x0.float()).norm()
    return (d / x0.float().norm().clamp_min(1e-30)).item()


def phase_attention(torch, attention_fused, dev, cases=ATTN_CASES):
    """Kernels C and C' vs plain at ESM2's head shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    exp_per_s = exp_rate(torch)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        # float32: sums in another order; bf16: one rounding of w and ds
        # (the bound of the JAX package's own attention tests)
        tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
               else dict(rtol=3e-2, atol=3e-2))
        # and over a whole output, |kernel - plain| / |plain| (norms): a few
        # last-bit flips in bf16, which a kernel that shifted weight or
        # computed in a lower precision everywhere would exceed
        rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
        for Z, T, hd in cases:
            gen = torch.Generator(device=dev).manual_seed(Z + T + hd)
            q, k, v = ((torch.randn((Z, T, hd), generator=gen, device=dev)
                        * 0.5).to(dtype) for _ in range(3))
            dout = torch.randn((Z, T, hd), generator=gen,
                               device=dev).to(dtype)
            o = attention_fused.flash_attention(q, k, v)
            grads = attention_fused.flash_attention_bwd(q, k, v, dout)
            torch.cuda.synchronize()
            o0 = attention_fused.attention_plain(q, k, v)
            grads0 = attention_fused.attention_bwd_plain(q, k, v, dout)
            err_f = (o.float() - o0.float()).abs().max().item()
            rel_f = rel_norm(o, o0)
            check(torch.allclose(o.float(), o0.float(), **tol)
                  and rel_f <= rel_tol,
                  f"kernel C Z={Z} T={T} hd={hd} {dn}: max abs err {err_f}, "
                  f"relative norm {rel_f}")
            err_b = rel_b = 0.0
            for name, g, g0 in zip(("dq", "dk", "dv"), grads, grads0):
                e = (g.float() - g0.float()).abs().max().item()
                rel = rel_norm(g, g0)
                err_b, rel_b = max(err_b, e), max(rel_b, rel)
                check(torch.allclose(g.float(), g0.float(), **tol)
                      and rel <= rel_tol,
                      f"kernel C' {name} Z={Z} T={T} hd={hd} {dn}: max abs "
                      f"err {e}, relative norm {rel}")
            check(torch.equal(o, attention_fused.flash_attention(q, k, v)),
                  "kernel C is not deterministic")
            again = attention_fused.flash_attention_bwd(q, k, v, dout)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  "kernel C' is not deterministic")
            del o0, grads0, again
            reps = 5 if Z * T * T > 5e7 else 20
            qs = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def lib_fwd_bwd():
                torch.autograd.grad(sdpa(*qs, scale=1.0), qs, dout)

            lib_f = time_ms(lambda: sdpa(q, k, v, scale=1.0), reps)
            r = {"Z": Z, "T": T, "hd": hd, "dtype": dn,
                 "tol": f"rtol {tol['rtol']}, atol {tol['atol']}; "
                        f"relative norm {rel_tol}",
                 "max_abs_err_fwd": err_f, "max_abs_err_bwd": err_b,
                 "rel_norm_err_fwd": rel_f, "rel_norm_err_bwd": rel_b,
                 "fwd_ms": time_ms(
                     lambda: attention_fused.flash_attention(q, k, v), reps),
                 "fwd_plain_ms": time_ms(
                     lambda: attention_fused.attention_plain(q, k, v), reps),
                 "fwd_library_ms_sdpa": lib_f,
                 "bwd_ms": time_ms(
                     lambda: attention_fused.flash_attention_bwd(
                         q, k, v, dout), reps),
                 "bwd_plain_ms": time_ms(
                     lambda: attention_fused.attention_bwd_plain(
                         q, k, v, dout), reps),
                 # forward plus backward of the library call less its forward
                 "bwd_library_ms_sdpa": time_ms(lib_fwd_bwd, reps) - lib_f}
            # bytes: q, k, v read and o written once (backward: q, k, v, dout
            # read, dq, dk, dv written); operations: 2 (backward 5) products
            # of 2 Z T^2 hd
            n = Z * T * hd
            r["fwd_bound_ms"], r["fwd_bound_by"] = bound_ms(
                4 * n * s, 4 * n * T, dn)
            r["bwd_bound_ms"], r["bwd_bound_by"] = bound_ms(
                7 * n * s, 10 * n * T, dn)
            # beside the bound: one exp per score, once forward and twice
            # backward (the weights are rebuilt in each of its two kernels)
            r["fwd_exp_floor_ms"] = Z * T * T / exp_per_s * 1e3
            r["bwd_exp_floor_ms"] = 2 * Z * T * T / exp_per_s * 1e3
            out.append(r)
            print("kernels C, C'", json.dumps(r), flush=True)
    return out


def phase_rotary(torch, esm2, rotary_fused, dev, cases=ROTARY_CASES):
    """The qkv / rotary kernels against the plain composition, bit for bit
    (forward and backward), timed beside it and against the bytes bound:
    each input read once and each output written once (three tensors of B
    T heads hd elements each way, and the two tables)."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        for B, T, H, hd in cases:
            gen = torch.Generator(device=dev).manual_seed(B + T + H + hd)
            q, k, v, gq, gk, gv = (
                (torch.randn((B, T, H * hd), generator=gen, device=dev)
                 * 2.0).to(dtype) for _ in range(6))
            gq, gk, gv = (g.reshape(B, H, T, hd) for g in (gq, gk, gv))
            cos, sin = esm2._rotary_tables(T, hd, dtype, q.device)
            scale = 1.0 / np.sqrt(hd)

            def fwd():
                return rotary_fused.qkv_rotary(q, k, v, cos, sin, H, scale)

            def fwd_plain():
                return rotary_fused.qkv_rotary_plain(q, k, v, cos, sin, H,
                                                     scale)

            def bwd():
                return rotary_fused.qkv_rotary_bwd(gq, gk, gv, cos, sin,
                                                   scale)

            def bwd_plain():
                return rotary_fused.qkv_rotary_bwd_plain(gq, gk, gv, cos, sin,
                                                         scale)

            for way, fn, plain in (("fwd", fwd, fwd_plain),
                                   ("bwd", bwd, bwd_plain)):
                got, want = fn(), plain()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"qkv_rotary {way} B={B} T={T} heads={H} hd={hd} {dn}: "
                      f"not the plain composition's bits")
            del got, want
            n = B * T * H * hd
            r = {"B": B, "T": T, "heads": H, "hd": hd, "dtype": dn,
                 "bit_equal": True,
                 "fwd_ms": time_ms(fwd), "fwd_plain_ms": time_ms(fwd_plain),
                 "bwd_ms": time_ms(bwd), "bwd_plain_ms": time_ms(bwd_plain)}
            # forward: the scale (q), two products and a sum (q, k) an
            # element; backward the same
            for way in ("fwd", "bwd"):
                r[f"{way}_bound_ms"], r[f"{way}_bound_by"] = bound_ms(
                    (6 * n + 2 * T * hd) * s, 7 * n, dn)
            out.append(r)
            print("qkv / rotary", json.dumps(r), flush=True)
    return out


def close_to(a, b, rtol, atol):
    """|a - b| <= rtol max(|a|, |b|) + atol everywhere (float32), and the
    largest difference."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return (bool((err <= rtol * a.abs().maximum(b.abs()) + atol).all()),
            err.max().item())


def phase_layer_norm(torch, layer_norm_fused, dev, cases=LN_CASES):
    """The layer-norm kernels against the plain composition (x cast to
    float32, F.layer_norm, the cast back) and autograd through it: y, dx,
    and g's and b's gradients; run twice (bit-equal); timed beside the
    composition (forward, and its autograd backward of x alone, as the
    sampler takes it), against the bytes bound, and beside F.layer_norm on
    x's own type with g, b in it (the library's norm, which the port never
    calls; its backward timed as forward and backward less forward)."""
    lnf = layer_norm_fused
    F = torch.nn.functional
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        # the float32 sums run in another order than F.layer_norm's (and
        # its backward's): in bf16 a unit in the last place of the one
        # rounding (2**-7 of the larger value), in float32 a few of its
        # roundings; g's and b's gradients sum over every row in float32
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        for rows, D in cases:
            gen = torch.Generator(device=dev).manual_seed(rows + D)
            x = (torch.randn((rows, D), generator=gen, device=dev) * 2.0
                 + torch.randn((rows, 1), generator=gen, device=dev)
                 ).to(dtype)
            dy = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
            g = 1.0 + 0.3 * torch.randn(D, generator=gen, device=dev)
            b = 0.2 * torch.randn(D, generator=gen, device=dev)
            y, st = lnf._fwd_cuda(x, g, b, 1e-5, True)
            dx, _, _ = lnf._bwd_cuda(x, dy, g, st, False)
            dx2, dg, db = lnf._bwd_cuda(x, dy, g, st, True)
            again = (lnf._fwd_cuda(x, g, b, 1e-5, True)[0],
                     *lnf._bwd_cuda(x, dy, g, st, True))
            torch.cuda.synchronize()
            check(all(torch.equal(p, q) for p, q in zip(
                (y, dx, dx, dg, db), (again[0], dx2, *again[1:]))),
                  f"layer norm {rows}x{D} {dn}: not bit-repeatable")
            xs = [t.clone().requires_grad_(True) for t in (x, g, b)]
            y0 = lnf.layer_norm_plain(*xs)
            dx0, dg0, db0 = torch.autograd.grad(y0, xs, dy)
            r = {"rows": rows, "D": D, "dtype": dn,
                 "tol": f"rtol {rtol} of the larger, atol 1e-5 (y) and "
                        f"1e-5 x max|ref| (dx); dg, db rtol 1e-4, atol "
                        f"1e-4 x max|ref|"}
            for name, got, ref, rt, at in (
                    ("y", y, y0, rtol, 1e-5),
                    ("dx", dx, dx0, rtol,
                     1e-5 * dx0.float().abs().max().item()),
                    ("dg", dg, dg0, 1e-4, 1e-4 * dg0.abs().max().item()),
                    ("db", db, db0, 1e-4, 1e-4 * db0.abs().max().item())):
                ok, err = close_to(got, ref, rt, at)
                r[f"max_abs_err_{name}"] = err
                r[f"rel_norm_err_{name}"] = rel_norm(got, ref)
                check(ok, f"layer norm {name} {rows}x{D} {dn}: max abs err "
                          f"{err}, relative norm {r[f'rel_norm_err_{name}']}")
            del y0, dx0, xs, again, dx2
            xr = x.clone().requires_grad_(True)
            yr = lnf.layer_norm_plain(xr, g, b)
            g16, b16 = g.to(dtype), b.to(dtype)
            xl = x.clone().requires_grad_(True)

            def lib_fwd():
                return F.layer_norm(x, (D,), g16, b16, 1e-5)

            def lib_fwd_bwd():
                torch.autograd.grad(F.layer_norm(xl, (D,), g16, b16, 1e-5),
                                    xl, dy)

            lib_f = time_ms(lib_fwd)
            r.update({
                "fwd_ms": time_ms(lambda: lnf._fwd_cuda(x, g, b, 1e-5, True)),
                "fwd_plain_ms": time_ms(
                    lambda: lnf.layer_norm_plain(x, g, b)),
                "fwd_library_ms": lib_f,
                "bwd_ms": time_ms(lambda: lnf._bwd_cuda(x, dy, g, st, False)),
                "bwd_affine_ms": time_ms(
                    lambda: lnf._bwd_cuda(x, dy, g, st, True)),
                "bwd_plain_ms": time_ms(lambda: torch.autograd.grad(
                    yr, xr, dy, retain_graph=True)),
                "bwd_library_ms": time_ms(lib_fwd_bwd) - lib_f})
            del yr, xr, xl
            # bytes: x read and y written (forward), x and dy read and dx
            # written (backward), g and b, mu and rstd (8 bytes a row);
            # operations: about 8 (forward) and 12 (backward) an element
            n = rows * D
            r["fwd_bound_ms"], r["fwd_bound_by"] = bound_ms(
                2 * n * s + 8 * rows + 8 * D, 8 * n, dn)
            r["bwd_bound_ms"], r["bwd_bound_by"] = bound_ms(
                3 * n * s + 8 * rows + 4 * D, 12 * n, dn)
            out.append(r)
            print("layer norm", json.dumps(r), flush=True)
            del x, dy, y, st, dx, dg, db
            torch.cuda.empty_cache()
    return out


def phase_row_attention(torch, row_attention_fused, counters, dev, card,
                        cases=ROW_CASES, run=ROW_ENERGY):
    """Kernels T and T' (tied row attention) against their plain versions
    (forward and backward, each run twice: bit-for-bit repeatable), held
    elementwise and by the relative norm of the difference, timed beside
    the plain versions, one scaled_dot_product_attention over the
    [N, H, C, R hd] view (the layout copies made before the clock) and the
    bound; then one potts + msa-1b energy_and_grad at the cell's size
    (ROW_ENERGY, GFP, bf16, its context rows 1.. of the tracked synthetic
    alignment, the pieces runtime.resolve_msa_grad gives): T, T', C and C'
    launched 12 x pieces each, A once, the qkv / rotary kernels never."""
    from ppde_tpu_torch import (codec, energy as energy_mod, io as pio,
                                runtime)
    from ppde_tpu_torch.models import cnn, msa_transformer as msat, potts

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for N, R, C, H, hd, dn in cases:
        dtype = getattr(torch, dn)
        s = 2 if dtype == torch.bfloat16 else 4
        scale = 1.0 / (np.sqrt(hd) * np.sqrt(R))
        gen = torch.Generator(device=dev).manual_seed(N + R + C + H + hd)
        q, k, v, dout = ((torch.randn((N, R, C, H, hd), generator=gen,
                                      device=dev) * 0.5).to(dtype)
                         for _ in range(4))
        o = row_attention_fused.tied_row_attention(q, k, v, scale)
        grads = row_attention_fused.tied_row_attention_bwd(q, k, v, dout,
                                                           scale)
        torch.cuda.synchronize()
        o0 = row_attention_fused.tied_row_attention_plain(q, k, v, scale)
        grads0 = row_attention_fused.tied_row_attention_bwd_plain(
            q, k, v, dout, scale)
        # float32: sums over R hd and the columns in another order; bf16:
        # one rounding of w and ds and the bf16 outputs, against the
        # largest output (weights ~1 / C); and over a whole output a few
        # last-bit flips, which a kernel that shifted weight or summed in a
        # lower precision everywhere would exceed
        rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
        errs = {}
        for name, g, g0 in (("o", o, o0), *zip(("dq", "dk", "dv"), grads,
                                               grads0)):
            big = max(float(g0.float().abs().max()), 1e-3)
            tol = (dict(rtol=1e-4, atol=1e-5 * max(big, 1.0))
                   if dtype == torch.float32
                   else dict(rtol=3e-2, atol=2e-2 * big))
            e = (g.float() - g0.float()).abs().max().item()
            rel = rel_norm(g, g0)
            errs[name] = (e, rel)
            kernel = "T" if name == "o" else "T'"
            check(torch.allclose(g.float(), g0.float(), **tol)
                  and rel <= rel_tol,
                  f"kernel {kernel} {name} {(N, R, C, H, hd)} {dn}: max "
                  f"abs err {e}, relative norm {rel}")
        check(torch.equal(o, row_attention_fused.tied_row_attention(
            q, k, v, scale)), "kernel T is not deterministic")
        again = row_attention_fused.tied_row_attention_bwd(q, k, v, dout,
                                                           scale)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              "kernel T' is not deterministic")
        del o0, grads0, again
        # the library: one attention over [N, H, C, R hd], the R rows of a
        # head side by side (the row sum of the scores is their product)
        qp, kp, vp, dp = (t.permute(0, 3, 2, 1, 4).reshape(N, H, C, R * hd)
                          for t in (q, k, v, dout))
        lib_o = sdpa(qp, kp, vp, scale=scale).reshape(
            N, H, C, R, hd).permute(0, 3, 2, 1, 4)
        lib_rel = rel_norm(lib_o, o)
        check(lib_rel <= 2e-2, f"sdpa over the [N, H, C, R hd] view is not "
              f"tied row attention: relative norm {lib_rel}")
        del lib_o
        leaves = [t.clone().requires_grad_(True) for t in (qp, kp, vp)]

        def lib_fwd_bwd():
            torch.autograd.grad(sdpa(*leaves, scale=scale), leaves, dp)

        lib_f = time_ms(lambda: sdpa(qp, kp, vp, scale=scale))
        r = {"N": N, "R": R, "C": C, "heads": H, "hd": hd, "dtype": dn,
             "max_abs_err_fwd": errs["o"][0],
             "rel_norm_err_fwd": errs["o"][1],
             "max_abs_err_bwd": max(errs[n][0] for n in ("dq", "dk", "dv")),
             "rel_norm_err_bwd": max(errs[n][1] for n in ("dq", "dk", "dv")),
             "rel_norm_library_vs_t": lib_rel,
             "fwd_ms": time_ms(lambda: row_attention_fused.tied_row_attention(
                 q, k, v, scale)),
             "fwd_plain_ms": time_ms(
                 lambda: row_attention_fused.tied_row_attention_plain(
                     q, k, v, scale)),
             "fwd_library_ms_sdpa": lib_f,
             "bwd_ms": time_ms(
                 lambda: row_attention_fused.tied_row_attention_bwd(
                     q, k, v, dout, scale)),
             "bwd_plain_ms": time_ms(
                 lambda: row_attention_fused.tied_row_attention_bwd_plain(
                     q, k, v, dout, scale)),
             # forward plus backward of the library call less its forward
             "bwd_library_ms_sdpa": time_ms(lib_fwd_bwd) - lib_f}
        del qp, kp, vp, dp, leaves
        # bytes: q, k, v read and o written once (backward: q, k, v, dout
        # read, dq, dk, dv written); operations: 2 (backward 5) products of
        # 2 N H C^2 R hd
        n = N * R * C * H * hd
        r["fwd_bound_ms"], r["fwd_bound_by"] = bound_ms(4 * n * s,
                                                        4 * n * C, dn)
        r["bwd_bound_ms"], r["bwd_bound_by"] = bound_ms(7 * n * s,
                                                        10 * n * C, dn)
        out.append(r)
        print("kernels T, T'", json.dumps(r), flush=True)
    del q, k, v, dout, o, grads
    torch.cuda.empty_cache()

    name, n_chains, rows = run
    msa = [s for _, s in pio.load_msa(os.path.join(ROOT, EVAL_MSA))]
    check(msa[0] == GFP_WT, "the tracked alignment's first row is not GFP")
    tr = msat.load_expert(name, GFP_WT, msa[1:rows], allow_random=True,
                          dtype=torch.bfloat16, device=dev)
    n_layers = msat.CONFIGS[name]["layers"]
    pp = potts.synthetic(GFP_WT, seed=0, dtype=torch.bfloat16, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    chunk, remat = runtime.resolve_msa_grad(
        0, n_chains, name, rows * (len(GFP_WT) + 1),
        torch.cuda.get_device_properties(dev).total_memory)
    en = energy_mod.protein_poe(pp, ens, 1.0, wt_oh, transformer=tr,
                                chunk_size=chunk,
                                compute_dtype=torch.bfloat16)
    x = random_onehot(torch, torch.Generator(device=dev).manual_seed(2),
                      n_chains, len(GFP_WT), dev)
    with torch.no_grad():
        wt_term = float(tr[1](tr[0], wt_oh)[0])
        en.energy_and_grad(en.params, x)  # a warm-up call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters(counters)
        t0 = time.perf_counter()
        e, _, g = en.energy_and_grad(en.params, x)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    got = read_counters(counters)
    pieces = -(-n_chains // chunk) if chunk else 1
    need = n_layers * pieces
    check(abs(wt_term) <= 1e-3,
          f"{name} expert term of the wild type is {wt_term}, not 0")
    check(torch.isfinite(e).all().item() and torch.isfinite(g).all().item(),
          f"{name} energy or gradient not finite")
    norms = msa_norms(n_layers, pieces)
    check(got["row_attention_fwd"] == got["row_attention_bwd"] == need
          and got["flash_attention_fwd"] == got["flash_attention_bwd"]
          == need and got["qkv_rotary_fwd"] == got["qkv_rotary_bwd"] == 0
          and got["layer_norm_fwd"] == got["layer_norm_bwd"] == norms
          and got["potts_energy"] == 1 and got["cnn_ensemble"] >= 1,
          f"{name}, {n_chains} chains in {pieces} pieces: launches {got}; "
          f"T, T', C and C' want {need} each, the layer norms {norms} "
          f"each way, A 1, the qkv / rotary kernels 0")
    energy_call = {"expert": name, "n_chains": n_chains, "rows": rows,
                   "chunk_size": chunk, "remat": remat, "pieces": pieces,
                   "call_s": call_s, "expert_term_of_wild_type": wt_term,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": got, "card": card}
    print(f"{name} energy call", json.dumps(energy_call), flush=True)
    del en, tr, e, g, x
    torch.cuda.empty_cache()
    return {"cases": out, "energy_call": energy_call}, got


def phase_transformer(torch, codec, energy_mod, potts, cnn, esm2, ppde,
                      counters, dev, card):
    """The transformer path: GFP PPDE-PAS on potts + transformer-S + CNN,
    the transformer's gradient in chunks of 16 chains and in one piece."""
    t0 = time.perf_counter()
    pp = potts.synthetic(GFP_WT, seed=0, dtype=torch.bfloat16, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    tr = esm2.load_expert("transformer-S", GFP_WT, allow_random=True,
                          dtype=torch.bfloat16, device=dev)
    n_layers = len(tr[0]["layers"])
    check(n_layers == esm2.CONFIGS["transformer-S"]["layers"] == 12,
          "transformer-S is not at full depth")
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    with torch.no_grad():
        wt_term = float(tr[1](tr[0], wt_oh)[0])
    check(abs(wt_term) <= 1e-3,
          f"transformer term of the wild type is {wt_term}, not 0")
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
    print(f"transformer set-up {time.perf_counter() - t0:.2f} s", flush=True)
    n_chains, steps, log_every = TRANSFORMER_RUN
    runs, launches = [], {name: 0 for name in counters}
    for chunk in TRANSFORMER_CHUNKS:
        en = energy_mod.protein_poe(pp, ens, lam=1.0, wt_onehot=wt_oh,
                                    transformer=tr, chunk_size=chunk,
                                    compute_dtype=torch.bfloat16)
        pop = wt_oh.repeat(n_chains, 1, 1)
        reset_counters(counters)
        res = ppde.run(en, pop, steps, 0, len(GFP_WT) - 1, cfg=cfg,
                       generator=torch.Generator(device=dev).manual_seed(1),
                       log_every=log_every, quiet=True, device=dev)
        got = read_counters(counters)
        for name, n in got.items():
            launches[name] += n
        n_chunks = -(-n_chains // chunk) if chunk else 1
        need = steps * n_layers * n_chunks
        check(got["flash_attention_fwd"] >= need
              and got["flash_attention_bwd"] >= need
              and with_rotary(got) == got,
              f"chunk {chunk}: attention launches {got} < {need}, or the "
              f"qkv / rotary kernels' not C's and C''s")
        check(got["potts_energy"] >= steps and got["cnn_ensemble"] >= steps,
              f"chunk {chunk}: kernel launches {got} < {steps} steps")
        check(all(got[f"layer_norm_{w}"] == esm_norms(
            n_layers, got[f"flash_attention_{w}"] // n_layers)
            for w in ("fwd", "bwd")),
              f"chunk {chunk}: the layer norms' launches {got}, not 2 a "
              f"layer and 2 a forward beside C (C')")
        r = checked(en, res, cfg, wt_oh, steps, n_chains, chunk, dev)
        r.update({"chunk_size": chunk, "log_every": log_every,
                  "transformer_term_of_wild_type": wt_term,
                  "launches": got, "card": card})
        runs.append(r)
        print("transformer sampler", json.dumps(r), flush=True)
    return runs, launches


def check_cli_run(torch, runtime, args, run_dir, steps, dev):
    """The checks of one CLI run's artifacts; returns its numbers."""
    files = sorted(os.listdir(run_dir))
    scored = ("transformer_scores.npy",) * (
        not args.disable_MSA_transformer_scoring)
    check(files == sorted(CLI_ARTIFACTS + scored),
          f"{args.sampler}: artifacts {files}")
    arr = {f[:-4]: np.load(os.path.join(run_dir, f)) for f in files
           if f.endswith(".npy")}
    wt = runtime.make_initial_protein_population(
        os.path.join(args.protein_weights, args.protein), 1, "cpu")[0].numpy()
    n, L = args.n_chains, wt.shape[0]
    n_hist = (steps + 1 if args.sampler != "CMAES" else
              1 + sum((s + 1) % CLI_LOG_EVERY == 0 for s in range(1, steps)))
    want = {"population": (n, L, 20), "energy_history": (n_hist, n),
            "fitness_history": (n_hist, n)}
    for name, a in arr.items():
        check(a.shape == want.get(name, (n,)),
              f"{args.sampler}: {name} has shape {a.shape}")
        check(np.isfinite(a).all(), f"{args.sampler}: non-finite {name}")
    pop = arr["population"]
    check(np.allclose(pop.sum(-1), 1.0, atol=1e-6),
          f"{args.sampler}: population rows are not one-hot")
    dist = (pop.argmax(-1) != wt.argmax(-1)).sum(-1)
    if args.sampler in ("PPDE", "PPDE-PT", "simulated_annealing"):
        check(dist.max() <= CLI_NMUT,
              f"{args.sampler}: best distance {dist.max()} > {CLI_NMUT}")
    # the saved best energies against a fresh evaluation of the saved
    # population (plain forward path), phase 4's tolerances
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the synthetic Potts
        en = runtime.build_protein_energy(args, dev)[0]
    with torch.no_grad():
        e = en.energy(en.params, torch.from_numpy(pop).to(dev))[0]
    e = e.cpu().numpy()
    err = float(np.abs(e - arr["energy_scores"]).max())
    check(np.allclose(e, arr["energy_scores"], rtol=1e-3, atol=2e-2),
          f"{args.sampler}: best energies off a fresh evaluation by {err}")
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    return {"best_energy_max_abs_err_vs_fresh": err,
            "best_energy_median": float(np.median(arr["energy_scores"])),
            "initial_energy": float(arr["energy_history"][0, 0]),
            "max_distance_best": int(dist.max()),
            "diversity_pct": summary["diversity_pct"],
            "steps_per_sec": summary["steps_per_sec"],
            "wall_steps_per_sec": summary["wall_steps_per_sec"]}


def phase_cli(torch, counters, dev, card):
    """The directed-evolution CLI end to end, every sampler, GFP width."""
    from ppde_tpu_torch import runtime
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import seeded_protein

    runs, launches = [], {name: 0 for name in counters}
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_cli.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        t0 = time.perf_counter()
        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        print(f"cli set-up {time.perf_counter() - t0:.2f} s", flush=True)
        for label, sampler, steps, extra in CLI_RUNS:
            args = de.build_parser().parse_args([
                "--protein_weights", tmp, "--protein", CLI_PROTEIN,
                "--results_path", os.path.join(tmp, "results"),
                "--sampler", sampler, "--run_signature", label,
                "--n_iters", str(steps), "--n_chains", str(CLI_CHAINS),
                "--log_every", str(CLI_LOG_EVERY),
                "--nmut_threshold", str(CLI_NMUT), "--energy_lamda", "15",
                "--disable_MSA_transformer_scoring", *extra])
            check(args.device == "cuda", "the CLI's default device is not "
                  "cuda")
            out = io.StringIO()
            reset_counters(counters)
            t = time.perf_counter()
            with contextlib.redirect_stdout(out), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                run_dir = de.main(args)
            main_s = time.perf_counter() - t
            got = read_counters(counters)
            log.write(f"==== {label}\n{out.getvalue()}")
            for name, n in got.items():
                launches[name] += n
            if sampler in ("PPDE", "PPDE-PT"):
                # once a step and once for the initial state; the CLI's
                # Potts model is float32, its CNN float32 unless bf16
                f32 = args.compute_dtype == "f32"
                want = {"potts_energy": steps + 1, "cnn_ensemble": steps + 1,
                        "potts_energy_f32": steps + 1,
                        "cnn_ensemble_f32": (steps + 1) * f32}
                check(all(got[k] == n for k, n in want.items()),
                      f"{label}: kernel launches {got}, not {want}")
            wt_line = next(line for line in out.getvalue().splitlines()
                           if line.startswith("WT protein energy"))
            r = check_cli_run(torch, runtime, args, run_dir, steps, dev)
            r.update({"run": label, "sampler": sampler, "steps": steps,
                      "n_chains": CLI_CHAINS,
                      "compute_dtype": args.compute_dtype,
                      "wt_energy_line": wt_line, "main_s": main_s,
                      "launches": got, "card": card})
            runs.append(r)
            print("cli", json.dumps(r), flush=True)
    return runs, launches


def cli_args(de, root, results, label, sampler, steps, log_every, extra,
             n_chains=None):
    """The protein CLI's arguments of phase 8 (CLI_CHAINS chains unless
    ``n_chains``)."""
    n_chains = n_chains or CLI_CHAINS
    return de.build_parser().parse_args([
        "--protein_weights", root, "--protein", CLI_PROTEIN,
        "--results_path", results, "--sampler", sampler,
        "--run_signature", label, "--n_iters", str(steps),
        "--n_chains", str(n_chains), "--log_every", str(log_every),
        "--nmut_threshold", str(CLI_NMUT), "--energy_lamda", "15",
        "--disable_MSA_transformer_scoring", *extra])


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def phase_checkpoint(torch, counters, dev, card):
    """Checkpoint/resume through the protein CLI: each of CKPT_RUNS cut at
    CKPT_CUT steps and resumed to CKPT_STEPS equals the uncut run bit for
    bit; the save time and size; one warm PPDE segment traced."""
    from ppde_tpu_torch import checkpoint, profiling, runtime
    from ppde_tpu_torch.samplers import cma_core
    from ppde_tpu_torch.samplers.protein import ppde
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import seeded_protein

    results, saves, captured = [], [], []

    def timed_save(orig):
        def save(path, *a, **kw):
            t = time.perf_counter()
            orig(path, *a, **kw)
            ms = (time.perf_counter() - t) * 1e3
            files = ([path] if path.endswith(".npz") else
                     [os.path.join(path, f) for f in ("state.npz",
                                                      "records.npz")])
            saves.append((ms, sum(os.path.getsize(f) for f in files
                                  if os.path.exists(f))))
        return save

    def capturing(orig):
        def get(args, device):
            runner = orig(args, device)

            def run(**kw):
                captured.append(runner(**kw))
                return captured[-1]
            return run
        return get

    def cli(args):
        """(SamplerResult, launches, save times and bytes) of one run."""
        reset_counters(counters)
        captured.clear()
        saves.clear()
        with contextlib.redirect_stdout(io.StringIO()), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            de.main(args)
        return captured[-1], read_counters(counters), list(saves)

    with tempfile.TemporaryDirectory() as tmp, \
            patched(de, "get_sampler_runner", capturing), \
            patched(checkpoint, "save", timed_save), \
            patched(cma_core, "save_run", timed_save):
        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        res_dir = os.path.join(tmp, "results")
        for label, sampler, extra in CKPT_RUNS:
            ck = os.path.join(tmp, "ck_" + label)

            def args(steps, *more):
                return cli_args(de, tmp, res_dir, label, sampler, steps,
                                CKPT_LOG_EVERY, (*extra, *more))
            uncut, _, _ = cli(args(CKPT_STEPS))
            first, got1, saves1 = cli(args(CKPT_CUT, "--checkpoint_dir", ck))
            resumed, got2, saves2 = cli(args(CKPT_STEPS, "--checkpoint_dir",
                                             ck))
            for key in CKPT_COMPARED:
                a, b = getattr(resumed, key), getattr(uncut, key)
                check(a.shape == b.shape and np.array_equal(a, b),
                      f"{label}: resumed {key} differs from the uncut run")
            if sampler in ("PPDE", "PPDE-PT"):
                f32 = "_f32" if "--compute_dtype" not in extra else ""
                for half, got in (("first", got1), ("resumed", got2)):
                    check(got["potts_energy_f32"] > 0
                          and got["cnn_ensemble" + f32] > 0,
                          f"{label}: kernels A and B not launched in the "
                          f"{half} half: {got}")
            r = {"run": label, "sampler": sampler, "n_chains": CLI_CHAINS,
                 "steps": [CKPT_CUT, CKPT_STEPS], "bit_exact": list(
                     CKPT_COMPARED), "launches_first": got1,
                 "launches_resumed": got2,
                 "save_ms": [round(ms, 3) for ms, _ in saves1 + saves2],
                 "save_bytes": saves1[-1][1],
                 "steps_per_sec_uncut": uncut.steps_per_sec,
                 "card": card}
            results.append(r)
            print("checkpoint", json.dumps(r), flush=True)

        # the save time beside the segment time at 1024 chains (PPDE f32)
        ck = os.path.join(tmp, "ck_big")
        big, _, big_saves = cli(cli_args(
            de, tmp, res_dir, "big", "PPDE", CKPT_STEPS, CKPT_LOG_EVERY,
            ("--checkpoint_dir", ck), n_chains=CKPT_BIG_CHAINS))
        r = {"run": "PPDE-f32-save-time", "n_chains": CKPT_BIG_CHAINS,
             "save_ms": [round(ms, 3) for ms, _ in big_saves],
             "save_bytes": big_saves[-1][1],
             "segment_ms": CKPT_LOG_EVERY / big.steps_per_sec * 1e3,
             "steps_per_sec": big.steps_per_sec,
             "wall_steps_per_sec": big.wall_steps_per_sec, "card": card}
        results.append(r)
        print("checkpoint", json.dumps(r), flush=True)

        # one warm PPDE segment (float32, the CLI's energy) in a trace
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a = cli_args(de, tmp, res_dir, "trace", "PPDE", 1, 1, ())
            en, _, pp, _ = runtime.build_protein_energy(a, dev)
        pop = runtime.make_initial_protein_population(
            os.path.join(tmp, CLI_PROTEIN), CLI_CHAINS, dev)

        def segment():
            ppde.run(en, pop, CKPT_LOG_EVERY, pp.min_pos, pp.max_pos,
                     cfg=ppde.PPDEConfig(nmut_threshold=CLI_NMUT),
                     log_every=CKPT_LOG_EVERY, quiet=True, device=dev)
        segment()
        trace_dir = os.path.join(tmp, "trace")
        with profiling.trace(trace_dir):
            segment()
        by_span = profiling.device_by_span(trace_dir)
        spans = ("kernel.a", "kernel.b")
        check(all(by_span.get(n, {}).get("kernels", 0) > 0 for n in spans),
              f"the trace of a PPDE segment has no kernel under {spans}: "
              f"{by_span}")
        r = {"run": "trace", "trace_bytes": os.path.getsize(
            os.path.join(trace_dir, "trace.json")), "by_span": by_span,
             "card": card}
        results.append(r)
        print("checkpoint", json.dumps(r), flush=True)
    return results


def traced(torch, fn):
    """(CUDA kernel launches, device busy microseconds, wall microseconds)
    of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:  # the union of the kernels' intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(spans), busy, wall_us


def phase_mnist(torch, counters, dev, card):
    """The MNIST-sum CLI at the reference defaults on seeded stand-ins and
    the tracked EBM / DAE: every sampler, gated; no port kernel runs."""
    from ppde_tpu_torch.scripts import mnist_sum, seeded_mnist

    runs = []
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_mnist.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        wdir = seeded_mnist.write_weights_dir(os.path.join(tmp, "w"))
        ddir = seeded_mnist.write_data_dir(os.path.join(tmp, "d"))

        def args(label, sampler, extra, steps, log_every, results):
            return mnist_sum.build_parser().parse_args([
                "--mnist_weights", wdir, "--data_dir", ddir,
                "--results_path", results, "--sampler", sampler,
                "--suffix", label, "--n_iters", str(steps),
                "--log_every", str(log_every), "--metrics", "csv", *extra])

        def main(a):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = mnist_sum.main(a)
            log.write(out.getvalue())
            return res

        for label, sampler, extra in MNIST_RUNS:
            results = os.path.join(tmp, "r_" + label)
            a = args(label, sampler, extra, MNIST_STEPS, MNIST_LOG_EVERY,
                     results)
            check(a.device == "cuda" and a.n_chains == MNIST_CHAINS
                  and a.energy_lamda == 10, "the MNIST CLI's defaults moved")
            log.write(f"==== {label}\n")
            reset_counters(counters)
            t = time.perf_counter()
            res = main(a)
            main_s = time.perf_counter() - t
            got = read_counters(counters)
            check(not any(got.values()),
                  f"{label}: a port kernel ran on the MNIST path: {got}")
            n = MNIST_CHAINS
            e_hist = res.energy_history
            check(np.isfinite(e_hist).all()
                  and np.isfinite(res.best_energy).all(),
                  f"{label}: non-finite energies")
            fx = res.final_x
            check(fx.shape == (n, 784) and np.isin(fx, (0.0, 1.0)).all(),
                  f"{label}: final_x of shape {fx.shape} is not binary")
            acc = None
            if res.n_accepted is not None and sampler != "simulated_annealing":
                acc = float(res.n_accepted.sum()) / (MNIST_STEPS * n)
                check(0.0 < acc < 1.0, f"{label}: acceptance rate {acc}")
            if sampler != "CMAES":  # CMA-ES has no chains to track
                check((res.best_energy >= e_hist[0]).all(),
                      f"{label}: a chain's best energy is below its start")
            # the saved bests against a fresh evaluation (plain forward)
            en = mnist_sum.build_energy(a, dev)
            pop = np.load(os.path.join(ddir, mnist_sum.WT_FILES[0][0]))
            x1 = torch.from_numpy(pop.reshape(1, 784)).to(dev).expand(n, -1)
            with torch.no_grad():
                e = en.energy(en.params, torch.from_numpy(
                    np.ascontiguousarray(res.best_x, np.float32)).to(dev),
                    x1)[0].cpu().numpy()
            err = float(np.abs(e - res.best_energy).max())
            check(np.allclose(e, res.best_energy, rtol=1e-3, atol=2e-2),
                  f"{label}: best energies off a fresh evaluation by {err}")
            csvs = sorted(f for f in os.listdir(results)
                          if f.endswith(("_pred_sums.csv",
                                         "_oracle_sums.csv")))
            check(len(csvs) == 2, f"{label}: CSV files {csvs}")
            rows = []
            for name in csvs:
                with open(os.path.join(results, name)) as f:
                    rows.append(f.read().splitlines())
            # one row per oracle record: steps 0, 50, ..., 200 for the
            # MCMC samplers; CMA-ES records its oracle at log steps only
            n_rec = len(res.oracle_history)
            check(sampler == "CMAES"
                  or n_rec == MNIST_STEPS // MNIST_LOG_EVERY + 1,
                  f"{label}: {n_rec} oracle records")
            want_steps = [str(min(i * MNIST_LOG_EVERY, MNIST_STEPS))
                          for i in range(n_rec)]
            for lines in rows:
                check(lines[0] == ",0.5,0.6,0.7,0.8,0.9"
                      and [ln.split(",")[0] for ln in lines[1:]]
                      == want_steps,
                      f"{label}: CSV rows {lines[:1]} {len(lines) - 1}")
            # launches per step: the difference of two traced short runs
            tr = [traced(torch, lambda k=k: main(args(
                label, sampler, extra, k, k, os.path.join(tmp, "t"))))
                for k in MNIST_TRACE_STEPS]
            dk = MNIST_TRACE_STEPS[1] - MNIST_TRACE_STEPS[0]
            r = {"run": label, "sampler": sampler, "n_chains": n,
                 "steps": MNIST_STEPS, "steps_per_sec": res.steps_per_sec,
                 "wall_steps_per_sec": res.wall_steps_per_sec,
                 "main_s": main_s, "acceptance_rate": acc,
                 "best_energy_max_abs_err_vs_fresh": err,
                 "initial_energy": float(e_hist[0, 0]),
                 "best_energy_median": float(np.median(res.best_energy)),
                 "oracle_median_last": float(np.median(
                     res.oracle_history[-1])),
                 "launches_per_step": (tr[1][0] - tr[0][0]) / dk,
                 "device_busy_share": ((tr[1][1] - tr[0][1])
                                       / max(tr[1][2] - tr[0][2], 1e-9)),
                 "port_kernel_launches": got, "card": card}
            runs.append(r)
            print("mnist", json.dumps(r), flush=True)
    return runs


def msat_flops(name, R, C):
    """Operations of one MSA-Transformer forward over an R x C alignment:
    the projections and FFN (8 D^2 + 2 D F multiply-adds a token a layer),
    the tied row attention (2 R C^2 D) and the column attention (2 C R^2 D);
    the LM head at one position is left out."""
    from ppde_tpu_torch.models import msa_transformer as msat

    cfg = msat.CONFIGS[name]
    D, Fd = cfg["dim"], cfg["ffn"]
    macs = (R * C * (8 * D * D + 2 * D * Fd) + 2 * R * C * C * D
            + 2 * C * R * R * D)
    return 2 * macs * cfg["layers"]


@contextlib.contextmanager
def timed_marginals(torch, msat, out):
    """``msat.masked_marginals`` timed (it ends in a copy to the host, so
    its wall time is the device's) and its columns and alignment size
    recorded into ``out``."""
    def wrap(orig):
        def run(params, wt_window, msa_rows, cols, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = orig(params, wt_window, msa_rows, cols, *a, **kw)
            out.update(seconds=time.perf_counter() - t, columns=len(cols),
                       rows=1 + len(msa_rows), tokens=len(wt_window) + 1)
            return res
        return run
    with patched(msat, "masked_marginals", wrap):
        yield


def phase_eval(torch, counters, dev, card):
    """Protein evaluation on the card: the protein CLI with MSA-Transformer
    scoring on (no weights: the [skip] line; an msa-S file: scores),
    eval_proteins at full width (msa-1b, 500 rows, 128 chains),
    eval_expert_correlation (kernel C on its transformer column),
    select_lambda, calibrate_oracle_scale --out_npz and make_figures."""
    from ppde_tpu_torch import io as pio
    from ppde_tpu_torch.models import esm2, msa_transformer as msat
    from ppde_tpu_torch.scripts import (calibrate_oracle_scale,
                                        eval_expert_correlation,
                                        eval_proteins, make_figures,
                                        seeded_protein, select_lambda)
    from ppde_tpu_torch.scripts import directed_evolution as de

    results, launches = {}, {name: 0 for name in counters}
    msa_path = os.path.join(ROOT, EVAL_MSA)
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_eval.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        def run(label, fn, a):
            out = io.StringIO()
            reset_counters(counters)
            t = time.perf_counter()
            with contextlib.redirect_stdout(out), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                res = fn(a)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            got = read_counters(counters)
            for name, n in got.items():
                launches[name] += n
            log.write(f"==== {label}\n{out.getvalue()}")
            return res, out.getvalue(), got, secs

        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        rng = np.random.default_rng(5)
        seeded_protein.write_protein_dir(
            tmp, UBE4B, "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                           104)), seed=2)
        protein_dir = os.path.join(tmp, CLI_PROTEIN)

        # 1. the protein CLI with scoring on: no weights, then an msa-S file
        # written here in training.save_ckpt's layout (leaves p0..pN, keys
        # sorted, float32)
        ck = os.path.join(tmp, "msat_S.npz")
        init = msat.init(torch.Generator().manual_seed(3), torch.float32,
                         name=EVAL_SMALL_MSAT)
        np.savez_compressed(ck, step=0, treedef="msa-S", **{
            f"p{i}": a.numpy() for i, a in enumerate(esm2._flatten(init))})
        cli = {}
        for label, extra in (("no-weights", ()),
                             ("msa-S", ("--msa_transformer_weights", ck,
                                        "--msa_transformer_model",
                                        EVAL_SMALL_MSAT))):
            a = de.build_parser().parse_args([
                "--protein_weights", tmp, "--protein", CLI_PROTEIN,
                "--results_path", os.path.join(tmp, "results"),
                "--run_signature", label, "--n_iters", str(EVAL_STEPS),
                "--n_chains", str(CLI_CHAINS), "--log_every",
                str(CLI_LOG_EVERY), "--nmut_threshold", str(CLI_NMUT),
                "--energy_lamda", "15", "--msa_path", msa_path,
                "--msa_size", str(EVAL_MSA_SIZE), *extra])
            with timed_marginals(torch, msat, tm := {}):
                run_dir, out, got, secs = run(f"cli {label}", de.main, a)
            files = sorted(os.listdir(run_dir))
            with open(os.path.join(run_dir, "summary.json")) as f:
                summary = json.load(f)
            want = with_rotary({"potts_energy_f32": EVAL_STEPS + 1,
                                "cnn_ensemble_f32": EVAL_STEPS + 1,
                                "flash_attention_fwd": 0,
                                "flash_attention_bwd": 0})
            check(all(got[k] == n for k, n in want.items()),
                  f"cli {label}: kernel launches {got}, not {want}")
            if label == "no-weights":
                check("[skip] MSA-Transformer scoring unavailable: No "
                      "MSA-Transformer weights" in out
                      and files == sorted(CLI_ARTIFACTS)
                      and "evolutionary_density" not in summary,
                      f"cli {label}: no [skip] line, or scores: {files}")
                scored_run = run_dir
            else:
                scores = np.load(os.path.join(run_dir,
                                              "transformer_scores.npy"))
                check(files == sorted(CLI_ARTIFACTS
                                      + ("transformer_scores.npy",))
                      and scores.shape == (CLI_CHAINS,)
                      and np.isfinite(scores).all()
                      and "MSATransformer quantiles" in out
                      and "evolutionary_density" in summary,
                      f"cli {label}: scores {scores.shape} {files}")
            cli[label] = {"main_s": secs, "launches": got,
                          "masked_marginals": tm,
                          "evolutionary_density":
                              summary.get("evolutionary_density"),
                          "steps_per_sec": summary["steps_per_sec"]}
        results["cli"] = cli
        print("eval cli", json.dumps(cli), flush=True)

        # 2. eval_proteins at full width on the unscored run
        a = eval_proteins.build_parser().parse_args([
            "--runs_glob", str(scored_run), "--protein_weights", tmp,
            "--protein", CLI_PROTEIN, "--allow_random_esm",
            "--msa_transformer_model", EVAL_MSAT, "--msa_path", msa_path,
            "--msa_size", str(EVAL_MSA_SIZE), "--update_summary"])
        torch.cuda.reset_peak_memory_stats()
        with timed_marginals(torch, msat, tm := {}):
            _, out, got, secs = run("eval_proteins", eval_proteins.main, a)
        peak = torch.cuda.max_memory_allocated()
        scores = np.load(os.path.join(scored_run, "transformer_scores.npy"))
        with open(os.path.join(scored_run, "summary.json")) as f:
            summary = json.load(f)
        check(scores.shape == (CLI_CHAINS,) and np.isfinite(scores).all()
              and "evolutionary_density" in summary
              and summary["density_msa_size"] == EVAL_MSA_SIZE,
              f"eval_proteins: scores {scores.shape}, summary "
              f"{sorted(summary)}")
        check(scorer_norms_only(got, EVAL_MSAT),
              f"eval_proteins: a port kernel ran: {got}")
        check(tm["rows"] == EVAL_MSA_SIZE and tm["tokens"] == len(GFP_WT) + 1,
              f"eval_proteins: alignment {tm}")
        ms_col = tm["seconds"] * 1e3 / tm["columns"]
        flops = msat_flops(EVAL_MSAT, tm["rows"], tm["tokens"])
        r = {"scorer": EVAL_MSAT, "n_chains": CLI_CHAINS,
             "alignment": [tm["rows"], tm["tokens"]],
             "columns": tm["columns"], "marginals_s": tm["seconds"],
             "main_s": secs, "ms_per_column": ms_col,
             "tflop_per_column": flops / 1e12,
             "bf16_peak_share": flops / (ms_col * 1e-3) / PEAK_OPS["bfloat16"],
             "peak_memory_gb": peak / 1e9,
             "evolutionary_density": summary["evolutionary_density"],
             "card": card}

        # one masked column of the population in bf16 against float32
        wt_idx = np.array(["ACDEFGHIKLMNPQRSTVWY".index(c) for c in GFP_WT])
        pop = np.load(os.path.join(scored_run, "population.npy"))
        col = int(np.flatnonzero((pop.argmax(-1) != wt_idx).any(0))[0])
        msa = pio.load_msa(msa_path)
        idxs = np.random.default_rng(0).choice(
            len(msa), size=min(EVAL_MSA_SIZE - 1, len(msa)), replace=False)
        rows = [msa[i][1] for i in idxs]
        lp = {}
        for dt in (torch.bfloat16, torch.float32):
            params = msat.load(None, allow_random=True, dtype=dt,
                               name=EVAL_MSAT, device=dev)
            lp[dt] = msat.masked_marginals(params, GFP_WT, rows, [col],
                                           heads=msat.heads_of(EVAL_MSAT))
            del params
        err = float(np.abs(lp[torch.bfloat16] - lp[torch.float32]).max())
        sums = [float(np.exp(v).sum()) for v in lp.values()]
        check(err <= EVAL_LOGP_TOL and all(abs(x - 1) <= 1e-3 for x in sums),
              f"msa-1b column {col}: bf16 against float32 {err} (limit "
              f"{EVAL_LOGP_TOL}), row sums {sums}")
        r.update({"column_checked": col, "bf16_vs_f32_max_abs_err": err,
                  "bf16_vs_f32_limit": EVAL_LOGP_TOL, "row_sums": sums})
        results["eval_proteins"] = r
        print("eval eval_proteins", json.dumps(r), flush=True)

        # 3. eval_expert_correlation: kernel C on the transformer column
        a = eval_expert_correlation.build_parser().parse_args([
            "--protein_weights", tmp, "--protein", CLI_PROTEIN,
            "--n_mutants", str(EVAL_MUTANTS), "--max_mutations",
            str(EVAL_MAX_MUT), "--esm_model", "transformer-S",
            "--esm_chunk", str(EVAL_ESM_CHUNK), "--msat_model", EVAL_MSAT,
            "--msa_path", msa_path, "--msa_size", str(EVAL_MSA_SIZE)])
        torch.cuda.reset_peak_memory_stats()
        with timed_marginals(torch, msat, tm := {}):
            res, out, got, secs = run("eval_expert_correlation",
                                      eval_expert_correlation.main, a)
        n_layers = esm2.CONFIGS["transformer-S"]["layers"]
        want_c = n_layers * (1 + -(-EVAL_MUTANTS // EVAL_ESM_CHUNK))
        want = with_rotary({"flash_attention_fwd": want_c,
                            "flash_attention_bwd": 0,
                            "potts_energy": 0, "cnn_ensemble": 0})
        check(all(got[k] == n for k, n in want.items()),
              f"eval_expert_correlation: kernel launches {got}, not {want}")
        rho = res["spearman_vs_oracle"]
        check(set(rho) >= {"potts", "cnn_ensemble", "transformer_random",
                           "msat_random"}
              and all(np.isfinite(v) and -1 <= v <= 1 for v in rho.values()),
              f"eval_expert_correlation: rho {rho}")
        ms_col = tm["seconds"] * 1e3 / tm["columns"]
        r = {"n_mutants": EVAL_MUTANTS, "max_mutations": EVAL_MAX_MUT,
             "spearman_vs_oracle": rho, "launches": got, "main_s": secs,
             "columns": tm["columns"], "marginals_s": tm["seconds"],
             "ms_per_column": ms_col,
             "bf16_peak_share": (msat_flops(EVAL_MSAT, tm["rows"],
                                            tm["tokens"])
                                 / (ms_col * 1e-3) / PEAK_OPS["bfloat16"]),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card}
        results["eval_expert_correlation"] = r
        print("eval eval_expert_correlation", json.dumps(r), flush=True)

        # 4. select_lambda, calibrate_oracle_scale (its round-trip
        # assertions), make_figures
        lam, _, got, _ = run("select_lambda", select_lambda.main,
                             select_lambda.build_parser().parse_args([
                                 "--protein_weights", tmp, "--protein",
                                 CLI_PROTEIN]))
        check(np.isfinite(lam) and lam > 0, f"select_lambda: {lam}")
        out_npz = os.path.join(tmp, "scalematched.npz")
        rec, _, got2, _ = run(
            "calibrate_oracle_scale", calibrate_oracle_scale.main,
            calibrate_oracle_scale.build_parser().parse_args([
                "--protein_weights", tmp, "--protein", UBE4B,
                "--potts_npz", os.path.join(ROOT, "weights", UBE4B,
                                            "potts.npz"),
                "--out_npz", out_npz]))
        check(rec.get("out_npz") == out_npz and os.path.exists(out_npz),
              "calibrate_oracle_scale wrote no artifact")
        rows_fig, _, got3, _ = run(
            "make_figures", make_figures.main,
            make_figures.build_parser().parse_args([
                "--runs_glob", os.path.join(tmp, "results", CLI_PROTEIN,
                                            "*"),
                "--protein_weights", tmp, "--protein", CLI_PROTEIN,
                "--out_json", os.path.join(tmp, "figures.json")]))
        check(len(rows_fig) == 2 and all(
            "evolutionary_density_p50" in row for row in rows_fig),
            f"make_figures: {rows_fig}")
        check(not any({**got, **got2, **got3}.values()),
              "a port kernel ran in select_lambda, calibrate_oracle_scale "
              "or make_figures")
        results["calibration"] = {"lambda": lam, "record": rec, "card": card}
        print("eval calibration", json.dumps(results["calibration"]),
              flush=True)
    return results, launches


def esm_train_flops(name, batch, T):
    """Model FLOPs of one ESM2 training step: 6 N tokens (N: the weight
    matrices' parameters, the embedding and its tied head included) plus
    attention's two products of 2 B T^2 D a layer, three times over
    (forward and backward). A remat's second forward is not counted."""
    from ppde_tpu_torch.models import esm2

    cfg = esm2.CONFIGS[name]
    D, Fd, L = cfg["dim"], cfg["ffn"], cfg["layers"]
    n = L * (4 * D * D + 2 * D * Fd) + D * D + 2 * esm2.ESM_VOCAB * D
    return 6 * n * batch * T + 12 * L * batch * T * T * D


def logged(pattern, out):
    """The floats of every printed line that matches ``pattern`` (one
    group: the number)."""
    return [float(v) for v in re.findall(pattern, out)]


def run_main(torch, counters, log, launches, by_run, label, module, argv,
             trainer=None, log_every=None):
    """module.main on argv (parsed by its build_parser) under the launch
    counters, set to 0 just before and read just after, added into
    ``launches`` and kept in ``by_run[label]``; its printed output goes to
    ``log``. With ``trainer`` (a name in ``training`` or
    ``potts_fit``) that call is timed alone, with its peak memory, and its
    steps after the first (each ends in an optimizer step) apart. Returns
    (main's result, its output, launches, seconds, the trainer's times and
    ``main_peak_memory_gb``)."""
    from ppde_tpu_torch import training
    from ppde_tpu_torch.models import potts_fit

    a = module.build_parser().parse_args(argv)
    check(a.device == "cuda", f"{label}: --device is {a.device}")
    tm, marks = {}, []

    def wrap(fn):
        def timed(*args, **kw):
            if log_every:
                kw["log_every"] = log_every
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            end = time.perf_counter()
            n = marks[-1][0]
            tm.update(seconds=end - t, steps=n,
                      first_step_s=marks[0][1] - t,
                      later_steps_per_sec=(n - 1) / (
                          marks[-1][1] - marks[0][1]),
                      peak_memory_gb=torch.cuda.max_memory_allocated()
                      / 1e9)
            return res
        return timed

    def mark(step):
        # the first step ends in a sync; the later ones are timed when the
        # host has queued them (the steps are host-paced)
        def marked(self, grads):
            step(self, grads)
            if self.count == 1:
                torch.cuda.synchronize()
            marks.append((self.count, time.perf_counter()))
        return marked

    host = potts_fit if trainer == "fit" else training
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if trainer:
            stack.enter_context(patched(host, trainer, wrap))
            stack.enter_context(patched(training.Adam, "step", mark))
        stack.enter_context(contextlib.redirect_stdout(out))
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", UserWarning)
        res = module.main(a)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    got = read_counters(counters)
    for name, n in got.items():
        launches[name] += n
    by_run[label] = got
    tm["main_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log.write(f"==== {label}\n{out.getvalue()}")
    return res, out.getvalue(), got, secs, tm


def esm_record(label, name, tm, out, steps, batch, card):
    """A finetune_esm run's numbers from ``run_main``'s times and output:
    every logged loss finite, steps/s after the first step, tokens/s, the
    share of the bf16 peak by ``esm_train_flops``, peak memory."""
    T = len(GFP_WT)
    ce = logged(r"\[esm_mlm\] iter \d+ ce (\S+)", out)
    check(ce and all(np.isfinite(ce)), f"{label}: logged losses {ce}")
    flops = esm_train_flops(name, batch, T)
    sps = tm["later_steps_per_sec"]
    check(tm["steps"] == steps, f"{label}: {tm['steps']} steps")
    return {"model": name, "steps": steps, "batch": batch, "T": T,
            "train_s": tm["seconds"], "first_step_s": tm["first_step_s"],
            "steps_per_sec_whole_call": steps / tm["seconds"],
            "steps_per_sec": sps, "tokens_per_sec": sps * batch * T,
            "tflop_per_step": flops / 1e12,
            "bf16_peak_share": flops * sps / PEAK_OPS["bfloat16"],
            "peak_memory_gb": tm["peak_memory_gb"],
            "loss_first_logged": ce[0], "loss_last_logged": ce[-1],
            "card": card}


def phase_training(torch, counters, dev, card):
    """Training and fitting through their entry points at full width on
    the tracked GFP alignment: finetune_esm at transformer-S (kernels C
    and C' on every step, launches held to their formula; held-out CE
    must fall; the checkpoint scores in the protein CLI), at transformer-L
    with LoRA (C' at hd = 64 under remat), fit_potts and
    sample_potts_msa, finetune_msa at msa-S, the three MNIST trainers on
    the synthetic source, eval_mnist_ebm and mnist_sum on what they
    wrote."""
    from ppde_tpu_torch.models import esm2, mnist_nets
    from ppde_tpu_torch.models import msa_transformer as msat
    from ppde_tpu_torch import convert
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import (eval_mnist_ebm, finetune_esm,
                                        finetune_msa, fit_potts, mnist_sum,
                                        sample_potts_msa, seeded_mnist,
                                        seeded_protein,
                                        train_binary_mnist_dae,
                                        train_binary_mnist_ebm,
                                        train_binary_mnist_regression)

    results, launches = {}, {name: 0 for name in counters}
    by_run = {}
    msa_path = os.path.join(ROOT, EVAL_MSA)
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_training.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        run = functools.partial(run_main, torch, counters, log, launches,
                                by_run)
        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        wt_fasta = os.path.join(tmp, CLI_PROTEIN, "wt.fasta")
        n_rows = len(open(msa_path).read().split(">")) - 1
        n_val = max(1, int(round(TRAIN_VAL_FRAC * n_rows)))
        T = len(GFP_WT)

        # 1. finetune_esm at transformer-S, full width and depth
        out_s = os.path.join(tmp, "esm_S")
        _, out, got, secs, tm = run(
            "finetune_esm transformer-S", finetune_esm,
            ["--msa", msa_path, "--wt_fasta", wt_fasta, "--esm_model",
             "transformer-S", "--out", out_s, "--n_iters",
             str(TRAIN_S_STEPS), "--val_frac", str(TRAIN_VAL_FRAC),
             "--log_every", str(TRAIN_LOG_EVERY)], "train_esm_mlm")
        n_layers = esm2.CONFIGS["transformer-S"]["layers"]
        # every step one forward and one backward a layer; the held-out CE
        # before and after: 4 repeats of one forward a layer each
        want = with_rotary({
            "flash_attention_fwd": n_layers * (TRAIN_S_STEPS + 2 * 4),
            "flash_attention_bwd": n_layers * TRAIN_S_STEPS,
            "potts_energy": 0, "cnn_ensemble": 0})
        check(all(got[k] == n for k, n in want.items()),
              f"finetune_esm S: kernel launches {got}, not {want}")
        before, after = logged(r"held-out masked CE \w+: (\S+)", out)
        check(np.isfinite([before, after]).all() and after < before,
              f"finetune_esm S: held-out CE {before} -> {after}")
        r = esm_record("finetune_esm S", "transformer-S", tm, out,
                       TRAIN_S_STEPS, 32, card)
        final_s = f"{out_s}_ckpt_{TRAIN_S_STEPS}.npz"
        loaded = esm2.load_npz_checkpoint(final_s, "transformer-S",
                                          torch.bfloat16, dev)
        check(len(loaded["layers"]) == n_layers, "transformer-S reload")
        del loaded
        r.update({"main_s": secs, "n_val": n_val, "heldout_ce_before":
                  before, "heldout_ce_after": after, "launches": got,
                  "launches_want": want})
        # the fine-tuned expert in the protein CLI
        res_dir = os.path.join(tmp, "results")
        run_dir, out, got, secs, _ = run(
            "directed_evolution --esm_weights", de,
            ["--protein_weights", tmp, "--protein", CLI_PROTEIN,
             "--results_path", res_dir, "--run_signature", "esm_ft",
             "--unsupervised_expert", "transformer-S", "--esm_weights",
             final_s, "--n_iters", str(TRAIN_CLI_STEPS), "--n_chains", "32",
             "--log_every", "5", "--nmut_threshold", str(CLI_NMUT),
             "--energy_lamda", "1", "--disable_MSA_transformer_scoring"])
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        e = np.load(os.path.join(run_dir, "energy_history.npy"))
        check(np.isfinite(e).all() and got["flash_attention_fwd"]
              >= n_layers * TRAIN_CLI_STEPS
              and got["flash_attention_bwd"] >= n_layers * TRAIN_CLI_STEPS
              and with_rotary(got) == got,
              f"the CLI on the fine-tuned expert: launches {got}")
        r["cli_with_esm_weights"] = {"steps": TRAIN_CLI_STEPS, "n_chains": 32,
                                     "steps_per_sec": summary["steps_per_sec"],
                                     "launches": got}
        results["finetune_esm_S"] = r
        print("training finetune_esm_S", json.dumps(r), flush=True)

        # 2. transformer-L (depth cut) with LoRA: remat, hd = 64
        full_l = esm2.CONFIGS["transformer-L"]
        esm2.CONFIGS["transformer-L"] = dict(full_l, layers=TRAIN_L_LAYERS)
        try:
            out_l = os.path.join(tmp, "esm_L")
            _, out, got, secs, tm = run(
                "finetune_esm transformer-L LoRA", finetune_esm,
                ["--msa", msa_path, "--wt_fasta", wt_fasta, "--esm_model",
                 "transformer-L", "--out", out_l, "--n_iters",
                 str(TRAIN_L_STEPS), "--lora_rank", str(TRAIN_LORA_RANK),
                 "--ckpt_every", str(TRAIN_L_STEPS // 2), "--log_every",
                 str(TRAIN_L_STEPS // 2)], "train_esm_mlm")
            # remat: a forward, then the forward again and the backward
            want = with_rotary({
                "flash_attention_fwd": 2 * TRAIN_L_LAYERS * TRAIN_L_STEPS,
                "flash_attention_bwd": TRAIN_L_LAYERS * TRAIN_L_STEPS})
            check(all(got[k] == n for k, n in want.items()),
                  f"finetune_esm L: kernel launches {got}, not {want}")
            files = sorted(os.path.basename(f) for f in os.listdir(tmp)
                           if f.startswith("esm_L"))
            want_files = sorted([f"esm_L_lora_{TRAIN_L_STEPS // 2}.npz",
                                 f"esm_L_lora_{TRAIN_L_STEPS}.npz",
                                 f"esm_L_ckpt_{TRAIN_L_STEPS}.npz"])
            check(files == want_files, f"finetune_esm L wrote {files}")
            merged = esm2.load_npz_checkpoint(
                f"{out_l}_ckpt_{TRAIN_L_STEPS}.npz", "transformer-L",
                torch.bfloat16, dev)
            check(len(merged["layers"]) == TRAIN_L_LAYERS,
                  "transformer-L merged reload")
            del merged
            r = esm_record("finetune_esm L", "transformer-L", tm, out,
                           TRAIN_L_STEPS, 32, card)
        finally:
            esm2.CONFIGS["transformer-L"] = full_l
        r.update({"layers": TRAIN_L_LAYERS, "lora_rank": TRAIN_LORA_RANK,
                  "main_s": secs, "files": files, "launches": got})
        results["finetune_esm_L_lora"] = r
        print("training finetune_esm_L_lora", json.dumps(r), flush=True)

        # 3. fit_potts at its defaults, then sample_potts_msa from the fit
        fit_npz = os.path.join(tmp, "gfp_potts.npz")
        hist, out, got, secs, tm = run(
            "fit_potts", fit_potts, ["--msa", msa_path, "--out", fit_npz],
            "fit")
        check(len(hist) == 500 and np.isfinite(hist).all()
              and hist[-1] < hist[0], f"fit_potts: loss {hist[0]} -> "
              f"{hist[-1]} over {len(hist)} steps")
        P = T * 20
        ops = 4 * n_rows * P * P  # X @ W and its weight gradient a step
        sps = tm["later_steps_per_sec"]
        results["fit_potts"] = {
            "steps": len(hist), "rows": n_rows, "P": P,
            "fit_s": tm["seconds"], "first_step_s": tm["first_step_s"],
            "steps_per_sec": sps, "tflop_per_step": ops / 1e12,
            "f32_peak_share": ops * sps / PEAK_OPS["float32"],
            "peak_memory_gb": tm["peak_memory_gb"],
            "loss_first": hist[0], "loss_last": hist[-1], "main_s": secs,
            "launches": got, "card": card}
        print("training fit_potts", json.dumps(results["fit_potts"]),
              flush=True)
        (seqs, rec), out, got, secs, _ = run(
            "sample_potts_msa", sample_potts_msa,
            ["--protein_weights", tmp, "--protein", CLI_PROTEIN,
             "--potts_npz", fit_npz, "--n_seqs", str(POTTS_SEQS),
             "--n_sweeps", str(POTTS_SWEEPS), "--qc_msa", msa_path,
             "--out_json", os.path.join(tmp, "qc.json")])
        r1, r2 = rec["single_site_freq_r"], rec["pair_covariance_r"]
        check(len(seqs) == POTTS_SEQS and r1 is not None and r2 is not None
              and np.isfinite([r1, r2]).all(),
              f"sample_potts_msa: QC r {r1}, {r2}")
        results["sample_potts_msa"] = {
            "n_seqs": POTTS_SEQS, "n_sweeps": POTTS_SWEEPS, "main_s": secs,
            "sweeps_per_sec": POTTS_SWEEPS / secs, "qc": rec,
            "launches": got, "card": card}
        print("training sample_potts_msa",
              json.dumps(results["sample_potts_msa"]), flush=True)

        # 4. finetune_msa at msa-S
        out_m = os.path.join(tmp, "msa_S")
        _, out, got, secs, tm = run(
            "finetune_msa msa-S", finetune_msa,
            ["--msa", msa_path, "--msa_model", "msa-S", "--out", out_m,
             "--n_iters", str(TRAIN_MSA_STEPS), "--val_frac",
             str(TRAIN_VAL_FRAC), "--log_every", str(TRAIN_LOG_EVERY)],
            "train_msa_mlm")
        ce = logged(r"\[msa_mlm\] iter \d+ ce (\S+)", out)
        before, after = logged(r"held-out masked CE \w+: (\S+)", out)
        check(ce and np.isfinite(ce + [before, after]).all(),
              f"finetune_msa: losses {ce}, held-out {before} -> {after}")
        # msa-S's norms alone: a forward and a backward a step, the
        # held-out CE's 4 forwards before and after
        want = dict(dict.fromkeys(COUNTERS, 0), layer_norm_fwd=msa_norms(
            msat.CONFIGS["msa-S"]["layers"], TRAIN_MSA_STEPS + 2 * 4),
            layer_norm_bwd=msa_norms(msat.CONFIGS["msa-S"]["layers"],
                                     TRAIN_MSA_STEPS))
        check(got == want, f"finetune_msa: kernel launches {got}, not "
              f"{want}")
        m = msat.load(f"{out_m}_ckpt_{TRAIN_MSA_STEPS}.npz",
                      dtype=torch.bfloat16, name="msa-S", device=dev)
        check(len(m["layers"]) == msat.CONFIGS["msa-S"]["layers"],
              "msa-S reload")
        sps = tm["later_steps_per_sec"]
        results["finetune_msa_S"] = {
            "steps": TRAIN_MSA_STEPS, "block": [16, T + 1],
            "train_s": tm["seconds"], "first_step_s": tm["first_step_s"],
            "steps_per_sec": sps,
            "tokens_per_sec": sps * 16 * (T + 1),
            "peak_memory_gb": tm["peak_memory_gb"],
            "loss_first_logged": ce[0], "loss_last_logged": ce[-1],
            "heldout_ce_before": before, "heldout_ce_after": after,
            "main_s": secs, "card": card}
        print("training finetune_msa_S",
              json.dumps(results["finetune_msa_S"]), flush=True)

        # 5. the MNIST trainers on the synthetic source, into a weights
        # directory of seeded stand-ins without the tracked npz files
        wdir = seeded_mnist.write_weights_dir(os.path.join(tmp, "mw"))
        for f in seeded_mnist.NPZ_FILES:
            os.remove(os.path.join(wdir, f))
        ddir = seeded_mnist.write_data_dir(os.path.join(tmp, "md"))
        mnist = {}
        trained = {}
        for label, module, trainer, pattern, extra in (
                ("regression", train_binary_mnist_regression,
                 "train_regression", r"\[regression\] iter \d+ mse (\S+)",
                 ["--output_dir", os.path.join(tmp, "mreg")]),
                ("dae", train_binary_mnist_dae, "train_dae",
                 r"\[dae\] iter \d+ bce (\S+)", ["--output_dir", wdir]),
                ("ebm", train_binary_mnist_ebm, "train_ebm",
                 r"\[ebm\] iter \d+ obj (\S+)", ["--output_dir", wdir])):
            steps = MNIST_TRAIN_STEPS[label]
            res, out, got, secs, tm = run(
                f"train_binary_mnist_{label}", module,
                ["--mnist_source", "synthetic", "--n_iters", str(steps),
                 "--ckpt_every", str(steps), *extra], trainer,
                log_every=steps // 4)
            losses = logged(pattern, out)
            check(len(losses) == 4 and np.isfinite(losses).all(),
                  f"{label}: logged losses {losses}")
            check(not any(got.values()), f"{label}: a port kernel ran")
            trained[label] = res[0] if label == "regression" else res
            mnist[label] = {"steps": steps, "train_s": tm["seconds"],
                            "first_step_s": tm["first_step_s"],
                            "steps_per_sec": tm["later_steps_per_sec"],
                            "peak_memory_gb": tm["peak_memory_gb"],
                            "loss_first_logged": losses[0],
                            "loss_last_logged": losses[-1], "card": card}
            if label == "regression":
                mnist[label]["val_rounding_accuracy"] = float(res[1])
        # the port-written checkpoints read back equal, and load in
        # mnist_sum and eval_mnist_ebm
        for label, init, glob_ in (
                ("dae", mnist_nets.dae_init(torch.Generator(), 16, 64),
                 "mnist_binary_dae"),
                ("ebm", mnist_nets.ebm_init(torch.Generator(), 64,
                                            mean=np.full(784, 0.5)),
                 "mnist_ebm")):
            path = os.path.join(
                wdir, f"{glob_}_ckpt_{MNIST_TRAIN_STEPS[label]}.npz")
            tree, _ = mnist_nets.load_npz(path, init)
            back = convert.mnist_from_numpy(tree, dev)
            check(all(torch.equal(a, b) for a, b in zip(
                esm2._flatten(back), esm2._flatten(trained[label]))),
                f"{label}: the checkpoint does not read back equal")
            ms, out, got, secs, _ = run(
                f"mnist_sum {label}", mnist_sum,
                ["--mnist_weights", wdir, "--data_dir", ddir,
                 "--results_path", os.path.join(tmp, "mr_" + label),
                 "--unsupervised_expert", label, "--n_iters", "20",
                 "--n_chains", "32", "--log_every", "10", "--metrics",
                 "csv"])
            check(np.isfinite(ms.energy_history).all(),
                  f"mnist_sum on the trained {label}: energies")
            mnist[label]["mnist_sum_steps_per_sec"] = ms.steps_per_sec
        rows, out, got, secs, _ = run(
            "eval_mnist_ebm", eval_mnist_ebm,
            ["--weights_dir", wdir, "--data_dir", ddir, "--out_dir",
             os.path.join(tmp, "er"), "--sample_steps", str(EBM_EVAL_STEPS)])
        check(f"mnist_ebm_ckpt_{MNIST_TRAIN_STEPS['ebm']}.npz" in out
              and all(np.isfinite(v).all() for v in rows.values()),
              f"eval_mnist_ebm: {rows}")
        mnist["eval_mnist_ebm"] = {"logp": rows, "sample_steps":
                                   EBM_EVAL_STEPS, "main_s": secs}
        results["mnist"] = mnist
        print("training mnist", json.dumps(mnist), flush=True)
    results["launches_by_run"] = by_run
    return results, launches


def phase_mesh_kernels(torch, potts, potts_fused, cnn, cnn_fused,
                       attention_fused, pmesh, dev, card):
    """Phase 12 (a)-(c): kernels A, B, C and C' at the shapes a shard gives
    them, held against their plain versions and (A, B) the blocks
    assembled against the whole call."""
    out = {"kernel_a_blocks": [], "kernel_b_members": []}
    p32 = potts.synthetic(GFP_WT, seed=0, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    P = p32.padded_dim
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        W, h = p32.W.to(dtype), p32.h.to(dtype)
        prep = potts_fused.prepare(W, h)
        for B in MESH_BATCHES:
            x = random_onehot(torch, gen, B, len(GFP_WT), dev)
            xf = potts._pad_flat(p32, x, torch.bfloat16)
            H, g = potts_fused.energy_and_grad(prep, None, xf)
            whole_ms = time_ms(lambda: potts_fused.energy_and_grad(
                prep, None, xf))
            for tp in MESH_TPS:
                blocks = [pmesh.potts_column_block(W, h, tp, r)
                          for r in range(tp)]
                Pp = blocks[0][0].shape[0]
                xfp = torch.nn.functional.pad(xf, (0, Pp - P))
                shares, grads, block_ms, errs = [], [], [], []
                for Wb, hb, c0 in blocks:
                    pb = potts_fused.prepare(Wb, hb)
                    Hs, gb = potts_fused.energy_and_grad(pb, None, xfp, c0)
                    Hs0, gb0 = potts_fused.energy_and_grad_plain(
                        Wb, hb, xfp.to(dtype), c0)
                    torch.cuda.synchronize()
                    errs.append(max((gb - gb0).abs().max().item(),
                                    (Hs - Hs0).abs().max().item()))
                    check(torch.allclose(gb, gb0, rtol=1e-5, atol=1e-4)
                          and torch.allclose(Hs, Hs0, rtol=1e-5, atol=1e-3),
                          f"kernel A block at column {c0} of {Pp}, tp={tp}, "
                          f"B={B} {dn}: max abs err {errs[-1]}")
                    shares.append(Hs)
                    grads.append(gb)
                    block_ms.append(time_ms(
                        lambda: potts_fused.energy_and_grad(pb, None, xfp,
                                                            c0)))
                Hsum = shares[0]
                for s_ in shares[1:]:
                    Hsum = Hsum + s_
                gcat = torch.cat(grads, 1)[:, :P]
                err_g = (gcat - g).abs().max().item()
                err_H = (Hsum - H).abs().max().item()
                check(torch.allclose(gcat, g, rtol=1e-5, atol=1e-4)
                      and torch.allclose(Hsum, H, rtol=1e-5, atol=1e-3),
                      f"kernel A blocks tp={tp} B={B} {dn}, assembled: max "
                      f"abs err grad {err_g}, H {err_H}")
                r = {"tp": tp, "B": B, "dtype": dn, "P_padded": Pp,
                     "N": Pp // tp, "max_abs_err_blocks_vs_plain": max(errs),
                     "max_abs_err_assembled_grad": err_g,
                     "max_abs_err_assembled_H": err_H,
                     "tol": "rtol 1e-5, atol 1e-4 (grad) / 1e-3 (H)",
                     "block_ms": block_ms, "whole_ms": whole_ms,
                     "card": card}
                out["kernel_a_blocks"].append(r)
                print("mesh kernel A", json.dumps(r), flush=True)

    gen = torch.Generator(device=dev).manual_seed(22)
    ens = cnn.init_ensemble(gen, MESH_EP_MEMBERS, input_size=len(GFP_WT))
    half = MESH_EP_MEMBERS // 2
    halves = [{k: {kk: v[i:i + half] for kk, v in layer.items()}
               for k, layer in ens.items()} for i in (0, half)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        prep = cnn_fused.prepare_ensemble(ens, dtype)
        preps = [cnn_fused.prepare_ensemble(hv, dtype) for hv in halves]
        for B in MESH_BATCHES:
            x = random_onehot(torch, gen, B, len(GFP_WT), dev)
            fit0, dx0 = cnn_fused.ensemble_apply_and_grad(prep, x)
            parts = [cnn_fused.ensemble_apply_and_grad(pr, x)
                     for pr in preps]
            fit = parts[0][0] * 0.5 + parts[1][0] * 0.5
            dx = parts[0][1] * 0.5 + parts[1][1] * 0.5
            torch.cuda.synchronize()
            res = cnn_compare(torch, fit, dx, fit0, dx0, dn)
            check(res["ok"], f"kernel B member blocks ep=2 B={B} {dn}: "
                  f"{res}")
            res.update({
                "ep": 2, "members": MESH_EP_MEMBERS, "B": B, "dtype": dn,
                "block_ms": [time_ms(
                    lambda pr=pr: cnn_fused.ensemble_apply_and_grad(pr, x))
                    for pr in preps],
                "whole_ms": time_ms(
                    lambda: cnn_fused.ensemble_apply_and_grad(prep, x)),
                "card": card})
            out["kernel_b_members"].append(res)
            print("mesh kernel B", json.dumps(res), flush=True)
    # transformer-S at tp = 4: 20 / 4 heads a rank, 128 chains
    heads = 20 // 4
    out["kernels_c_tp4"] = phase_attention(
        torch, attention_fused, dev, cases=((128 * heads, 237, 24),))
    return out


def mesh_child(protein_root, out_path):
    """Phase 12 (d), the process torchrun starts: world size 1 over nccl;
    the CLI's PPDE f32 run with --mesh_dp 1 and train_esm_mlm on a dp = 1
    mesh (and without it, for the rate beside it); writes its launch
    counts and numbers to ``out_path``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ppde_tpu_torch import training
    from ppde_tpu_torch.ops import attention_fused, cnn_fused, potts_fused
    from ppde_tpu_torch.parallel import mesh as pmesh
    from ppde_tpu_torch.scripts import directed_evolution as de

    dev = pmesh.init_distributed("cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"mesh child: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}; want nccl and 1")
    counters = COUNTERS
    got = {"backend": dist.get_backend(),
           "world_size": dist.get_world_size()}
    args = de.build_parser().parse_args(mesh_cli_argv(protein_root,
                                                      "mesh") +
                                        ["--mesh_dp", "1"])
    reset_counters(counters)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got["run_dir"] = str(de.main(args))
    got["cli_main_s"] = time.perf_counter() - t
    got["cli_launches"] = read_counters(counters)

    rng = np.random.default_rng(0)
    seqs = [GFP_WT]
    for _ in range(255):
        s_ = list(GFP_WT)
        for i in rng.choice(len(GFP_WT), size=3, replace=False):
            s_[i] = "ACDEFGHIKLMNPQRSTVWY"[rng.integers(20)]
        seqs.append("".join(s_))
    # the same run without the mesh, in this process, for the rate beside
    # the mesh run's
    args = de.build_parser().parse_args(mesh_cli_argv(protein_root,
                                                      "child-single"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got["run_dir_single"] = str(de.main(args))
    mesh = pmesh.make_mesh(dp=1, device=dev)
    training.train_esm_mlm(seqs, name="transformer-S", n_iters=2,
                           batch_size=MESH_TRAIN_BATCH, quiet=True,
                           device=dev)  # first-use costs, not timed
    for label, m in (("train_no_mesh", None), ("train_mesh_dp1", mesh)):
        reset_counters(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        training.train_esm_mlm(seqs, name="transformer-S",
                               n_iters=MESH_TRAIN_STEPS,
                               batch_size=MESH_TRAIN_BATCH, quiet=True,
                               device=dev, mesh=m, chunk=MESH_TRAIN_STEPS)
        torch.cuda.synchronize()
        got[label] = {"s": time.perf_counter() - t,
                      "steps_per_sec": MESH_TRAIN_STEPS
                      / (time.perf_counter() - t),
                      "launches": read_counters(counters)}
    with open(out_path, "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()


def mesh_cli_argv(protein_root, label):
    """Phase 7's PPDE f32 run (the CLI's defaults but 128 chains, nmut 10,
    lambda 15, no scoring), MESH_CLI_STEPS steps."""
    return ["--protein_weights", protein_root, "--protein", CLI_PROTEIN,
            "--results_path", os.path.join(protein_root, "results", label),
            "--sampler", "PPDE", "--run_signature", label,
            "--n_iters", str(MESH_CLI_STEPS), "--n_chains", str(CLI_CHAINS),
            "--log_every", str(CLI_LOG_EVERY), "--nmut_threshold",
            str(CLI_NMUT), "--energy_lamda", "15", "--seed", "5",
            "--disable_MSA_transformer_scoring"]


def phase_mesh(torch, counters, dev, card):
    """Phase 12: the kernels at a shard's shapes, the world-size-1 mesh run
    through torchrun, and the one-piece transformer gradient's memory."""
    from ppde_tpu_torch.models import cnn, esm2, potts
    from ppde_tpu_torch.ops import attention_fused, cnn_fused, potts_fused
    from ppde_tpu_torch.parallel import mesh as pmesh
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import seeded_protein

    out = phase_mesh_kernels(torch, potts, potts_fused, cnn, cnn_fused,
                             attention_fused, pmesh, dev, card)
    launches = {name: 0 for name in counters}
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_mesh.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        args = de.build_parser().parse_args(mesh_cli_argv(tmp, "single"))
        buf = io.StringIO()
        reset_counters(counters)
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            single_dir = de.main(args)
        single_s = time.perf_counter() - t
        single_launches = read_counters(counters)
        log.write(f"==== single device\n{buf.getvalue()}")
        child_json = os.path.join(tmp, "child.json")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", os.path.join(ROOT, "chip_smoke.py"),
             "--mesh-child", tmp, child_json],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        child_s = time.perf_counter() - t
        log.write(f"==== torchrun child (exit {proc.returncode})\n"
                  f"{proc.stdout}\n{proc.stderr}")
        check(proc.returncode == 0, f"mesh child failed (exit "
              f"{proc.returncode}): {proc.stderr[-2000:]}")
        with open(child_json) as f:
            child = json.load(f)
        mesh_dir = child["run_dir"]
        for name in ("population", "energy_scores", "energy_history",
                     "fitness_history", "pred_fitness_scores"):
            a = np.load(os.path.join(single_dir, name + ".npy"))
            b = np.load(os.path.join(mesh_dir, name + ".npy"))
            check(np.array_equal(a, b), f"mesh run (--mesh_dp 1) {name} is "
                  f"not the single-device run's (max abs diff "
                  f"{np.abs(a - b).max()})")
        want = {"potts_energy": MESH_CLI_STEPS + 1,
                "potts_energy_f32": MESH_CLI_STEPS + 1,
                "cnn_ensemble": MESH_CLI_STEPS + 1,
                "cnn_ensemble_f32": MESH_CLI_STEPS + 1}
        for label, got in (("single", single_launches),
                           ("mesh", child["cli_launches"])):
            check(all(got[k] == n for k, n in want.items()),
                  f"{label} CLI run: kernel launches {got}, not {want}")
        for label in ("train_no_mesh", "train_mesh_dp1"):
            n = child[label]["launches"]
            check(n["flash_attention_fwd"] == 12 * MESH_TRAIN_STEPS
                  and n["flash_attention_bwd"] == 12 * MESH_TRAIN_STEPS
                  and with_rotary(n) == n,
                  f"{label}: kernel C / C' (and qkv / rotary) launches {n}")
        for name, n in child["cli_launches"].items():
            launches[name] += n
        for name, n in child["train_mesh_dp1"]["launches"].items():
            launches[name] += n
        summaries = {}
        for label, d in (("single", single_dir), ("mesh", mesh_dir),
                         ("child_single", child["run_dir_single"])):
            with open(os.path.join(d, "summary.json")) as f:
                summaries[label] = json.load(f)
        out["mesh_run"] = {
            "backend": child["backend"], "world_size": child["world_size"],
            "cli_steps_per_sec_single": summaries["single"]["steps_per_sec"],
            "cli_steps_per_sec_mesh_dp1": summaries["mesh"]["steps_per_sec"],
            "cli_steps_per_sec_single_in_child":
                summaries["child_single"]["steps_per_sec"],
            "cli_main_s_single": single_s,
            "cli_main_s_mesh_dp1": child["cli_main_s"],
            "torchrun_child_s": child_s,
            "train_steps_per_sec_no_mesh":
                child["train_no_mesh"]["steps_per_sec"],
            "train_steps_per_sec_mesh_dp1":
                child["train_mesh_dp1"]["steps_per_sec"],
            "launches_single": single_launches,
            "launches_mesh": child["cli_launches"],
            "launches_train_mesh": child["train_mesh_dp1"]["launches"],
            "bit_equal": True, "card": card}
        print("mesh run", json.dumps(out["mesh_run"]), flush=True)
    out["memory"] = phase_memory(torch, esm2, dev, card)
    return out, launches


def phase_memory(torch, esm2, dev, card):
    """Phase 12 (e): peak memory of the one-piece transformer gradient."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(23)
    total = torch.cuda.get_device_properties(dev).total_memory
    for name, n in MEM_RUNS:
        params, apply_fn = esm2.load_expert(
            name, GFP_WT, allow_random=True, dtype=torch.bfloat16,
            device=dev)
        n_params = sum(t.numel() * t.element_size()
                       for t in esm2._flatten(params))
        x = random_onehot(torch, gen, n, len(GFP_WT), dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        r = {"config": name, "chains": n, "T": len(GFP_WT),
             "param_bytes": n_params, "baseline_bytes": base,
             "card_bytes": total, "card": card}
        t = time.perf_counter()
        try:
            with torch.enable_grad():
                xg = x.requires_grad_(True)
                y = apply_fn(params, xg)
                (g,) = torch.autograd.grad(y.sum(), xg)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(g).all()), f"{name} {n}: non-finite "
                  "gradient")
            r.update({"fits": True,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "s": time.perf_counter() - t})
            del y, g, xg
        except torch.cuda.OutOfMemoryError:
            r.update({"fits": False, "peak_bytes": None,
                      "s": time.perf_counter() - t})
        del params, apply_fn, x
        torch.cuda.empty_cache()
        rows.append(r)
        print("mesh memory", json.dumps(r), flush=True)
    for name, n in MEM_PREDICTED:
        m = next(r for r in rows if r["config"] == name and r["fits"])
        per_chain = (m["peak_bytes"] - m["baseline_bytes"]) / m["chains"]
        rows.append({"config": name, "chains": n, "predicted": True,
                     "peak_bytes": m["baseline_bytes"] + per_chain * n,
                     "bytes_per_chain": per_chain, "card_bytes": total,
                     "card": card})
        print("mesh memory", json.dumps(rows[-1]), flush=True)
    return rows


def bench_expected(row, args, dev):
    """The launches ``python -m ppde_tpu_torch.scripts.bench`` must make
    in one configuration at phase 13's flags (``args``): one energy_and_grad
    for the initial state and one a step, over the untimed and the 3 timed
    executions; kernels A and B once a call (bf16) on the GFP configs, C
    and C' once a layer a piece on the transformer config, none on MNIST."""
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.scripts import bench

    if row["domain"] == "mnist":
        return dict.fromkeys(COUNTERS, 0)
    steps = row["steps"]
    n_calls = 1 + (max(1, args.warmup // steps) + bench.REPS) * steps
    attention = norms = 0
    if row["expert"] != "potts":
        chunk = bench.transformer_chunk(row["n_chains"], dev)
        check(row["chunk_size"] == chunk, f"the bench's transformer chunk "
              f"{row['chunk_size']}, expected {chunk}")
        layers = esm2.CONFIGS["transformer-S"]["layers"]
        pieces = -(-row["n_chains"] // chunk) if chunk else 1
        attention, norms = layers * pieces, esm_norms(layers, pieces)
    return bench.expected_launches(dev, n_calls, args.dtype, 1, attention,
                                   norms)


def phase_bench(torch, dev, card, ppde_runs):
    """Phase 13: ``python -m ppde_tpu_torch.scripts.bench`` at its
    defaults but for ``BENCH_ARGV``'s steps, in a subprocess (it sets its
    own counters, which start at 0, and reads them around each
    configuration): exit code 0, one JSON line with every key, the four
    configurations with finite positive rates and
    their checks' numbers, the headline rule, and each kernel's launches
    exactly as ``bench_expected`` says. ``ppde_runs``: ppde.run's steps/s
    of the same configurations in phases 4 and 6, set beside the bench's.
    Returns (the bench's line with the phase's numbers, its launches)."""
    from ppde_tpu_torch.scripts import bench

    args = bench.build_parser().parse_args(list(BENCH_ARGV))
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ppde_tpu_torch.scripts.bench",
                        *BENCH_ARGV], cwd=ROOT, capture_output=True,
                       text=True, timeout=BENCH_TIMEOUT)
    wall_s = time.perf_counter() - t
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_bench.log"),
              "w") as f:
        f.write(p.stderr + p.stdout)
    check(p.returncode == 0,
          f"the bench exited {p.returncode}: {p.stderr[-3000:]}")
    out = p.stdout.strip().splitlines()
    check(len(out) == 1, f"the bench printed {len(out)} lines, not one")
    line = json.loads(out[0])
    detail = line.get("detail", {})
    check(all(k in line for k in BENCH_KEYS)
          and all(k in detail for k in BENCH_DETAIL_KEYS),
          f"the bench's line lacks keys: {sorted(line)} {sorted(detail)}")
    check(line["metric"] == bench.METRIC and detail["card"] == card,
          f"the bench's metric {line['metric']} or card {detail['card']}")
    rows = detail["configs"]
    check(sorted((r["domain"], r["n_chains"], r["expert"]) for r in rows)
          == sorted(BENCH_CONFIGS), f"the bench's configs: {rows}")
    launches = dict.fromkeys(COUNTERS, 0)
    for r in rows:
        check(all(k in r for k in BENCH_ROW_KEYS), f"bench row keys {r}")
        rates = (r["sampler_steps_per_sec"], r["chain_steps_per_sec"],
                 *r["execution_s"])
        check(len(r["execution_s"]) == bench.REPS
              and all(np.isfinite(v) and v > 0 for v in rates),
              f"bench {r['expert']} x {r['n_chains']}: rates {rates}")
        acc = r["checks"]["acceptance_rate"]
        check(0.0 < acc < 1.0,
              f"bench {r['expert']} x {r['n_chains']}: checks {r['checks']}")
        want = bench_expected(r, args, dev)
        check(r["launches"] == want,
              f"bench {r['expert']} x {r['n_chains']}: launches "
              f"{r['launches']}, expected {want}")
        for name, n in r["launches"].items():
            launches[name] += n
        r["ppde_run_steps_per_sec"] = ppde_runs.get(
            (r["domain"], r["n_chains"], r["expert"]))
    peak = max((r for r in rows if r["expert"] == "potts"),
               key=lambda r: r["chain_steps_per_sec"])
    check(line["value"] == peak["chain_steps_per_sec"]
          and line["vs_baseline"] > 0, f"the bench's headline {line}")
    line["phase_wall_s"] = wall_s
    print("bench", json.dumps(line), flush=True)
    return line, launches


def esm_forward_flops(name, T):
    """FLOPs of one ESM2 forward over a sequence of T tokens (the count of
    the JAX package's tools/esm_roofline.py): a layer's q, k, v, o
    projections 8 T D^2, its FFN 4 T D F, its scores and values 4 T^2 D,
    and the embedding and LM head 4 T D V."""
    from ppde_tpu_torch.models import esm2

    cfg = esm2.CONFIGS[name]
    D, Fd, V = cfg["dim"], cfg["ffn"], esm2.ESM_VOCAB
    return (cfg["layers"] * (8 * T * D * D + 4 * T * D * Fd + 4 * T * T * D)
            + 4 * T * D * V)


def driver_calls(script, args=(), env=None, root=None):
    """The calls one of the port's experiment drivers
    (``ppde_tpu_torch/scripts/<script>``) makes, as argument lists after
    ``python``: the driver run with a stub ``python`` first on PATH that
    records its arguments and runs nothing. With ``root``, from a copy of
    the port's drivers under ``root`` (a tree laid out as the repository),
    so that their skip checks see that tree, not the checkout."""
    with tempfile.TemporaryDirectory() as tmp:
        stub, log = os.path.join(tmp, "python"), os.path.join(tmp, "calls")
        with open(stub, "w") as f:
            f.write(DRIVER_STUB)
        os.chmod(stub, 0o755)
        scripts = os.path.join(ROOT, "ppde_tpu_torch", "scripts")
        if root is not None:
            dst = os.path.join(root, "ppde_tpu_torch", "scripts")
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(scripts):
                if f.endswith(".sh"):
                    shutil.copy(os.path.join(scripts, f), dst)
            scripts = dst
        p = subprocess.run(
            ["bash", os.path.join(scripts, script), *args],
            env=dict(os.environ, PATH=f"{tmp}:{os.environ['PATH']}",
                     STUB_LOG=log, **(env or {})),
            capture_output=True, text=True, timeout=60)
        check(p.returncode == 0, f"{script} exited {p.returncode}: "
              f"{p.stderr[-2000:]}")
        with open(log) as f:
            return recorded_calls(f.read())


def recorded_calls(text):
    """The argument lists ``DRIVER_STUB`` recorded (unit separators between
    arguments, record separators after calls)."""
    return [c.split("\x1f")[:-1] for c in text.split("\x1e")[:-1]]


def with_flags(argv, flags):
    """``argv`` with each flag's value replaced (or the flag appended)."""
    out = list(argv)
    for flag, value in flags.items():
        if flag in out:
            out[out.index(flag) + 1] = value
        else:
            out += [flag, value]
    return out


def cell_launches(args, steps, pieces=1, L=len(GFP_WT)):
    """The launches of one protein CLI run of PPDE or PPDE-PT (or of a
    sampler that takes no gradient, on an energy without a transformer:
    none), its transformer expert's gradient in ``pieces`` pieces. A
    (potts, float32: the CLI's Potts model) when the energy has a Potts
    term, and B, once for the initial state and once a step; with a
    transformer expert, C' once a layer a piece each time and C as often
    (twice under remat: transformer-L), plus one forward a layer for the
    expert's wild-type score at load and one for the CLI's wild-type
    energy (one piece each); the layer norms (``esm_norms``) as often as
    those forwards and backwards. ``--energy_function supervised`` has
    neither Potts nor transformer term. A wild type of L > 256 residues (the
    reference-width CNN, C = L; the bf16 expert at T = L) runs B's wide
    kernel and the key-tiled kernels C and C'. The qkv / rotary kernels run
    as often as C and C'; every other kernel (T, T': the MSA Transformer
    expert's) never."""
    from ppde_tpu_torch.models import esm2

    poe = args.energy_function == "product_of_experts"
    experts = args.unsupervised_expert.split("+") if poe else []
    name = next((e for e in experts if e.startswith("transformer")), None)
    grad = args.sampler in ("PPDE", "PPDE-PT")
    check(grad or name is None, f"no formula for {args.sampler} with {name}")
    calls = (steps + 1) * grad
    potts = "potts" in experts
    f32 = args.compute_dtype == "f32"
    want = {**dict.fromkeys(COUNTERS, 0),
            "potts_energy": calls * potts, "potts_energy_f32": calls * potts,
            "cnn_ensemble": calls, "cnn_ensemble_f32": calls * f32,
            "cnn_ensemble_wide": calls * (L > 256),
            "cnn_ensemble_wide_f32": calls * f32 * (L > 256),
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_attention_fwd_kt": 0, "flash_attention_bwd_kt": 0}
    if name:
        layers = esm2.CONFIGS[name]["layers"]
        remat = name == "transformer-L"
        want.update(flash_attention_fwd=layers * (
            2 + (1 + remat) * pieces * calls),
            flash_attention_bwd=layers * pieces * calls)
        for way in ("fwd", "bwd"):
            want[f"flash_attention_{way}_kt"] = (
                want[f"flash_attention_{way}"] * (L > 256))
        want.update(layer_norm_fwd=esm_norms(layers, 2 + pieces * calls,
                                             remat * pieces * calls),
                    layer_norm_bwd=esm_norms(layers, pieces * calls))
    return with_rotary(want)


def cell_launches_match(got, want, args):
    """``got == want`` (``cell_launches``), but for the MSA Transformer
    scorer after the run, when its scoring is on and finds weights: a
    forward of ``msa_norms`` layer-norm launches a batch of masked
    columns, whose number the run's mutations set."""
    from ppde_tpu_torch.models import msa_transformer as msat

    extra = got["layer_norm_fwd"] - want["layer_norm_fwd"]
    per = msa_norms(msat.CONFIGS[args.msa_transformer_model]["layers"], 1)
    return (dict(got, layer_norm_fwd=0) == dict(want, layer_norm_fwd=0)
            and extra >= 0 and extra % per == 0
            and (extra == 0 or not args.disable_MSA_transformer_scoring))


def phase_large(torch, counters, dev, card):
    """Phase 14: the large ESM2 experts at full width and depth through
    the port's experiment drivers' calls, in process: (a) the paper's
    transformer cell of run_protein_samplers.sh (GFP, transformer-M alone,
    lambda 1, the CLI's float32 CNN, one piece); (b) run_r5_150m.sh and
    (c) run_r4_650m.sh: finetune_esm with LoRA 8 (remat at transformer-L),
    then the potts+transformer PPDE cell (bf16 CNN, chunks of 64, msa-S
    scoring) on the merged checkpoint it wrote. Every run's launches are
    held exactly to ``cell_launches`` / the fine-tune's formula; the
    cells' artifacts to phase 7's checks; the fine-tunes' logged losses,
    their files, and the merged file against the LoRA file merged anew
    (same weights, same PLL). No fallback: a run that does not fit or a
    chunk other than the one asked for fails the phase."""
    from ppde_tpu_torch import runtime, training
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import finetune_esm, seeded_protein

    results, launches = {}, {name: 0 for name in counters}
    by_run = {}
    T, n_chains = len(GFP_WT), CLI_CHAINS
    msa_path = os.path.join(ROOT, EVAL_MSA)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_large.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log:
        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        paths = {"--protein_weights": tmp, "--protein": CLI_PROTEIN,
                 "--results_path": os.path.join(tmp, "results"),
                 "--log_every": str(LARGE_LOG_EVERY)}

        run = functools.partial(run_main, torch, counters, log, launches,
                                by_run)

        def cell(label, argv, name, steps, pieces):
            """One PPDE cell through the CLI: launches exact, phase 7's
            artifact checks, steps/s, peak memory, the bf16-peak share."""
            args = de.build_parser().parse_args(argv)
            chunk = runtime.resolve_esm_chunk(args.esm_chunk, True, n_chains,
                                              name, T, card_bytes)
            check((-(-n_chains // chunk) if chunk else 1) == pieces,
                  f"{label}: --esm_chunk {args.esm_chunk} gives chunk "
                  f"{chunk}, not {pieces} piece(s)")
            check(args.n_iters == steps and args.n_chains == n_chains,
                  f"{label}: {args.n_iters} steps of {args.n_chains}")
            run_dir, out, got, secs, tm = run(label, de, argv)
            want = cell_launches(args, steps, pieces)
            check(cell_launches_match(got, want, args),
                  f"{label}: kernel launches {got}, not {want}")
            r = check_cli_run(torch, runtime, args, run_dir, steps, dev)
            flops = 2 * esm_forward_flops(name, T) * n_chains
            r.update({"run": label, "expert": args.unsupervised_expert,
                      "layers": esm2.CONFIGS[name]["layers"],
                      "steps": steps, "n_chains": n_chains,
                      "pieces": pieces, "compute_dtype": args.compute_dtype,
                      "model_tflop_per_step": flops / 1e12,
                      "bf16_peak_share": flops * r["steps_per_sec"]
                      / PEAK_OPS["bfloat16"],
                      "peak_memory_gb": tm["main_peak_memory_gb"],
                      "main_s": secs, "launches": got, "launches_want": want,
                      "argv": argv, "card": card})
            print("large", json.dumps(r), flush=True)
            return r

        # (a) the paper's transformer cell: the sweep's GFP call with
        # --esm_weights, on a seeded random-init transformer-M file
        name = "transformer-M"
        weights = os.path.join(tmp, "transformer-M.npz")
        esm2.save_npz_checkpoint(weights, esm2.init(
            torch.Generator(device=dev).manual_seed(0), name, torch.float32))
        calls = driver_calls("run_protein_samplers.sh", env={
            "N_ITERS": str(LARGE_SWEEP_STEPS), "N_CHAINS": str(n_chains),
            "ESM_WEIGHTS": weights})
        argv = next(c for c in calls if name in c
                    and c[c.index("--protein") + 1] == CLI_PROTEIN)[2:]
        results["sweep_transformer_M"] = cell(
            "run_protein_samplers transformer-M", with_flags(argv, paths),
            name, LARGE_SWEEP_STEPS, 1)
        os.remove(weights)

        # (b), (c): the LoRA fine-tune, then the cell on its merged file
        for script, name, ft_steps, cell_steps in LARGE_ROWS:
            calls = driver_calls(script, (str(ft_steps), str(cell_steps)))
            check([c[1] for c in calls] == [
                "ppde_tpu_torch.scripts.finetune_esm",
                "ppde_tpu_torch.scripts.directed_evolution"],
                f"{script}: calls {calls}")
            ft_argv, cell_argv = calls[0][2:], calls[1][2:]
            out_prefix = os.path.join(tmp, name)
            ft = finetune_esm.build_parser().parse_args(with_flags(ft_argv, {
                "--msa": msa_path, "--out": out_prefix, "--wt_fasta":
                os.path.join(tmp, CLI_PROTEIN, "wt.fasta")}))
            check(ft.esm_model == name and ft.n_iters == ft_steps
                  and ft.lora_rank == 8 and ft.val_frac > 0,
                  f"{script}: fine-tune {ft}")
            label = f"{script[:-3]} finetune_esm {name}"
            merged, out, got, secs, tm = run(
                label, finetune_esm, with_flags(ft_argv, {
                    "--msa": msa_path, "--out": out_prefix, "--wt_fasta":
                    ft.wt_fasta}), "train_esm_mlm")
            layers = esm2.CONFIGS[name]["layers"]
            remat = name == "transformer-L"
            # a step: one forward a layer (and its recompute under remat)
            # and one backward; the held-out CE before and after: 4
            # forwards a layer each
            want = dict.fromkeys(COUNTERS, 0)
            want.update(flash_attention_fwd=layers * ((1 + remat) * ft_steps
                                                      + 2 * 4),
                        flash_attention_bwd=layers * ft_steps)
            # the norms likewise; LoRA freezes the first norm's input (the
            # embedding) and its g, b: no backward there
            want.update(layer_norm_fwd=esm_norms(layers, ft_steps + 2 * 4,
                                                 remat * ft_steps),
                        layer_norm_bwd=esm_norms(layers, ft_steps) - ft_steps)
            want = with_rotary(want)
            check(got == want, f"{label}: kernel launches {got}, not {want}")
            files = sorted(f for f in os.listdir(tmp) if f.startswith(name))
            ckpt = f"{out_prefix}_ckpt_{ft_steps}.npz"
            lora_file = f"{out_prefix}_lora_{ft_steps}.npz"
            check(files == sorted(os.path.basename(f)
                                  for f in (ckpt, lora_file)),
                  f"{label}: wrote {files}")
            ce = logged(r"held-out masked CE \w+: (\S+)", out)
            check(len(ce) == 2 and np.isfinite(ce).all(),
                  f"{label}: held-out CE {ce}")
            r = esm_record(label, name, tm, out, ft_steps, ft.batch_size,
                           card)
            # the merged file against the base merged anew with the
            # adapters of the LoRA file: the same weights, the same PLL
            gen = torch.Generator(device=dev).manual_seed(ft.seed)
            base = esm2.init(gen, name, torch.float32)
            lora, step = training.load_ckpt(lora_file, esm2.lora_init(
                gen, name, ft.lora_rank))
            again = esm2.lora_merge(base, lora, ft.lora_alpha)
            reloaded = esm2.load_npz_checkpoint(ckpt, name, torch.float32,
                                                dev)
            check(step == ft_steps and all(
                torch.equal(a, b) for a, b in zip(esm2._flatten(again),
                                                  esm2._flatten(reloaded))),
                f"{label}: the merged file is not the LoRA file merged")
            x = random_onehot(torch, torch.Generator(device=dev).manual_seed(
                29), 8, T, dev).to(torch.bfloat16) @ torch.from_numpy(
                esm2.potts_to_esm_perm()).to(dev, torch.bfloat16)
            heads = esm2.CONFIGS[name]["heads"]
            with torch.no_grad():
                pll = [esm2.pseudo_log_likelihood(
                    esm2.cast_params(p, torch.bfloat16), x, heads)
                    for p in (again, reloaded)]
            check(torch.equal(*pll) and bool(torch.isfinite(pll[0]).all()),
                  f"{label}: PLL of the merged file {pll[1]} vs {pll[0]}")
            del base, lora, again, reloaded, merged
            r.update({"layers": layers, "remat": remat,
                      "lora_rank": ft.lora_rank, "main_s": secs,
                      "heldout_ce_before": ce[0], "heldout_ce_after": ce[1],
                      "files": files, "merged_file_gb":
                      os.path.getsize(ckpt) / 1e9,
                      "launches": got, "launches_want": want,
                      "argv": ft_argv})
            print("large", json.dumps(r), flush=True)
            row = {"finetune": r}
            subs = {**paths, "--esm_weights": ckpt,
                    "--summary_json": os.path.join(tmp, "summary.json")}
            if "--msa_transformer_weights" in cell_argv:  # the msa-S scorer
                scorer = cell_argv[cell_argv.index(
                    "--msa_transformer_weights") + 1]
                subs.update({"--msa_path": msa_path,
                             "--msa_transformer_weights":
                             os.path.join(ROOT, scorer)})
            row["cell"] = cell(f"{script[:-3]} cell potts+{name}",
                               with_flags(cell_argv, subs), name, cell_steps,
                               -(-n_chains // LARGE_CHUNK))
            for f in (ckpt, lora_file):
                os.remove(f)
            results[script[:-3]] = row
    results["launches_by_run"] = by_run
    return results, launches


def file_states(top):
    """{path under ``top``: (size, mtime in ns, sha1)} of every file below
    ``top``."""
    import hashlib

    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                digest = hashlib.sha1(fh.read()).hexdigest()
            st = os.stat(path)
            out[os.path.relpath(path, top)] = (st.st_size, st.st_mtime_ns,
                                               digest)
    return out


def process_start_s(torch):
    """Seconds a fresh interpreter takes to import the protein CLI, load
    the built kernels and reach the card: what each call of a driver pays
    before its entry point's work, and run_cells pays once a grid."""
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", (
        "import torch\n"
        "from ppde_tpu_torch.scripts import directed_evolution\n"
        "from ppde_tpu_torch.ops import _build\n"
        "_build.build_all()\n"
        "torch.zeros(1, device='cuda')\n"
        "torch.cuda.synchronize()")], cwd=ROOT, check=True, timeout=300)
    return time.perf_counter() - t


def timing(torch, times):
    """A wrap for ``patched``: each call's seconds, the device synchronised
    before and after, appended to ``times``."""
    def wrap(fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return res
        return timed
    return wrap


def device_us(torch, fn):
    """Device microseconds of one call of fn by the port's kernels (A, B,
    C, C'), each the device work launched inside its wrapper's span
    (``kernel.a``, ``kernel.b``, ``kernel.c``, ``kernel.c_bwd``), and the
    rest; their kernel counts, the activities whose launch call the trace
    lost, and the call's wall microseconds: torch.profiler after a warm-up
    call (``profiling.trace``, read by ``profiling.device_by_span``)."""
    from ppde_tpu_torch import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        by_span = profiling.device_by_span(tmp)
    kinds = {"kernel.a": "A", "kernel.b": "B", "kernel.c": "C",
             "kernel.c_bwd": "C'"}
    out = dict.fromkeys(list(kinds.values()) + ["other"], 0.0)
    n = dict.fromkeys(out, 0)
    unmatched = by_span.pop("unmatched")
    for span, row in by_span.items():
        kind = kinds.get(span, "other")
        out[kind] += row["us"]
        n[kind] += row["kernels"]
    out["wall"] = wall
    out["kernels"] = n
    out["unmatched_launches"] = unmatched
    return out


def phase_long(torch, counters, dev, card):
    """Phase 16: proteins of more than 256 residues through the protein
    CLI (``LONG_RUNS``): PPDE on seeded wild types of 400 residues (potts
    expert, the CNN in float32 and in bf16: kernel A and B's wide kernel)
    and 1022 residues (potts+transformer-S, random init, CNN float32: A,
    B's wide kernel, and the key-tiled C and C' at T = 1022, one piece of
    CLI_CHAINS chains, as resolve_esm_chunk predicts). Each run's launches
    exactly ``cell_launches``, phase 7's artifact checks (finite values,
    the nmut budget, the best energies against a fresh evaluation) and an
    acceptance rate strictly inside (0, 1); steps/s, peak memory, the
    device time by kernel in one traced energy_and_grad of the run's
    population, and A and B on it alone by CUDA events. At 1022 the one-piece transformer gradient's peak
    memory (over the bytes held before it, as phase 12 (e) measures it)
    against ``runtime.ESM_GRAD_MEMORY``'s prediction."""
    from ppde_tpu_torch import codec, runtime
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.models import potts as potts_mod
    from ppde_tpu_torch.ops import cnn_fused, potts_fused
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import seeded_protein

    runs, launches, by_run, captured = [], {n: 0 for n in counters}, {}, []
    card_bytes = torch.cuda.get_device_properties(dev).total_memory

    def capturing(orig):
        def get(args, device):
            runner = orig(args, device)

            def run(**kw):
                captured.append(runner(**kw))
                return captured[-1]
            return run
        return get

    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_long.log")
    with tempfile.TemporaryDirectory() as tmp, open(log_path, "w") as log, \
            patched(de, "get_sampler_runner", capturing):
        run = functools.partial(run_main, torch, counters, log, launches,
                                by_run)
        for label, L, expert, cdt, steps in LONG_RUNS:
            rng = np.random.default_rng(LONG_SEED + L)
            wt = "".join(np.array(list(codec.ALPHABET))[
                rng.integers(0, 20, L)])
            protein = f"seeded_L{L}"
            t0 = time.perf_counter()
            if not os.path.isdir(os.path.join(tmp, protein)):
                seeded_protein.write_protein_dir(tmp, protein, wt, seed=0)
            setup_s = time.perf_counter() - t0
            name = next((e for e in expert.split("+")
                         if e.startswith("transformer")), None)
            argv = ["--protein_weights", tmp, "--protein", protein,
                    "--results_path", os.path.join(tmp, "results"),
                    "--sampler", "PPDE",
                    "--run_signature", label.replace(" ", "_"),
                    "--n_iters", str(steps), "--n_chains", str(CLI_CHAINS),
                    "--log_every", str(LONG_LOG_EVERY),
                    "--nmut_threshold", str(CLI_NMUT),
                    "--energy_lamda", "15",
                    "--disable_MSA_transformer_scoring",
                    "--unsupervised_expert", expert,
                    "--compute_dtype", cdt] + ["--allow_random_esm"] * bool(
                        name)
            args = de.build_parser().parse_args(argv)
            chunk = runtime.resolve_esm_chunk(
                args.esm_chunk, name is not None, CLI_CHAINS, name, L,
                card_bytes)
            check(chunk is None, f"{label}: the transformer's gradient in "
                  f"chunks of {chunk}, not one piece")
            captured.clear()
            run_dir, out, got, secs, tm = run(label, de, argv)
            want = cell_launches(args, steps, 1, L)
            check(cell_launches_match(got, want, args),
                  f"{label}: kernel launches {got}, not {want}")
            r = check_cli_run(torch, runtime, args, run_dir, steps, dev)
            res = captured[-1]
            rate = float(res.n_accepted.sum()) / (steps * CLI_CHAINS)
            check(0.0 < rate < 1.0, f"{label}: acceptance rate {rate}")
            # one traced energy_and_grad of the run's final population, and
            # at 1022 the one-piece gradient's peak memory
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                en = runtime.build_protein_energy(args, dev)[0]
            x = torch.as_tensor(res.final_x).to(dev)
            with torch.no_grad():
                us = device_us(torch, lambda: en.energy_and_grad(en.params,
                                                                 x))
            # kernels A and B on this population alone, by CUDA events
            sup = cnn_fused.prepare_ensemble(en.params["sup"], None if cdt ==
                                             "f32" else torch.bfloat16)
            us["B_alone_ms"] = time_ms(
                lambda: cnn_fused.ensemble_apply_and_grad(sup, x), 3)
            pp = en.params["potts"]
            planes = potts_fused.prepare(pp.W, pp.h)
            xf = potts_mod._pad_flat(pp, x, torch.bfloat16)
            us["A_alone_ms"] = time_ms(
                lambda: potts_fused.energy_and_grad(planes, None, xf))
            del sup, planes, xf
            r.update({"run": label, "L": L, "expert": expert,
                      "compute_dtype": cdt, "steps": steps,
                      "n_chains": CLI_CHAINS, "acceptance_rate": rate,
                      "setup_s": setup_s, "main_s": secs,
                      "peak_memory_gb": tm["main_peak_memory_gb"],
                      "traced_energy_and_grad_us": us, "launches": got,
                      "launches_want": want, "card": card})
            if name:
                base_b, per = runtime.ESM_GRAD_MEMORY[name]
                predicted = base_b + per * CLI_CHAINS * L
                tparams, tapply = esm2.load_expert(
                    name, wt, allow_random=True, dtype=torch.bfloat16,
                    device=dev)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                with torch.enable_grad():
                    xg = x.float().requires_grad_(True)
                    (g,) = torch.autograd.grad(tapply(tparams, xg).sum(), xg)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(g).all()),
                      f"{label}: non-finite transformer gradient")
                peak = torch.cuda.max_memory_allocated(dev) - base
                r.update({"transformer_grad_peak_bytes": peak,
                          "transformer_grad_predicted_bytes": predicted,
                          "transformer_grad_peak_over_predicted":
                              peak / predicted})
                del tparams, tapply, g, xg
            del x, en
            torch.cuda.empty_cache()
            runs.append(r)
            print("long", json.dumps(r), flush=True)
    return runs, launches


def phase_evidence(torch, counters, dev, card):
    """Phase 15: the evidence drivers' calls at full width, in process,
    from a temporary tree laid out as the repository (the tracked alignment
    and scorer copied in, seeded GFP and MNIST stand-ins at the paths the
    drivers name; the drivers' stub calls recorded there, so their skip
    checks see the tree): (a) run_r5_family10k.sh: the batch-64 fine-tune
    of transformer-S, then run_cells --r5_family on GFP's 8 cells in one
    process (one of them again alone, bit for bit; the grid again, every
    cell skipped; peak memory flat over each expert's cells); (b) the
    held-out CE tool on random init and the fine-tune's checkpoint (equal
    to the fine-tune's before / after lines); (c) run_r4_evidence.sh's and
    run_r4_qc_pt.sh's sampler flags; (d) the Potts QC and the lambda_J
    decision; (e) the scorer evaluation and the EBM-scored MNIST summary.
    Launches exact in every run (none in (d), (e)); the repository's
    results/ unchanged. No fallback: a failed cell fails the phase.
    ``python -m ppde_tpu_torch.scripts.predict_driver_wall`` predicts the
    drivers' wall times at their real settings from the saved results."""
    from ppde_tpu_torch.scripts import seeded_mnist, seeded_protein

    results, launches, by_run = {}, {name: 0 for name in counters}, {}
    repo_results = file_states(os.path.join(ROOT, "results"))
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_evidence.log")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tree, open(log_path, "w") as log:
        run = functools.partial(run_main, torch, counters, log, launches,
                                by_run)
        # the tree: the tracked inputs copied (a run that wrote one would
        # change the copy), seeded stand-ins where the drivers look
        wdir = os.path.join(tree, "weights")
        seeded_protein.write_protein_dir(wdir, CLI_PROTEIN, GFP_WT, seed=0)
        seeded_mnist.write_weights_dir(os.path.join(wdir, "mnist_models"))
        seeded_mnist.write_data_dir(os.path.join(tree, "data", "mnist"))
        scorer = os.path.join("results", "esm_family",
                              "GFP_msat_S_ckpt_2000.npz")
        for rel in (EVAL_MSA, scorer):
            os.makedirs(os.path.dirname(os.path.join(tree, rel)),
                        exist_ok=True)
            shutil.copy(os.path.join(ROOT, rel), os.path.join(tree, rel))
        os.chdir(tree)
        try:
            results["process_start_s"] = process_start_s(torch)
            fam, ft, tool_r = evidence_family(torch, counters, dev, card,
                                              run, log, launches, by_run,
                                              tree)
            results.update(family_cells=fam, finetune=ft, heldout_ce=tool_r)
            results["evidence_flags"] = evidence_flags(torch, run, tree, dev,
                                                       card)
            results["qc"] = evidence_qc(torch, run, tree, card)
            results["scorer_mnist"] = evidence_scorer_mnist(run, tree, card)
        finally:
            os.chdir(cwd)
    after = file_states(os.path.join(ROOT, "results"))
    changed = sorted(k for k in set(repo_results) | set(after)
                     if repo_results.get(k) != after.get(k))
    check(not changed, f"phase 15 changed the repository's results/: "
          f"{changed[:20]}")
    results["results_unchanged"] = {"files": len(after)}
    results["launches_by_run"] = by_run
    return results, launches


def evidence_flags(torch, run, tree, dev, card):
    """Phase 15 (c): run_r4_evidence.sh's GFP ref-rev, lambda-0,
    supervised-only and CMA-ES cells and run_r4_qc_pt.sh pt's supervised
    PPDE and PPDE-PT (UBE4B's, on the GFP stand-in), cut."""
    from ppde_tpu_torch import runtime
    from ppde_tpu_torch.scripts import directed_evolution as de

    ev = driver_calls("run_r4_evidence.sh", ("proteins",), root=tree)
    check(len(ev) == 45, f"run_r4_evidence.sh proteins: {len(ev)} calls")
    named = {os.path.basename(c[c.index("--summary_json") + 1])[:-5]: c[2:]
             for c in ev}
    pt = driver_calls("run_r4_qc_pt.sh", ("pt",), root=tree)
    check([c[1] for c in pt] == [
        "ppde_tpu_torch.scripts.directed_evolution"] * 2,
        f"run_r4_qc_pt.sh pt: {pt}")
    flags = []
    for label, argv in ([(n, named[n]) for n in EVID_FLAG_CELLS] + [
            (os.path.basename(c[c.index("--summary_json") + 1])[:-5],
             c[2:]) for c in pt]):
        a = de.build_parser().parse_args(argv)
        steps = EVID_CMAES_GENS if a.sampler == "CMAES" else EVID_STEPS
        argv = with_flags(argv, {"--protein": CLI_PROTEIN,
                                 "--n_iters": str(steps)})
        a = de.build_parser().parse_args(argv)
        run_dir, out, got, secs, tm = run(label, de, argv)
        want = cell_launches(a, steps)
        # cell_launches: A (f32) and B once for the initial state and once
        # a step; A 0 without a Potts term (supervised); none for CMA-ES
        check(cell_launches_match(got, want, a),
              f"{label}: kernel launches {got}, not {want}")
        r = check_cli_run(torch, runtime, a, run_dir, steps, dev)
        with open(a.summary_json) as f:
            summary = json.load(f)
        check(summary["n_iters"] == steps,
              f"{label}: --summary_json says {summary['n_iters']}")
        r.update({"run": label, "sampler": a.sampler, "steps": steps,
                  "energy_function": a.energy_function,
                  "energy_lamda": a.energy_lamda,
                  "reference_reverse": a.ppde_reference_reverse,
                  "main_s": secs, "peak_memory_gb": tm["main_peak_memory_gb"],
                  "launches": got, "launches_want": want, "argv": argv,
                  "card": card})
        flags.append(r)
        print("evidence flags", json.dumps(r), flush=True)
    return flags


def evidence_family(torch, counters, dev, card, run, log, launches, by_run,
                    tree):
    """Phase 15 (a) and (b): run_r5_family10k.sh's GFP fine-tune, the
    family grid through run_cells, and the held-out CE tool."""
    from ppde_tpu_torch import metrics, runtime, training
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.scripts import directed_evolution as de
    from ppde_tpu_torch.scripts import eval_esm_heldout_ce as tool
    from ppde_tpu_torch.scripts import finetune_esm, run_cells

    T, layers = len(GFP_WT), esm2.CONFIGS["transformer-S"]["layers"]
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    calls = driver_calls("run_r5_family10k.sh", root=tree)
    check([c[1].rsplit(".", 1)[1] for c in calls] == [
        "finetune_esm"] * 3 + ["run_cells"] and calls[-1][2:] == [
        "--r5_family"], f"run_r5_family10k.sh: calls {calls}")
    ft_argv = with_flags(
        next(c for c in calls if CLI_PROTEIN in c[c.index("--out") + 1])[2:],
        {"--n_iters": str(EVID_FT_STEPS),
         "--ckpt_every": str(EVID_FT_STEPS),
         "--log_every": str(EVID_FT_STEPS // 4)})
    ft = finetune_esm.build_parser().parse_args(ft_argv)
    check(ft.esm_model == "transformer-S" and ft.batch_size == 64
          and ft.lr == 3e-4 and ft.val_frac == 0.05 and ft.msa == EVAL_MSA
          and ft.lora_rank == 0, f"run_r5_family10k.sh: fine-tune {ft}")
    label = "finetune_esm transformer-S batch 64"
    _, out, got, secs, tm = run(label, finetune_esm, ft_argv,
                                "train_esm_mlm")
    # a step: one forward and one backward a layer; the held-out CE
    # before and after: 4 forwards a layer each
    want = with_rotary(dict(
        dict.fromkeys(COUNTERS, 0),
        flash_attention_fwd=layers * (EVID_FT_STEPS + 2 * 4),
        flash_attention_bwd=layers * EVID_FT_STEPS,
        layer_norm_fwd=esm_norms(layers, EVID_FT_STEPS + 2 * 4),
        layer_norm_bwd=esm_norms(layers, EVID_FT_STEPS)))
    check(got == want, f"{label}: kernel launches {got}, not {want}")
    n_held = int(re.search(r"\(\+(\d+) held out\)", out).group(1))
    ce = dict(re.findall(r"held-out masked CE (\w+): (\S+)", out))
    check(set(ce) == {"before", "after"} and np.isfinite(
        [float(v) for v in ce.values()]).all(), f"{label}: held-out {ce}")
    ckpt = f"{ft.out}_ckpt_{EVID_FT_STEPS}.npz"
    check(os.path.exists(ckpt), f"{label}: no {ckpt}")
    ft_r = esm_record(label, "transformer-S", tm, out, EVID_FT_STEPS,
                      ft.batch_size, card)
    ft_r.update({"main_s": secs, "n_heldout": n_held,
                 "heldout_ce_before": float(ce["before"]),
                 "heldout_ce_after": float(ce["after"]), "launches": got,
                 "launches_want": want, "argv": ft_argv})
    print("evidence finetune", json.dumps(ft_r), flush=True)
    # the cut fine-tune's file at the path r5_family_spec names
    expert = f"{ft.out}_ckpt_4000.npz"
    os.symlink(os.path.basename(ckpt), expert)

    # (a) the grid in one process: each cell's launches, peak memory
    # (reset before it), sampling and scoring time and result captured
    spec = [c for c in run_cells.r5_family_spec(EVID_CELL_STEPS)
            if "GFP" in c["name"]]
    check(len(spec) == EVID_CELLS, f"r5_family_spec: {len(spec)} GFP cells")
    rc_argv = calls[-1][2:] + ["--only", "GFP", "--family_iters",
                               str(EVID_CELL_STEPS)]
    cells, cur, score_s = [], {}, []

    def per_cell(orig):
        def main(a):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters(counters)
            cur.clear()
            n_scored = len(score_s)
            t = time.perf_counter()
            run_dir = orig(a)
            torch.cuda.synchronize()
            cells.append({"args": a, "run_dir": run_dir,
                          "main_s": time.perf_counter() - t,
                          "launches": read_counters(counters),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "score_s": sum(score_s[n_scored:]), **cur})
            return run_dir
        return main

    def timed_runner(orig):
        def get(args, device):
            runner = orig(args, device)

            def run_(**kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = runner(**kw)
                torch.cuda.synchronize()
                cur.update(runner_s=time.perf_counter() - t, result=res)
                return res
            return run_
        return get

    def grid(label):
        """run_cells.main on rc_argv: (its output, seconds)."""
        out = io.StringIO()
        t = time.perf_counter()
        with patched(de, "main", per_cell), \
                patched(de, "get_sampler_runner", timed_runner), \
                patched(metrics, "proteins_transformer_score",
                        timing(torch, score_s)), \
                patched(run_cells, "STOP_FILE",
                        lambda _: os.path.join(tree, "r5_stop")), \
                contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            try:
                run_cells.main(rc_argv)
            except SystemExit as e:
                check(False, f"{label}: run_cells exited {e.code}: "
                      f"{out.getvalue()[-2000:]}")
        secs = time.perf_counter() - t
        log.write(f"==== {label}\n{out.getvalue()}")
        return out.getvalue(), secs

    reset_counters(counters)
    out, grid_s = grid("run_cells --r5_family --only GFP")
    check(f"done={EVID_CELLS} skipped=0 failed=0" in out and len(cells)
          == EVID_CELLS, f"run_cells: {out[-500:]}")
    check(read_counters(counters) == cells[-1]["launches"],
          "run_cells launched a kernel outside its cells")
    rows = []
    for c, sp in zip(cells, spec):
        a = c["args"]
        check(a.summary_json == sp["argv"][sp["argv"].index(
            "--summary_json") + 1], f"cell order: {a.summary_json}")
        chunk = runtime.resolve_esm_chunk(a.esm_chunk, True, CLI_CHAINS,
                                          "transformer-S", T, card_bytes)
        check(not chunk or chunk >= CLI_CHAINS,
              f"{sp['name']}: chunk {chunk}, not one piece")
        want = cell_launches(a, EVID_CELL_STEPS, 1)
        # cell_launches: A (potts+S only) and B once for the initial
        # state and once a step; C' 12 a step (and initial state); C as
        # C' plus 12 for the expert's wild-type score and 12 for the
        # CLI's wild-type energy
        check(cell_launches_match(c["launches"], want, a),
              f"{sp['name']}: kernel launches {c['launches']}, not {want}")
        r = check_cli_run(torch, runtime, a, c["run_dir"], EVID_CELL_STEPS,
                          dev)
        with open(a.summary_json) as f:
            summary = json.load(f)
        check(summary["n_iters"] == EVID_CELL_STEPS
              and "evolutionary_density" in summary,
              f"{sp['name']}: summary {sorted(summary)}")
        for name, n in c["launches"].items():
            launches[name] += n
        by_run["run_cells " + sp["name"]] = c["launches"]
        flops = 2 * esm_forward_flops("transformer-S", T) * CLI_CHAINS
        r.update({"cell": sp["name"], "expert": a.unsupervised_expert,
                  "seed": a.seed, "steps": EVID_CELL_STEPS,
                  "n_chains": CLI_CHAINS, "main_s": c["main_s"],
                  "sampling_s": c["runner_s"], "msa_s_scoring_s":
                  c["score_s"], "outside_s": c["main_s"] - c["runner_s"]
                  - c["score_s"], "peak_memory_gb": c["peak_bytes"] / 1e9,
                  "bf16_peak_share": flops * r["steps_per_sec"]
                  / PEAK_OPS["bfloat16"], "launches": c["launches"],
                  "card": card})
        rows.append(r)
        print("evidence cell", json.dumps(r), flush=True)
    # peak memory flat from each expert's first cell to its last
    mem = {}
    for c, r in zip(cells, rows):
        mem.setdefault(r["expert"], []).append(c["peak_bytes"])
    for expert, peaks in mem.items():
        check(peaks[-1] <= peaks[0] + EVID_MEM_MARGIN,
              f"{expert}: peak memory {peaks[0]} -> {peaks[-1]} bytes over "
              f"its cells (margin {EVID_MEM_MARGIN})")

    # one cell again alone, in this process: bit for bit its grid run
    sp = spec[EVID_RERUN]
    a = de.build_parser().parse_args(sp["argv"])
    with patched(de, "get_sampler_runner", timed_runner), \
            patched(metrics, "proteins_transformer_score",
                        timing(torch, score_s)), \
            contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        per_cell(de.main)(a)
    again, first = cells[-1], cells[EVID_RERUN]
    for key in CKPT_COMPARED:
        x, y = getattr(again["result"], key), getattr(first["result"], key)
        check(x.shape == y.shape and np.array_equal(x, y),
              f"{sp['name']} alone: {key} differs from its grid run")
    check(again["launches"] == first["launches"],
          f"{sp['name']} alone: launches {again['launches']}")

    # the grid again: every cell skipped, nothing launched or rewritten
    states = file_states(os.path.join(tree, "results"))
    n_cells = len(cells)
    reset_counters(counters)
    out, again_s = grid("run_cells --r5_family --only GFP (again)")
    check(f"done=0 skipped={EVID_CELLS} failed=0" in out
          and len(cells) == n_cells and not any(
              read_counters(counters).values())
          and file_states(os.path.join(tree, "results")) == states,
          f"run_cells again: {out[-500:]}")
    outside = [r["outside_s"] for r in rows]
    fam = {"cells": rows, "grid_s": grid_s,
           "run_cells_own_s": grid_s - sum(c["main_s"] for c in
                                           cells[:EVID_CELLS]),
           "outside_first_cell_s": outside[0],
           "outside_later_cells_mean_s": float(np.mean(outside[1:])),
           "peak_memory_gb_by_expert": {k: [v / 1e9 for v in p]
                                        for k, p in mem.items()},
           "memory_margin_bytes": EVID_MEM_MARGIN,
           "rerun_alone": {"cell": sp["name"], "bit_exact": list(
               CKPT_COMPARED), "main_s": again["main_s"]},
           "second_pass_s": again_s, "second_pass_skipped": EVID_CELLS}
    print("evidence grid", json.dumps({k: v for k, v in fam.items()
                                       if k != "cells"}), flush=True)

    # (b) the held-out CE tool on random init and the fine-tune's file,
    # the fine-tune's flags: its before and after lines again
    ce_s = []
    tool_argv = ["--msa", ft.msa, "--wt_fasta", ft.wt_fasta, "--esm_model",
                 ft.esm_model, "--val_frac", str(ft.val_frac), "--seed",
                 str(ft.seed), "--ckpt", ckpt]
    with patched(training, "esm_mlm_heldout_ce", timing(torch, ce_s)):
        res, out, got, secs, _ = run("eval_esm_heldout_ce", tool, tool_argv)
    name = os.path.basename(ckpt)
    want = with_rotary(dict(dict.fromkeys(COUNTERS, 0),
                            flash_attention_fwd=2 * layers * 4,  # 4 a CE
                            layer_norm_fwd=esm_norms(layers, 2 * 4)))
    check(got == want, f"eval_esm_heldout_ce: launches {got}, not {want}")
    check(res["n_heldout"] == n_held and res["length"] == T,
          f"eval_esm_heldout_ce: {res['n_heldout']} held out of length "
          f"{res['length']}, the fine-tune {n_held}")
    check(f"{res['random_init']:.4f}" == ce["before"]
          and f"{res[name]:.4f}" == ce["after"],
          f"eval_esm_heldout_ce: {res} against the fine-tune's {ce}")
    tool_r = {"n_heldout": n_held, "random_init": res["random_init"],
              "checkpoint": res[name], "finetune_before": ce["before"],
              "finetune_after": ce["after"], "ce_s": ce_s, "main_s": secs,
              "launches": got, "argv": tool_argv, "card": card}
    print("evidence heldout_ce", json.dumps(tool_r), flush=True)
    return fam, ft_r, tool_r


def evidence_qc(torch, run, tree, card):
    """Phase 15 (d): fit_potts --lambda_J 0.001 on the GFP alignment,
    select_lambda and calibrate_oracle_scale (both of
    run_r5_ljdecision.sh's calls, on that fit) against the seeded GFP
    directory, sample_potts_msa at the QC ladder's largest rung from the
    fit. No port kernel runs."""
    from ppde_tpu_torch.models import potts
    from ppde_tpu_torch.scripts import (calibrate_oracle_scale, fit_potts,
                                        sample_potts_msa, select_lambda)

    zero = dict.fromkeys(COUNTERS, 0)
    qc = driver_calls("run_r4_qc_pt.sh", ("qc",), root=tree)
    lj = driver_calls("run_r5_ljdecision.sh", root=tree)
    fit_npz = os.path.join(tree, "potts_lj0.001.npz")  # not /tmp's
    subs = {"--protein": CLI_PROTEIN, "--potts_npz": fit_npz}

    def first(calls, entry, **kv):
        return next(c[2:] for c in calls if c[1].endswith(entry) and all(
            c[c.index(k) + 1] == v for k, v in kv.items()))

    out_r = {}
    fit_argv = with_flags(first(qc, "fit_potts", **{"--lambda_J": "0.001"}),
                          {"--msa": EVAL_MSA, "--out": fit_npz})
    save_s = []
    with patched(potts, "save_npz", timing(torch, save_s)):
        hist, out, got, secs, tm = run("fit_potts lambda_J 0.001",
                                       fit_potts, fit_argv, "fit")
    check(got == zero, f"fit_potts: kernel launches {got}")
    check(np.isfinite(hist).all() and hist[-1] < hist[0],
          f"fit_potts: loss {hist[0]} -> {hist[-1]}")
    out_r["fit_potts"] = {"steps": len(hist), "fit_s": tm["seconds"],
                          "steps_per_sec": tm["later_steps_per_sec"],
                          "save_npz_s": save_s[0], "main_s": secs,
                          "loss_first": hist[0], "loss_last": hist[-1],
                          "launches": got}
    sel_argv = with_flags(first(qc, "select_lambda", **{
        "--potts_npz": "/tmp/potts_lj0.001.npz"}), subs)
    lam, out, got, secs, _ = run("select_lambda", select_lambda, sel_argv)
    check(got == zero, f"select_lambda: kernel launches {got}")
    check(np.isfinite(lam) and lam > 0, f"select_lambda: {lam}")
    out_r["select_lambda"] = {"lambda": lam, "main_s": secs}
    cal = [c[2:] for c in lj if c[1].endswith("calibrate_oracle_scale")]
    check(len(cal) == 2, f"run_r5_ljdecision.sh: {lj}")
    recs = []
    for argv in cal:
        rec, out, got, secs, _ = run("calibrate_oracle_scale",
                                     calibrate_oracle_scale,
                                     with_flags(argv, subs))
        check(got == zero, f"calibrate_oracle_scale: launches {got}")
        recs.append({"alpha": rec["alpha"], "scale_s": rec["scale_s"],
                     "spearman_dH_vs_fitness_by_k":
                     rec["spearman_dH_vs_fitness_by_k"], "main_s": secs})
    jsonl = cal[0][cal[0].index("--out_json") + 1]
    with open(jsonl) as f:
        lines = [json.loads(line) for line in f]
    check(len(lines) == 2 and all(
        np.isfinite([r["alpha"], r["scale_s"],
                     *r["spearman_dH_vs_fitness_by_k"].values()]).all()
        and r["spearman_dH_vs_fitness_by_k"] for r in lines),
        f"{jsonl}: {lines}")
    out_r["calibrate_oracle_scale"] = recs
    # the ladder's largest rung on a directory whose Potts file is the fit
    ladder = [c[2:] for c in qc if c[1].endswith("sample_potts_msa")
              and "--potts_npz" not in c]
    argv = ladder[-1]
    check(argv[argv.index("--n_seqs") + 1] == "8192"
          and argv[argv.index("--n_sweeps") + 1] == "1200",
          f"the QC ladder's last rung: {argv}")
    qdir = os.path.join(tree, "qc_weights", CLI_PROTEIN)
    os.makedirs(qdir)
    src = os.path.join(tree, "weights", CLI_PROTEIN)
    for f in os.listdir(src):
        os.symlink(os.path.join(src, f), os.path.join(qdir, f))
    shutil.copy(fit_npz, os.path.join(qdir, "potts.npz"))
    argv = with_flags(argv, {
        "--protein": CLI_PROTEIN, "--protein_weights": "qc_weights",
        "--qc_msa": EVAL_MSA, "--n_sweeps": str(EVID_QC_SWEEPS)})
    gibbs_s = []
    with patched(potts, "gibbs_sample", timing(torch, gibbs_s)):
        (seqs, rec), out, got, secs, _ = run("sample_potts_msa 8192",
                                             sample_potts_msa, argv)
    r1, r2 = rec["single_site_freq_r"], rec["pair_covariance_r"]
    check(got == zero, f"sample_potts_msa: kernel launches {got}")
    check(len(seqs) == 8192 and r1 is not None and r2 is not None
          and np.isfinite([r1, r2]).all(),
          f"sample_potts_msa: {len(seqs)} sequences, QC r {r1}, {r2}")
    out_r["sample_potts_msa"] = {
        "n_seqs": 8192, "n_sweeps": EVID_QC_SWEEPS, "gibbs_s": gibbs_s[0],
        "sweeps_per_sec": EVID_QC_SWEEPS / gibbs_s[0], "main_s": secs,
        "qc": rec, "launches": got, "card": card}
    print("evidence qc", json.dumps(out_r), flush=True)
    return out_r


def evidence_scorer_mnist(run, tree, card):
    """Phase 15 (e): run_r4_scorer_eval.sh's GFP calls (msa-S at 256 rows
    and 256 mutants, random and the tracked scorer), two of
    run_r4_evidence.sh's r4full mnist_sum calls and the EBM-scored summary
    of the r4full runs. No port kernel runs."""
    from ppde_tpu_torch.scripts import (eval_expert_correlation, mnist_sum,
                                        summarize_mnist_runs)

    zero = dict.fromkeys(COUNTERS, 0)
    out_r = {"scorer_eval": {}}
    se = driver_calls("run_r4_scorer_eval.sh", root=tree)
    check(len(se) == 2 and all(c[c.index("--protein") + 1] == CLI_PROTEIN
                               for c in se), f"run_r4_scorer_eval.sh: {se}")
    for c in se:
        mode = "trained" if "--msat_weights" in c else "random"
        argv = c[2:]
        res, out, got, secs, _ = run(f"eval_expert_correlation msa-S {mode}",
                                     eval_expert_correlation, argv)
        rho = res["spearman_vs_oracle"]
        with open(argv[argv.index("--out_json") + 1]) as f:
            saved = json.load(f)["spearman_vs_oracle"]
        check(scorer_norms_only(got, "msa-S"),
              f"eval_expert_correlation {mode}: kernel launches {got}")
        check(saved == rho and "msat_" in " ".join(rho)
              and all(np.isfinite(v) for v in rho.values()),
              f"eval_expert_correlation {mode}: rho {rho}")
        out_r["scorer_eval"][mode] = {"spearman_vs_oracle": rho,
                                      "main_s": secs}
    mn = driver_calls("run_r4_evidence.sh", ("mnist",), root=tree)
    mruns = [c[2:] for c in mn if c[1].endswith("mnist_sum")
             and c[c.index("--suffix") + 1] == "r4full"][:2]
    out_r["mnist"] = []
    for argv in mruns:
        # the card's machine has no matplotlib: csv only, and the viz
        # writer's .npy (what the summariser reads) written here as it
        # writes it
        argv = with_flags(argv, {"--n_iters": str(EVID_MNIST_STEPS),
                                 "--log_every": str(EVID_MNIST_LOG_EVERY),
                                 "--metrics": "csv"})
        a = mnist_sum.build_parser().parse_args(argv)
        label = f"mnist_sum {a.sampler} r4full"
        seen = set(os.listdir(a.results_path)) if os.path.isdir(
            a.results_path) else set()
        res, out, got, secs, _ = run(label, mnist_sum, argv)
        check(got == zero, f"{label}: kernel launches {got}")
        check(np.isfinite(res.energy_history).all(),
              f"{label}: non-finite energies")
        csv = [f for f in set(os.listdir(a.results_path)) - seen
               if f.endswith("_r4full_oracle_sums.csv")]
        check(len(csv) == 1, f"{label}: wrote {csv}")
        prefix = os.path.join(a.results_path,
                              csv[0][:-len("_oracle_sums.csv")])
        np.save(prefix + "_final_population.npy",
                res.final_x.reshape(-1, 28, 28))
        out_r["mnist"].append({"run": os.path.basename(prefix),
                               "steps": EVID_MNIST_STEPS,
                               "steps_per_sec": res.steps_per_sec,
                               "main_s": secs})
    sm = next(c[2:] for c in mn if c[1].endswith("summarize_mnist_runs")
              and c[c.index("--runs_glob") + 1].endswith("_r4full"))
    rows, out, got, secs, _ = run("summarize_mnist_runs r4full",
                                  summarize_mnist_runs, sm)
    with open(sm[sm.index("--out_json") + 1]) as f:
        saved = json.load(f)
    check(got == zero, f"summarize_mnist_runs: kernel launches {got}")
    check(len(rows) == 2 and saved == rows and all(
        np.isfinite([r["ebm_logp_mean"], r["ebm_logp_std"]]).all()
        for r in rows), f"summarize_mnist_runs: {rows}")
    out_r["mnist_summary"] = {"rows": rows, "main_s": secs, "card": card}
    print("evidence scorer_mnist", json.dumps(out_r), flush=True)
    return out_r


def attention_numbers(r, way):
    """One phase-5 record's numbers of kernel C (way "fwd") or C' ("bwd")."""
    return {"shape": [r["Z"], r["T"], r["hd"]],
            "max_abs_err": r[f"max_abs_err_{way}"],
            "ms": r[f"{way}_ms"], "plain_ms": r[f"{way}_plain_ms"],
            "bound_ms": r[f"{way}_bound_ms"],
            "bound_by": r[f"{way}_bound_by"],
            "library_ms": r[f"{way}_library_ms_sdpa"]}


def attention_row(c, c1, way, launches, line):
    """The kernels line's row of kernel C (way "fwd") or C' ("bwd"): the
    chunk-16 call c as the headline, the one-piece call c1 beside it."""
    return {"name": f"flash_attention_{way}", "route": "cuda",
            "source": "ppde_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"ppde_tpu/ops/attention_pallas.py:{line}",
            "launches": launches, **attention_numbers(c, way),
            "one_piece": attention_numbers(c1, way)}


def rotary_row(rows, way, launches):
    """The kernels line's row of the qkv / rotary kernel (way "fwd" or
    "bwd"): ESM2-150M's call at GFP in bf16 (ROTARY_CASES[0]) as the
    headline, every other case of phase 5 beside it."""
    def numbers(r):
        return {"shape": [r["B"], r["T"], r["heads"], r["hd"]],
                "dtype": r["dtype"], "ms": r[f"{way}_ms"],
                "plain_ms": r[f"{way}_plain_ms"],
                "bound_ms": r[f"{way}_bound_ms"],
                "bound_by": r[f"{way}_bound_by"]}

    head = next(r for r in rows if (r["B"], r["T"], r["heads"], r["hd"])
                == ROTARY_CASES[0] and r["dtype"] == "bfloat16")
    return {"name": f"qkv_rotary_{way}", "route": "cuda",
            "source": "ppde_tpu_torch/csrc/qkv_rotary.cu",
            "replaces": "no TPU kernel (ppde_tpu/models/esm2.py: jnp)",
            "launches": launches, "max_abs_err": 0.0, **numbers(head),
            "library_ms": None,
            "cases": [numbers(r) for r in rows if r is not head]}


def layer_norm_row(rows, way, launches):
    """The kernels line's row of the layer-norm kernel (way "fwd" or
    "bwd"): the ESM2-150M cell's norm in bf16 (LN_CASES[0]) as the
    headline, every other case of phase 5 beside it."""
    def numbers(r):
        err = (max(r["max_abs_err_dx"], r["max_abs_err_dg"],
                   r["max_abs_err_db"]) if way == "bwd"
               else r["max_abs_err_y"])
        return {"shape": [r["rows"], r["D"]], "dtype": r["dtype"],
                "max_abs_err": err, "ms": r[f"{way}_ms"],
                "plain_ms": r[f"{way}_plain_ms"],
                "bound_ms": r[f"{way}_bound_ms"],
                "bound_by": r[f"{way}_bound_by"],
                "library_ms": r[f"{way}_library_ms"]}

    head = next(r for r in rows if (r["rows"], r["D"]) == LN_CASES[0]
                and r["dtype"] == "bfloat16")
    return {"name": f"layer_norm_{way}", "route": "cuda",
            "source": "ppde_tpu_torch/csrc/layer_norm.cu",
            "replaces": "no TPU kernel (ppde_tpu/models/esm2.py: jnp)",
            "launches": launches, **numbers(head),
            "cases": [numbers(r) for r in rows if r is not head]}


def row_attention_row(rows, way, launches):
    """The kernels line's row of kernel T (way "fwd") or T' ("bwd"): the
    msa-1b cell's launch in bf16 (ROW_CASES[0]) as the headline, the
    float32 case beside it."""
    def numbers(r):
        return {"shape": [r["N"], r["R"], r["C"], r["heads"], r["hd"]],
                "dtype": r["dtype"], "max_abs_err": r[f"max_abs_err_{way}"],
                "ms": r[f"{way}_ms"], "plain_ms": r[f"{way}_plain_ms"],
                "bound_ms": r[f"{way}_bound_ms"],
                "bound_by": r[f"{way}_bound_by"],
                "library_ms": r[f"{way}_library_ms_sdpa"]}

    head, *more = rows
    return {"name": f"row_attention_{way}", "route": "cuda",
            "source": "ppde_tpu_torch/csrc/row_attention.cu",
            "replaces": "no TPU kernel (ppde_tpu/models/msa_transformer.py:"
                        " two einsums)",
            "launches": launches, **numbers(head),
            "cases": [numbers(r) for r in more]}


def kernel_rows(counts):
    """The launches of each row of the kernels line from the counters: A's
    bf16 and float32 launches; B's tc (bf16), simt (float32) and wide (each
    type) kernels; the register (rs) and key-tiled kernels of C and C';
    the qkv / rotary kernels; kernels T and T'; the layer-norm kernels."""
    wide32 = counts["cnn_ensemble_wide_f32"]
    wide16 = counts["cnn_ensemble_wide"] - wide32
    return {
        "potts_energy": counts["potts_energy"] - counts["potts_energy_f32"],
        "potts_energy_f32": counts["potts_energy_f32"],
        "cnn_ensemble": (counts["cnn_ensemble"] - counts["cnn_ensemble_f32"]
                         - wide16),
        "cnn_ensemble_f32": counts["cnn_ensemble_f32"] - wide32,
        "cnn_ensemble_wide": wide16, "cnn_ensemble_wide_f32": wide32,
        **{f"flash_attention_{w}": counts[f"flash_attention_{w}"]
           - counts[f"flash_attention_{w}_kt"] for w in ("fwd", "bwd")},
        **{f"flash_attention_{w}_kt": counts[f"flash_attention_{w}_kt"]
           for w in ("fwd", "bwd")},
        **{f"qkv_rotary_{w}": counts[f"qkv_rotary_{w}"]
           for w in ("fwd", "bwd")},
        **{f"row_attention_{w}": counts[f"row_attention_{w}"]
           for w in ("fwd", "bwd")},
        **{f"layer_norm_{w}": counts[f"layer_norm_{w}"]
           for w in ("fwd", "bwd")}}


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-child":
        mesh_child(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ppde_tpu_torch import codec, energy as energy_mod, utils
    from ppde_tpu_torch.models import cnn, esm2, potts
    from ppde_tpu_torch.ops import (_build, attention_fused, cnn_fused,
                                    layer_norm_fused, potts_fused,
                                    rotary_fused, row_attention_fused)
    from ppde_tpu_torch.samplers.protein import ppde

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    dev = utils.resolve_device("cuda")
    build_s = _build.build_all()
    print(f"kernel build {build_s:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in _build.ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)

    counters = COUNTERS  # every kernel's counter in profiling's registry
    phases = {
        "potts": lambda: phase_potts(torch, potts, potts_fused, dev),
        "cnn": lambda: phase_cnn(torch, cnn, cnn_fused, dev),
        "sampler": lambda: phase_sampler(torch, codec, utils, energy_mod,
                                         potts, cnn, ppde, counters, dev,
                                         card),
        "attention": lambda: phase_attention(torch, attention_fused, dev),
        "rotary": lambda: phase_rotary(torch, esm2, rotary_fused, dev),
        "row_attention": lambda: phase_row_attention(
            torch, row_attention_fused, counters, dev, card),
        "layer_norm": lambda: phase_layer_norm(torch, layer_norm_fused,
                                               dev),
        "transformer": lambda: phase_transformer(
            torch, codec, energy_mod, potts, cnn, esm2, ppde, counters, dev,
            card),
        "cli": lambda: phase_cli(torch, counters, dev, card),
        "checkpoint": lambda: phase_checkpoint(torch, counters, dev, card),
        "mnist": lambda: phase_mnist(torch, counters, dev, card),
        "eval": lambda: phase_eval(torch, counters, dev, card),
        "training": lambda: phase_training(torch, counters, dev, card),
        "mesh": lambda: phase_mesh(torch, counters, dev, card),
        "bench": lambda: phase_bench(torch, dev, card, {
            **{("gfp", r["n_chains"], "potts"): r["steps_per_sec"]
               for r in got["sampler"][0]},
            **{("gfp", r["n_chains"], "potts+transformer-S"):
               r["steps_per_sec"] for r in got["transformer"][0]
               if r["chunk_size"] is None}}),
        "large": lambda: phase_large(torch, counters, dev, card),
        "evidence": lambda: phase_evidence(torch, counters, dev, card),
        "long": lambda: phase_long(torch, counters, dev, card)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    got = {}
    for name, run in phases.items():
        t = time.perf_counter()
        got[name] = run()
        print(f"phase {name} {time.perf_counter() - t:.1f} s", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    pa, pb, pc, pr, pn = got["potts"], got["cnn"], got["attention"], \
        got["rotary"], got["layer_norm"]
    runs, launches = got["sampler"]
    tr_runs, tr_launches = got["transformer"]
    row_runs, row_launches = got["row_attention"]
    cli_runs, cli_launches = got["cli"]
    eval_runs, eval_launches = got["eval"]
    train_runs, train_launches = got["training"]
    mesh_runs, mesh_launches = got["mesh"]
    bench_line, bench_launches = got["bench"]
    large_runs, large_launches = got["large"]
    evid_runs, evid_launches = got["evidence"]
    long_runs, long_launches = got["long"]
    for more in (tr_launches, row_launches, cli_launches, eval_launches,
                 train_launches, mesh_launches, bench_launches,
                 large_launches, evid_launches, long_launches):
        for name, n in more.items():
            launches[name] += n

    # one headline case per kernel: the 1024-chain population in bf16 for A
    # and B, 128 chains (the CLI's runs) for their float32 kernels, the
    # chunk-16 call of the transformer path in bf16 for C and C'; launches
    # by type
    def headline(rows, B, dn, **kw):
        return next(r for r in rows if r["B"] == B and r["dtype"] == dn
                    and all(r[k] == v for k, v in kw.items()))

    def row_a(name, a, n):
        return {"name": name, "route": "cuda",
                "source": "ppde_tpu_torch/csrc/potts_energy.cu",
                "replaces": "ppde_tpu/ops/potts_pallas.py:56",
                "launches": n,
                "max_abs_err": max(a["max_abs_err_grad"], a["max_abs_err_H"]),
                "ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
                "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
                "library_ms": a["library_ms_addmm_grad_only"], "B": a["B"],
                "dtype": a["dtype"]}

    def row_b(name, b, n):
        return {"name": name, "route": "cuda",
                "source": "ppde_tpu_torch/csrc/cnn_ensemble.cu",
                "replaces": "ppde_tpu/ops/cnn_pallas.py:138",
                "launches": n,
                "max_abs_err": max(b["max_abs_err_fit"], b["max_abs_err_dx"]),
                "ms": b["kernel_ms"], "plain_ms": b["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None, "B": b["B"], "dtype": b["dtype"]}

    c, c1, ce, cs, cl = (
        next(r for r in pc if (r["Z"], r["T"], r["hd"]) == case
             and r["dtype"] == "bfloat16")
        for case in ATTN_CASES[:2] + ((1280, 237, 24), (640, 237, 24),
                                      (640, 237, 64)))
    by_row = kernel_rows(launches)

    def headline_wide(dn):  # the 1022-residue case, 128 random sequences
        return next(r for r in pb if r.get("L") == LONG_CNN_LENGTHS[-1]
                    and r["B"] == "128" and r["dtype"] == dn
                    and r["pool_bwd"] == "split")

    # the key-tiled C and C' at the shape phase 16 gives them: one piece of
    # 128 chains of transformer-S at T = 1022, bf16
    ckt = next(r for r in pc if (r["Z"], r["T"], r["hd"]) == (2560, 1022, 24)
               and r["dtype"] == "bfloat16")
    kernels = {"kernels": [
        row_a("potts_energy", headline(pa, 1024, "bfloat16", W="symmetric"),
              by_row["potts_energy"]),
        row_a("potts_energy_f32", headline(pa, 128, "float32",
                                           W="symmetric"),
              by_row["potts_energy_f32"]),
        row_b("cnn_ensemble", headline(pb, 1024, "bfloat16",
                                       pool_bwd="split"),
              by_row["cnn_ensemble"]),
        row_b("cnn_ensemble_f32", headline(pb, 128, "float32",
                                           pool_bwd="split"),
              by_row["cnn_ensemble_f32"]),
        row_b("cnn_ensemble_wide", headline_wide("bfloat16"),
              by_row["cnn_ensemble_wide"]),
        row_b("cnn_ensemble_wide_f32", headline_wide("float32"),
              by_row["cnn_ensemble_wide_f32"]),
        attention_row(c, c1, "fwd", by_row["flash_attention_fwd"], 78),
        attention_row(c, c1, "bwd", by_row["flash_attention_bwd"], 99),
        dict(attention_row(ckt, ckt, "fwd", by_row["flash_attention_fwd_kt"],
                           78), name="flash_attention_fwd_kt"),
        dict(attention_row(ckt, ckt, "bwd", by_row["flash_attention_bwd_kt"],
                           99), name="flash_attention_bwd_kt"),
        *(rotary_row(pr, way, by_row[f"qkv_rotary_{way}"])
          for way in ("fwd", "bwd")),
        *(row_attention_row(row_runs["cases"], way,
                            by_row[f"row_attention_{way}"])
          for way in ("fwd", "bwd")),
        *(layer_norm_row(pn, way, by_row[f"layer_norm_{way}"])
          for way in ("fwd", "bwd")),
    ]}
    # the key-tiled kernels also run every float32 call: GFP's chunk-16 and
    # one-piece shapes beside the library call
    for row in kernels["kernels"]:
        if not row["name"].endswith("_kt"):
            continue
        way = row["name"].split("_")[2]
        row["float32"] = {
            label: attention_numbers(next(
                r for r in pc if (r["Z"], r["T"], r["hd"]) == case
                and r["dtype"] == "float32"), way)
            for label, case in (("chunk_16", ATTN_CASES[0]),
                                ("one_piece", ATTN_CASES[1]))}
    # kernels C and C' by path: the transformer sampler (phase 6), the
    # evaluation's transformer column (phase 10), finetune_esm and the CLI
    # run on its checkpoint (phase 11); finetune_esm's shapes' numbers and
    # phase 14's (bf16)
    for row in kernels["kernels"]:
        name = row["name"]
        if name not in ("flash_attention_fwd", "flash_attention_bwd"):
            continue
        by_run = train_runs["launches_by_run"]
        row["launches_by_path"] = {
            "transformer_sampler": tr_launches[name],
            "eval_expert_correlation": eval_launches[name],
            "finetune_esm": sum(by_run[k][name] for k in (
                "finetune_esm transformer-S",
                "finetune_esm transformer-L LoRA")),
            "cli_on_finetuned_esm":
                by_run["directed_evolution --esm_weights"][name]}
        way = name.rsplit("_", 1)[1]
        row["finetune_esm"] = attention_numbers(cs, way)
        row["finetune_esm_L"] = attention_numbers(cl, way)
        for key, cases in (("large_experts", LARGE_ATTN_CASES),
                           ("evidence_drivers", EVID_ATTN_CASES)):
            row[key] = {
                label: attention_numbers(next(
                    r for r in pc if (r["Z"], r["T"], r["hd"]) == case
                    and r["dtype"] == "bfloat16"), way)
                for label, case in cases}
        if name == "flash_attention_fwd":  # the evaluation's chunk of 64
            row["eval_expert_correlation"] = attention_numbers(ce, "fwd")
    # kernel A's launches in the world-size-1 mesh run of the CLI (phase
    # 12 (d)); its column blocks (12 (a)) are comparison calls, not counted
    for row in kernels["kernels"][:2]:
        key = "potts_energy_f32" if row["name"] == "potts_energy_f32" \
            else "potts_energy"
        n = mesh_runs["mesh_run"]["launches_mesh"]
        row["launches_by_path"] = {
            "cli_mesh_dp1": n[key] - (0 if key == "potts_energy_f32"
                                      else n["potts_energy_f32"])}
        blk = next(r for r in mesh_runs["kernel_a_blocks"]
                   if r["B"] == row["B"] and r["dtype"] == row["dtype"]
                   and r["tp"] == 4)
        row["tp4_block"] = {"ms": blk["block_ms"], "whole_ms":
                            blk["whole_ms"], "max_abs_err":
                            blk["max_abs_err_blocks_vs_plain"]}
    # every kernel's launches in phase 13's bench run, phase 14's
    # large-expert runs, phase 15's evidence drivers and phase 16's long
    # proteins, by kernel
    for path, got_n in (("bench", bench_launches),
                        ("large_experts", large_launches),
                        ("evidence_drivers", evid_launches),
                        ("long_proteins", long_launches)):
        rows_n = kernel_rows(got_n)
        for row in kernels["kernels"]:
            row.setdefault("launches_by_path", {})[path] = rows_n[row["name"]]
    check(all(k["launches"] > 0 for k in kernels["kernels"]),
          f"a kernel the main path runs was not launched: {kernels}")
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernel_a": pa,
                   "kernel_b": pb, "sampler": runs, "kernels_c": pc,
                   "qkv_rotary": pr, "row_attention": row_runs,
                   "layer_norm": pn,
                   "transformer_sampler": tr_runs, "cli": cli_runs,
                   "checkpoint": got["checkpoint"], "mnist": got["mnist"],
                   "eval": eval_runs, "training": train_runs,
                   "mesh": mesh_runs, "bench": bench_line,
                   "large": large_runs, "evidence": evid_runs,
                   "long": long_runs, **kernels},
                  f, indent=1)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
