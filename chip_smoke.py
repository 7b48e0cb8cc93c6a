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
     sampler has them, and in the stacked layout;
  4. the PPDE-PAS sampler on GFP with the Potts + CNN-ensemble energy
     (synthetic seeded Potts, seeded 3-member ensemble, bf16, lambda=15,
     pas_length=2, nmut_threshold=10): 128 chains and 1024 chains. The
     kernels' launch counters are set to 0 just before and read just after;
  5. kernels C and C' (attention forward and backward) against their plain
     versions at ESM2's head shapes, float32 and bfloat16, each run twice
     (bit-for-bit repeatable), held elementwise and by the relative norm
     of the difference, timed beside the plain version and
     scaled_dot_product_attention, with the floor the special function
     units set on exp beside the bound;
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
     must name kernels A and B;
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
     its defaults, in a subprocess (GFP potts PoE at 128 and 1024 chains,
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
     rates of the same configurations.
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
import io
import itertools
import json
import os
import re
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
# (Z, T, hd) of kernels C and C': the transformer path's calls at chunk 16
# and in one piece (ESM2-S: 20 heads, hd 24), the M and L head widths, the
# longest T, a small ragged case, eval_expert_correlation's calls (a chunk
# of 64 mutants, and the wild type alone), and finetune_esm's: a batch of
# 32 at transformer-S and -L (hd 64), and the held-out CE's 200 sequences
ATTN_CASES = ((320, 237, 24), (2560, 237, 24), (320, 237, 32),
              (320, 237, 64), (20, 512, 64), (7, 33, 16),
              (1280, 237, 24), (20, 237, 24), (640, 237, 24),
              (640, 237, 64), (4000, 237, 24))
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


def reset_counters(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counters(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


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
              and got["flash_attention_bwd"] >= need,
              f"chunk {chunk}: attention launches {got} < {need}")
        check(got["potts_energy"] >= steps and got["cnn_ensemble"] >= steps,
              f"chunk {chunk}: kernel launches {got} < {steps} steps")
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
    check(files == sorted(CLI_ARTIFACTS), f"{args.sampler}: artifacts {files}")
    arr = {f[:-4]: np.load(os.path.join(run_dir, f)) for f in files
           if f.endswith(".npy")}
    n, L = CLI_CHAINS, len(GFP_WT)
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
    wt = runtime.make_initial_protein_population(
        os.path.join(args.protein_weights, args.protein), 1, "cpu")[0].numpy()
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
        with open(os.path.join(trace_dir, "trace.json")) as f:
            text = f.read()
        names = ("potts_grad_kernel_wgmma", "fit_grad_kernel")
        check(all(n in text for n in names),
              f"the trace of a PPDE segment does not name {names}")
        r = {"run": "trace", "trace_bytes": len(text), "names": names,
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
            want = {"potts_energy_f32": EVAL_STEPS + 1,
                    "cnn_ensemble_f32": EVAL_STEPS + 1,
                    "flash_attention_fwd": 0, "flash_attention_bwd": 0}
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
        check(not any(got.values()),
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
        want = {"flash_attention_fwd": want_c, "flash_attention_bwd": 0,
                "potts_energy": 0, "cnn_ensemble": 0}
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


def phase_training(torch, counters, dev, card):
    """Training and fitting through their entry points at full width on
    the tracked GFP alignment: finetune_esm at transformer-S (kernels C
    and C' on every step, launches held to their formula; held-out CE
    must fall; the checkpoint scores in the protein CLI), at transformer-L
    with LoRA (C' at hd = 64 under remat), fit_potts and
    sample_potts_msa, finetune_msa at msa-S, the three MNIST trainers on
    the synthetic source, eval_mnist_ebm and mnist_sum on what they
    wrote."""
    from ppde_tpu_torch import training
    from ppde_tpu_torch.models import esm2, mnist_nets, potts_fit
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
        def run(label, module, argv, trainer=None, log_every=None):
            """module.main on argv under the launch counters; with
            ``trainer`` (a name in ``training`` or ``potts_fit``) that
            call is timed alone, with its peak memory, and its steps
            after the first (each ends in an optimizer step) apart."""
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
                # the first step ends in a sync; the later ones are timed
                # when the host has queued them (the steps are host-paced)
                def marked(self, grads):
                    step(self, grads)
                    if self.count == 1:
                        torch.cuda.synchronize()
                    marks.append((self.count, time.perf_counter()))
                return marked

            host = potts_fit if trainer == "fit" else training
            out = io.StringIO()
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
            log.write(f"==== {label}\n{out.getvalue()}")
            return res, out.getvalue(), got, secs, tm

        seeded_protein.write_protein_dir(tmp, CLI_PROTEIN, GFP_WT, seed=0)
        wt_fasta = os.path.join(tmp, CLI_PROTEIN, "wt.fasta")
        n_rows = len(open(msa_path).read().split(">")) - 1
        n_val = max(1, int(round(TRAIN_VAL_FRAC * n_rows)))
        T = len(GFP_WT)

        def esm_record(label, name, tm, out, steps, batch):
            ce = logged(r"\[esm_mlm\] iter \d+ ce (\S+)", out)
            check(ce and all(np.isfinite(ce)),
                  f"{label}: logged losses {ce}")
            flops = esm_train_flops(name, batch, T)
            sps = tm["later_steps_per_sec"]
            check(tm["steps"] == steps, f"{label}: {tm['steps']} steps")
            return {"model": name, "steps": steps, "batch": batch, "T": T,
                    "train_s": tm["seconds"],
                    "first_step_s": tm["first_step_s"],
                    "steps_per_sec_whole_call": steps / tm["seconds"],
                    "steps_per_sec": sps, "tokens_per_sec": sps * batch * T,
                    "tflop_per_step": flops / 1e12,
                    "bf16_peak_share": flops * sps / PEAK_OPS["bfloat16"],
                    "peak_memory_gb": tm["peak_memory_gb"],
                    "loss_first_logged": ce[0], "loss_last_logged": ce[-1],
                    "card": card}

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
        want = {"flash_attention_fwd": n_layers * (TRAIN_S_STEPS + 2 * 4),
                "flash_attention_bwd": n_layers * TRAIN_S_STEPS,
                "potts_energy": 0, "cnn_ensemble": 0}
        check(all(got[k] == n for k, n in want.items()),
              f"finetune_esm S: kernel launches {got}, not {want}")
        before, after = logged(r"held-out masked CE \w+: (\S+)", out)
        check(np.isfinite([before, after]).all() and after < before,
              f"finetune_esm S: held-out CE {before} -> {after}")
        r = esm_record("finetune_esm S", "transformer-S", tm, out,
                       TRAIN_S_STEPS, 32)
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
              and got["flash_attention_bwd"] >= n_layers * TRAIN_CLI_STEPS,
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
            want = {"flash_attention_fwd": 2 * TRAIN_L_LAYERS * TRAIN_L_STEPS,
                    "flash_attention_bwd": TRAIN_L_LAYERS * TRAIN_L_STEPS}
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
                           TRAIN_L_STEPS, 32)
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
        check(not any(got.values()), f"finetune_msa: a port kernel ran: "
              f"{got}")
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
    counters = {"potts_energy": (potts_fused, "launches"),
                "potts_energy_f32": (potts_fused, "launches_f32"),
                "cnn_ensemble": (cnn_fused, "launches"),
                "cnn_ensemble_f32": (cnn_fused, "launches_f32"),
                "flash_attention_fwd": (attention_fused, "launches_fwd"),
                "flash_attention_bwd": (attention_fused, "launches_bwd")}
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
                  and n["flash_attention_bwd"] == 12 * MESH_TRAIN_STEPS,
                  f"{label}: kernel C / C' launches {n}")
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
    in one configuration at its defaults (``args``): one energy_and_grad
    for the initial state and one a step, over the untimed and the 3 timed
    executions; kernels A and B once a call (bf16) on the GFP configs, C
    and C' once a layer a piece on the transformer config, none on MNIST."""
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.scripts import bench

    if row["domain"] == "mnist":
        return dict.fromkeys(COUNTERS, 0)
    steps = row["steps"]
    n_calls = 1 + (max(1, args.warmup // steps) + bench.REPS) * steps
    attention = 0
    if row["expert"] != "potts":
        chunk = bench.transformer_chunk(row["n_chains"], dev)
        check(row["chunk_size"] == chunk, f"the bench's transformer chunk "
              f"{row['chunk_size']}, expected {chunk}")
        attention = (esm2.CONFIGS["transformer-S"]["layers"]
                     * (-(-row["n_chains"] // chunk) if chunk else 1))
    return bench.expected_launches(dev, n_calls, args.dtype, 1, attention)


def phase_bench(torch, dev, card, ppde_runs):
    """Phase 13: ``python -m ppde_tpu_torch.scripts.bench`` at its
    defaults, in a subprocess (it sets its own counters, which start at 0,
    and reads them around each configuration): exit code 0, one JSON line
    with every key, the four configurations with finite positive rates and
    their checks' numbers, the headline rule, and each kernel's launches
    exactly as ``bench_expected`` says. ``ppde_runs``: ppde.run's steps/s
    of the same configurations in phases 4 and 6, set beside the bench's.
    Returns (the bench's line with the phase's numbers, its launches)."""
    from ppde_tpu_torch.scripts import bench

    args = bench.build_parser().parse_args([])
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ppde_tpu_torch.scripts.bench"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT)
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
                                    potts_fused)
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

    counters = COUNTERS  # every kernel's (wrapper module, attribute)
    phases = {
        "potts": lambda: phase_potts(torch, potts, potts_fused, dev),
        "cnn": lambda: phase_cnn(torch, cnn, cnn_fused, dev),
        "sampler": lambda: phase_sampler(torch, codec, utils, energy_mod,
                                         potts, cnn, ppde, counters, dev,
                                         card),
        "attention": lambda: phase_attention(torch, attention_fused, dev),
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
               if r["chunk_size"] is None}})}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    got = {}
    for name, run in phases.items():
        t = time.perf_counter()
        got[name] = run()
        print(f"phase {name} {time.perf_counter() - t:.1f} s", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    pa, pb, pc = got["potts"], got["cnn"], got["attention"]
    runs, launches = got["sampler"]
    tr_runs, tr_launches = got["transformer"]
    cli_runs, cli_launches = got["cli"]
    eval_runs, eval_launches = got["eval"]
    train_runs, train_launches = got["training"]
    mesh_runs, mesh_launches = got["mesh"]
    bench_line, bench_launches = got["bench"]
    for more in (tr_launches, cli_launches, eval_launches, train_launches,
                 mesh_launches, bench_launches):
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
                "replaces": "ppde_tpu/ops/potts_pallas.py:55",
                "launches": n,
                "max_abs_err": max(a["max_abs_err_grad"], a["max_abs_err_H"]),
                "ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
                "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
                "library_ms": a["library_ms_addmm_grad_only"], "B": a["B"],
                "dtype": a["dtype"]}

    def row_b(name, b, n):
        return {"name": name, "route": "cuda",
                "source": "ppde_tpu_torch/csrc/cnn_ensemble.cu",
                "replaces": "ppde_tpu/ops/cnn_pallas.py:136",
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
    n_a, n_a32 = launches["potts_energy"], launches["potts_energy_f32"]
    n_b, n_b32 = launches["cnn_ensemble"], launches["cnn_ensemble_f32"]
    kernels = {"kernels": [
        row_a("potts_energy", headline(pa, 1024, "bfloat16", W="symmetric"),
              n_a - n_a32),
        row_a("potts_energy_f32", headline(pa, 128, "float32",
                                           W="symmetric"), n_a32),
        row_b("cnn_ensemble", headline(pb, 1024, "bfloat16",
                                       pool_bwd="split"), n_b - n_b32),
        row_b("cnn_ensemble_f32", headline(pb, 128, "float32",
                                           pool_bwd="split"), n_b32),
        attention_row(c, c1, "fwd", launches["flash_attention_fwd"], 83),
        attention_row(c, c1, "bwd", launches["flash_attention_bwd"], 108),
    ]}
    # kernels C and C' by path: the transformer sampler (phase 6), the
    # evaluation's transformer column (phase 10), finetune_esm and the CLI
    # run on its checkpoint (phase 11); finetune_esm's shapes' numbers
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
    # every kernel's launches in phase 13's bench run, by type
    for row in kernels["kernels"]:
        name = row["name"]
        n = bench_launches[name]
        if name in ("potts_energy", "cnn_ensemble"):
            n -= bench_launches[name + "_f32"]
        row.setdefault("launches_by_path", {})["bench"] = n
    check(all(k["launches"] > 0 for k in kernels["kernels"]),
          f"a kernel the main path runs was not launched: {kernels}")
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernel_a": pa,
                   "kernel_b": pb, "sampler": runs, "kernels_c": pc,
                   "transformer_sampler": tr_runs, "cli": cli_runs,
                   "checkpoint": got["checkpoint"], "mnist": got["mnist"],
                   "eval": eval_runs, "training": train_runs,
                   "mesh": mesh_runs, "bench": bench_line, **kernels},
                  f, indent=1)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
