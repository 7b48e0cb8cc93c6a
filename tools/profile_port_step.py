"""Where a PPDE step of ppde_tpu_torch spends its time on the GPU.

    python tools/profile_port_step.py [--chains 128 1024] [--steps 40]
    python tools/profile_port_step.py --transformer [transformer-M]
    python tools/profile_port_step.py --kernels
    python tools/profile_port_step.py --phases
    python tools/profile_port_step.py --potts_dtype f32 --cnn_dtype f32
    python tools/profile_port_step.py --msat
    python tools/profile_port_step.py --train

Builds the GFP configuration of chip_smoke.py (synthetic seeded Potts and a
seeded 3-member CNN ensemble, bf16, lambda=15, pas_length=2,
nmut_threshold=10; ``--potts_dtype f32 --cnn_dtype f32`` gives the CLI's
default types), runs a warm-up, then traces ``--steps`` sampler steps
with torch.profiler and prints one JSON line per population: the step time,
the device time by kernel name (top 12), the device time by the program's
spans (``profiling.device_by_span``: the port's kernels by their wrappers'
spans ``kernel.*``, ESM2 by block kind, the sampler's work) and the
kernels a step by the same spans, the device busy
share (the union of kernel intervals over the
traced window) and the card's name and power limit. ``--transformer
[NAME]`` adds the random-init ESM2 expert NAME at full width and depth
(default transformer-S; lambda=1, chip_smoke.py's phases 6 and 14) and
traces one line per chunking of its gradient (transformer-S: chunks of 16
chains, as phase 6; the larger experts: chunks of 64, as their drivers
give them; and one piece; default 128 chains, 5 steps), with the model's
share of the bf16 peak (2 forwards a step). ``--kernels`` traces kernels A and B
alone at GFP width (bf16 and float32, B = 128 and 1024) beside
``torch.addmm``, and
kernels C and C' at the transformer path's calls (bf16, (Z, T, hd) =
(320, 237, 24) and (2560, 237, 24)) beside scaled_dot_product_attention:
device microseconds per call by kernel name. ``--phases`` builds kernel B
with -DCNN_PHASE_CLOCKS and prints the clocks and microseconds each phase of
one (sample, member) takes in block (0, 0), bf16 and float32, at B = 128
and 1024; then for the wide kernels at L = 400 and 1022 (C = L, 128
samples) the clocks of the forward's block (0, 0, 0) (one column tile of
one (sample, member)) and of the backward's block (0, 0), and their
microseconds at the card's maximum SM clock. ``--msat`` traces one batch
of masked columns of the MSA Transformer as chip_smoke.py's phase 10
scores them (random-init msa-1b,
bf16, 500 rows of the GFP synthetic alignment, 4 columns a forward): the
device time a column by class of kernel (matrix products, softmax, layer
norm, GELU, the rest) and by name, and the busy share. ``--train`` traces
steps of ``training.train_esm_mlm`` as chip_smoke.py's phase 11 runs it
(batch 32 of the GFP synthetic alignment in wild-type context, bf16
compute): transformer-S, and transformer-L cut to 4 layers with LoRA
rank 8; after 5 warm-up steps, 10 traced steps: the step time, the
launches a step, the busy share, the device time by class and by name.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spans of the port's kernel wrappers (profiling.py): a kernel's time
# is the device work launched inside its wrapper's span
PORT_KERNELS = ("kernel.a", "kernel.b", "kernel.c", "kernel.c_bwd")
# kernels C and C' at the transformer path's calls: chunks of 16 chains and
# one piece (ESM2-S: 20 heads, T = 237 for GFP, hd = 24)
ATTN_SHAPES = ((320, 237, 24), (2560, 237, 24))


def busy_share(events, window_us):
    """Union of device-kernel intervals over the traced window."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / window_us


def gfp_kernel_inputs(torch, dev, B, dtype=None):
    """Kernel A's and B's inputs at GFP width: Potts couplings and ensemble
    prepared in ``dtype`` (default bf16), B random one-hot sequences (all
    seeded)."""
    from chip_smoke import GFP_WT, random_onehot
    from ppde_tpu_torch.models import cnn, potts
    from ppde_tpu_torch.ops import cnn_fused, potts_fused

    dtype = dtype or torch.bfloat16
    pp = potts.synthetic(GFP_WT, seed=0, dtype=dtype, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    x = random_onehot(torch, torch.Generator(device=dev).manual_seed(12), B,
                      len(GFP_WT), dev)
    return (pp, potts_fused.prepare(pp.W, pp.h),
            potts._pad_flat(pp, x, torch.bfloat16),
            cnn_fused.prepare_ensemble(ens, dtype), x)


def us_by_kernel(torch, fn, reps=20):
    """Device microseconds per call of fn, by kernel name (torch.profiler
    over reps calls after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")[:70]
            by_name[name] = by_name.get(name, 0.0) + e.device_time / reps
    return by_name


def trace_kernels(torch, dev, card) -> None:
    """Device time by kernel name of one call of each wrapper: A and B
    beside torch.addmm on A's inputs at GFP width, C and C' beside
    scaled_dot_product_attention (forward, and forward + backward) at the
    transformer path's shapes in bf16."""
    from ppde_tpu_torch.ops import attention_fused, cnn_fused, potts_fused

    for B, dtype in itertools.product((128, 1024),
                                      (torch.bfloat16, torch.float32)):
        pp, pa, xf, prep, x = gfp_kernel_inputs(torch, dev, B, dtype)
        xw = xf.to(dtype)
        calls = {"kernel_a": lambda: potts_fused.energy_and_grad(pa, None,
                                                                 xf),
                 "addmm": lambda: torch.addmm(pp.h, xw, pp.W),
                 "kernel_b": lambda: cnn_fused.ensemble_apply_and_grad(prep,
                                                                       x)}
        out = {"B": B, "dtype": str(dtype), "card": card}
        for name, fn in calls.items():
            out[name + "_us_by_kernel"] = us_by_kernel(torch, fn)
        print(json.dumps(out), flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for Z, T, hd in ATTN_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(Z + T + hd)
        q, k, v, dout = ((torch.randn((Z, T, hd), generator=gen, device=dev)
                          * 0.5).to(torch.bfloat16) for _ in range(4))
        qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        calls = {"kernel_c": lambda: attention_fused.flash_attention(q, k, v),
                 "kernel_c_bwd": lambda: attention_fused.flash_attention_bwd(
                     q, k, v, dout),
                 "sdpa": lambda: sdpa(q, k, v, scale=1.0),
                 "sdpa_fwd_bwd": lambda: torch.autograd.grad(
                     sdpa(*qs, scale=1.0), qs, dout)}
        out = {"Z": Z, "T": T, "hd": hd, "card": card}
        for name, fn in calls.items():
            out[name + "_us_by_kernel"] = us_by_kernel(torch, fn)
        print(json.dumps(out), flush=True)


# classes of the MSA Transformer's kernels by name fragment (the first that
# matches; "other" is the elementwise passes, casts and copies)
MSAT_CLASSES = (("matmul", ("gemm", "cutlass", "xmma", "nvjet", "sm90_")),
                ("softmax", ("softmax",)),
                ("layer_norm", ("layer_norm", "ln_fwd_", "ln_bwd_",
                                "ln_affine")),
                ("gelu", ("gelu",)))


def trace_msat(torch, dev, card, reps=2) -> None:
    """Device time of masked_marginals at chip_smoke.py's phase 10 size."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import EVAL_MSA, EVAL_MSA_SIZE, EVAL_MSAT, GFP_WT
    from ppde_tpu_torch import io as pio
    from ppde_tpu_torch.models import msa_transformer as msat

    msa = pio.load_msa(os.path.join(ROOT, EVAL_MSA))
    idxs = np.random.default_rng(0).choice(
        len(msa), size=EVAL_MSA_SIZE - 1, replace=False)
    rows = [msa[i][1] for i in idxs]
    params = msat.load(None, allow_random=True, name=EVAL_MSAT, device=dev)
    cols = [10, 60, 110, 160]

    def fn():
        return msat.masked_marginals(params, GFP_WT, rows, cols,
                                     heads=msat.heads_of(EVAL_MSAT))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n_cols = reps * len(cols)
    by_name: dict[str, float] = {}
    by_class: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        cls = next((c for c, frags in MSAT_CLASSES
                    if any(f in e.name.lower() for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "scorer": EVAL_MSAT, "rows": EVAL_MSA_SIZE, "tokens": len(GFP_WT) + 1,
        "columns_per_forward": len(cols),
        "wall_ms_per_column": wall_us / n_cols / 1e3,
        "device_ms_per_column": sum(by_class.values()) / n_cols / 1e3,
        "device_busy_share": busy_share(kernels, wall_us),
        "launches_per_column": len(kernels) / n_cols,
        "device_ms_per_column_by_class": {
            k: v / n_cols / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
        "device_ms_per_column_by_kernel": {
            k[:80]: v / n_cols / 1e3 for k, v in top},
        "card": card}), flush=True)


def trace_phases(torch, dev, card) -> None:
    """Clocks of each phase of kernel B per (sample, member), read from a
    build with -DCNN_PHASE_CLOCKS, at GFP width: bf16 and float32, B = 128
    and 1024."""
    import ctypes
    from ppde_tpu_torch.ops import _build, cnn_fused

    # the wrapper then builds and launches the profiling build
    _build.set_defines("cnn_ensemble", ("CNN_PHASE_CLOCKS",))
    lib = cnn_fused._lib()
    lib.cnn_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cnn_phase_clocks.restype = ctypes.c_int
    for B, dtype in itertools.product((128, 1024),
                                      (torch.bfloat16, torch.float32)):
        phases_of(torch, dev, card, lib, B, dtype)
    for L, dtype in itertools.product(WIDE_LENGTHS,
                                      (torch.bfloat16, torch.float32)):
        wide_phases_of(torch, dev, card, lib, L, dtype)


# the wide kernels' lengths (C = L): chip_smoke.py's phase 3 and 16
WIDE_LENGTHS = (400, 1022)
WIDE_FORWARD = {"conv": 1, "embed_product": 2, "pool": 3}
WIDE_BACKWARD = {"tokens_and_routes": 0, "pred_and_scales": 4,
                 "gather_g1": 5, "dp_product": 6, "col2im_store": 7}


def wide_phases_of(torch, dev, card, lib, L, dtype) -> None:
    """One line of ``trace_phases`` for the wide kernels: 128 random
    sequences of L residues, a seeded 3-member ensemble of width C = L."""
    import ctypes
    from chip_smoke import random_onehot
    from ppde_tpu_torch.models import cnn
    from ppde_tpu_torch.ops import cnn_fused

    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(L), 3,
                            input_size=L)
    x = random_onehot(torch, torch.Generator(device=dev).manual_seed(L + 1),
                      128, L, dev)
    prep = cnn_fused.prepare_ensemble(ens, dtype)
    w0 = cnn_fused.launches_wide
    cnn_fused.ensemble_apply_and_grad(prep, x)
    if cnn_fused.launches_wide != w0 + 1:
        raise RuntimeError(f"L={L}: not the wide kernel")
    torch.cuda.synchronize()
    if lib.cnn_phase_clocks(None, 1):
        raise RuntimeError("cnn_phase_clocks: reset failed")
    cnn_fused.ensemble_apply_and_grad(prep, x)
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * 8)()
    if lib.cnn_phase_clocks(clocks, 0):
        raise RuntimeError("cnn_phase_clocks: read failed")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    M, K, V, C, C2 = prep.dims
    ncol = -(-C2 // cnn_fused.wide_cols(C2, dtype))
    out = {"L": L, "C": C, "B": 128, "dtype": str(dtype),
           "column_tiles": ncol, "row_tiles": -(-(L - K + 1)
                                               // cnn_fused.WIDE_ROWS),
           "max_sm_clock_mhz": mhz, "card": card}
    for part, names in (("forward_block", WIDE_FORWARD),
                        ("backward_block", WIDE_BACKWARD)):
        out[f"clocks_{part}"] = {n: clocks[i] for n, i in names.items()}
        out[f"us_{part}_at_max_clock"] = {n: clocks[i] / mhz
                                          for n, i in names.items()}
    print(json.dumps(out), flush=True)


def phases_of(torch, dev, card, lib, B, dtype) -> None:
    """One line of ``trace_phases``: B samples, the ensemble in dtype."""
    import ctypes
    from ppde_tpu_torch.ops import cnn_fused

    *_, prep, x = gfp_kernel_inputs(torch, dev, B, dtype)
    cnn_fused.ensemble_apply_and_grad(prep, x)
    torch.cuda.synchronize()
    if lib.cnn_phase_clocks(None, 1):
        raise RuntimeError("cnn_phase_clocks: reset failed")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cnn_fused.ensemble_apply_and_grad(prep, x)
    end.record()
    torch.cuda.synchronize()
    call_us = start.elapsed_time(end) * 1e3
    clocks = (ctypes.c_longlong * 8)()
    if lib.cnn_phase_clocks(clocks, 0):
        raise RuntimeError("cnn_phase_clocks: read failed")
    M = prep.dims[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = max(1, min(B, sms // M))          # the kernel's grid.x
    samples = (B - 1) // per + 1            # walked by block (0, 0)
    # block (0, 0) lives as long as the call: its clocks over the call's time
    mhz = sum(clocks) / call_us
    names = ("fetch_and_clear", "conv", "embed_product", "pool",
             "pred_and_scales", "gather_g1", "dp_product", "col2im_store")
    per_sample = {n: c / samples for n, c in zip(names, clocks)}
    out = {"B": B, "dtype": str(dtype), "samples_of_block_0": samples,
           "call_us": call_us,
           "sm_clock_mhz_estimate": mhz,
           "clocks_per_sample_member": per_sample,
           "us_per_sample_member": {n: c / mhz
                                    for n, c in per_sample.items()},
           "card": card}
    print(json.dumps(out), flush=True)


def trace_train(torch, dev, card, warmup=5, steps=10) -> None:
    """Device time of train_esm_mlm's steps (phase 11's runs)."""
    from torch.profiler import (ProfilerActivity, profile,
                                schedule as prof_schedule)

    from chip_smoke import EVAL_MSA, GFP_WT, TRAIN_L_LAYERS, esm_train_flops
    from ppde_tpu_torch import io as pio, training
    from ppde_tpu_torch.models import esm2
    from ppde_tpu_torch.scripts.finetune_esm import family_in_wt_context

    path = os.path.join(ROOT, EVAL_MSA)
    seqs = family_in_wt_context(pio.load_msa(path), path, GFP_WT)
    full_l = esm2.CONFIGS["transformer-L"]
    adam_step = training.Adam.step
    for name, kw in (("transformer-S", {}),
                     ("transformer-L", {"lora_rank": 8})):
        marks = []
        sched = prof_schedule(wait=warmup - 1, warmup=1, active=steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            def traced_step(self, grads):
                adam_step(self, grads)
                if self.count in (warmup, warmup + steps):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                prof.step()

            training.Adam.step = traced_step
            if kw:  # transformer-L cut to phase 11's depth
                esm2.CONFIGS[name] = dict(full_l, layers=TRAIN_L_LAYERS)
            try:
                training.train_esm_mlm(seqs, name=name,
                                       n_iters=warmup + steps, quiet=True,
                                       device=dev, **kw)
                layers = esm2.CONFIGS[name]["layers"]
                flops = esm_train_flops(name, 32, len(GFP_WT))
            finally:
                training.Adam.step = adam_step
                esm2.CONFIGS["transformer-L"] = full_l
        wall_us = (marks[1] - marks[0]) * 1e6
        # the schedule's ProfilerStep spans also show on the device lane
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
        by_name: dict[str, float] = {}
        by_class: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
            cls = next((c for c, frags in TRAIN_CLASSES
                        if any(f in e.name.lower() for f in frags)), "other")
            by_class[cls] = by_class.get(cls, 0.0) + e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        device_us = sum(by_class.values()) / steps
        print(json.dumps({
            "model": name, "layers": layers,
            "lora_rank": kw.get("lora_rank", 0), "batch": 32,
            "T": len(GFP_WT), "steps": steps,
            "step_ms": wall_us / steps / 1e3,
            "device_ms_per_step": device_us / 1e3,
            "device_busy_share": busy_share(kernels, wall_us),
            "launches_per_step": len(kernels) / steps,
            "model_tflop_per_step": flops / 1e12,
            "bf16_peak_share_of_device_time": flops / 989e12
            / max(device_us * 1e-6, 1e-12),
            "device_ms_per_step_by_class": {
                k: v / steps / 1e3 for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])},
            "device_ms_per_step_by_kernel": {
                k[:80]: v / steps / 1e3 for k, v in top},
            "card": card}), flush=True)


# kernel-name fragments of a training step's classes of work
TRAIN_CLASSES = (
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                         "ampere", "splitk")),
    ("kernels C, C'", ("attn_",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions, softmax, layer norm", ("reduce", "softmax", "norm",
                                         "ln_fwd_", "ln_bwd_", "ln_affine")),
    ("elementwise, copies, casts", ("elementwise", "copy", "cat")),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--transformer", nargs="?", const="transformer-S",
                    default=None, metavar="NAME",
                    help="an ESM2 expert (esm2.CONFIGS key)")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--msat", action="store_true")
    ap.add_argument("--train", action="store_true")
    # the types of the Potts model and of the CNN; the CLI's defaults are
    # f32 and f32 (its --compute_dtype bf16 makes the CNN bf16)
    ap.add_argument("--potts_dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--cnn_dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    chains = args.chains or ([128] if args.transformer else [128, 1024])
    steps = args.steps or (5 if args.transformer else 40)
    warmup = 2 if args.transformer else 10

    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import (GFP_WT, LARGE_CHUNK, PEAK_OPS, TRANSFORMER_CHUNKS,
                            esm_forward_flops)
    from ppde_tpu_torch import codec, energy as energy_mod, profiling
    from ppde_tpu_torch.models import cnn, esm2, potts
    from ppde_tpu_torch.ops import _build
    from ppde_tpu_torch.samplers.protein import ppde

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.msat:
        trace_msat(torch, dev, card)
        return 0
    if args.train:
        trace_train(torch, dev, card)
        return 0
    if args.kernels or args.phases:
        if args.kernels:
            trace_kernels(torch, dev, card)
        if args.phases:
            trace_phases(torch, dev, card)
        return 0
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    cdt = types[args.cnn_dtype]
    pp = potts.synthetic(GFP_WT, seed=0, dtype=types[args.potts_dtype],
                         device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    wt = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
    L, V = wt.shape[1], wt.shape[2]
    window = torch.ones((L, V), dtype=torch.bool, device=dev)
    if args.transformer:
        tr = esm2.load_expert(args.transformer, GFP_WT, allow_random=True,
                              dtype=torch.bfloat16, device=dev)
        chunks = (TRANSFORMER_CHUNKS if args.transformer == "transformer-S"
                  else (LARGE_CHUNK, None))
        energies = [(c, energy_mod.protein_poe(
            pp, ens, lam=1.0, wt_onehot=wt, transformer=tr, chunk_size=c,
            compute_dtype=cdt)) for c in chunks]
    else:
        energies = [(None, energy_mod.protein_poe(
            pp, ens, lam=15.0, wt_onehot=wt, compute_dtype=cdt))]
    for (chunk, en), n in ((e, n) for e in energies for n in chains):
        x0 = wt.repeat(n, 1, 1)
        with torch.no_grad():
            e0, f0, g0 = en.energy_and_grad(en.params, x0)
            ctx = {"energy": en.params, "wt": x0[0], "init_x": x0,
                   "wt_e": e0[0], "wt_fit": f0[0], "wt_grad": g0[0]}
            step = ppde.make_step(en, cfg, window, n, L, V)
            draws = ppde.Draws(torch.Generator(device=dev).manual_seed(1))
            state = (x0, (e0, f0, g0), (e0, f0, x0))
            for _ in range(warmup):  # first launches, allocator
                state, _ = step(ctx, state, draws)
            torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                with profiling.trace(tmp) as prof:
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        state, _ = step(ctx, state, draws)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                by_span = profiling.device_by_span(tmp)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        unmatched = by_span.pop("unmatched")
        spans = {str(k): v["us"] / steps / 1e3 for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1]["us"])}
        own = {k: spans.get(k, 0.0) for k in PORT_KERNELS}
        share = None
        if args.transformer:
            flops = 2 * esm_forward_flops(args.transformer, L) * n
            share = flops * steps / (wall_us / 1e6) / PEAK_OPS["bfloat16"]
        print(json.dumps({
            "n_chains": n, "steps": steps, "transformer": args.transformer,
            "model_bf16_peak_share": share,
            "potts_dtype": args.potts_dtype, "cnn_dtype": args.cnn_dtype,
            "chunk_size": chunk,
            "step_ms": wall_us / steps / 1e3,
            "device_busy_share": busy_share(kernels, wall_us),
            "kernel_launches_per_step": len(kernels) / steps,
            "port_kernels_device_ms_per_step": own,
            "device_ms_per_step_by_span": spans,
            "kernels_per_step_by_span": {
                str(k): v["kernels"] / steps for k, v in by_span.items()},
            "unmatched_launches": unmatched,
            "device_ms_per_step_by_kernel": {
                k[:80]: v / steps / 1e3 for k, v in top},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
