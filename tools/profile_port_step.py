"""Where a PPDE step of ppde_tpu_torch spends its time on the GPU.

    python tools/profile_port_step.py [--chains 128 1024] [--steps 40]
    python tools/profile_port_step.py --transformer

Builds the GFP configuration of chip_smoke.py (synthetic seeded Potts and a
seeded 3-member CNN ensemble, bf16, lambda=15, pas_length=2,
nmut_threshold=10), runs a warm-up, then traces ``--steps`` sampler steps
with torch.profiler and prints one JSON line per population: the step time,
the device time by kernel name (top 12), the device time of the port's own
kernels, the device busy share (the union of kernel intervals over the
traced window) and the card's name and power limit. ``--transformer`` adds
the random-init transformer-S expert (lambda=1, chip_smoke.py's phase 6) and
traces one line per chunking of its gradient (chunks of 16 chains, and one
piece; default 128 chains, 5 steps). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name fragments of the port's hand-written kernels in the trace (kernel A:
# potts_*; kernel B: fit_grad_kernel and cnn_member_reduce; C, C': attn_*)
PORT_KERNELS = ("potts_", "fit_grad_kernel", "cnn_member_reduce", "attn_fwd",
                "attn_bwd_dq", "attn_bwd_dkdv")


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--transformer", action="store_true")
    args = ap.parse_args()
    chains = args.chains or ([128] if args.transformer else [128, 1024])
    steps = args.steps or (5 if args.transformer else 40)
    warmup = 2 if args.transformer else 10

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import GFP_WT, TRANSFORMER_CHUNKS
    from ppde_tpu_torch import codec, energy as energy_mod
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
    pp = potts.synthetic(GFP_WT, seed=0, dtype=torch.bfloat16, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    wt = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
    L, V = wt.shape[1], wt.shape[2]
    window = torch.ones((L, V), dtype=torch.bool, device=dev)
    if args.transformer:
        tr = esm2.load_expert("transformer-S", GFP_WT, allow_random=True,
                              dtype=torch.bfloat16, device=dev)
        energies = [(c, energy_mod.protein_poe(
            pp, ens, lam=1.0, wt_onehot=wt, transformer=tr, chunk_size=c,
            compute_dtype=torch.bfloat16)) for c in TRANSFORMER_CHUNKS]
    else:
        energies = [(None, energy_mod.protein_poe(
            pp, ens, lam=15.0, wt_onehot=wt, compute_dtype=torch.bfloat16))]
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
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    state, _ = step(ctx, state, draws)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        own = {tag: sum(v for k, v in by_name.items() if tag in k)
               / steps / 1e3 for tag in PORT_KERNELS}
        print(json.dumps({
            "n_chains": n, "steps": steps, "transformer": args.transformer,
            "chunk_size": chunk,
            "step_ms": wall_us / steps / 1e3,
            "device_busy_share": busy_share(kernels, wall_us),
            "kernel_launches_per_step": len(kernels) / steps,
            "port_kernels_device_ms_per_step": own,
            "device_ms_per_step_by_kernel": {
                k[:80]: v / steps / 1e3 for k, v in top},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
