"""Where a PPDE step of ppde_tpu_torch spends its time on the GPU.

    python tools/profile_port_step.py [--chains 128 1024] [--steps 40]

Builds the GFP configuration of chip_smoke.py (synthetic seeded Potts and a
seeded 3-member CNN ensemble, bf16, lambda=15, pas_length=2,
nmut_threshold=10), runs a warm-up, then traces ``--steps`` sampler steps
with torch.profiler and prints one JSON line per population: the step time,
the device time by kernel name (top 12), the device busy share (the union of
kernel intervals over the traced window) and the card's name and power
limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    ap.add_argument("--chains", type=int, nargs="+", default=[128, 1024])
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import GFP_WT
    from ppde_tpu_torch import codec, energy as energy_mod
    from ppde_tpu_torch.models import cnn, potts
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
    en = energy_mod.protein_poe(pp, ens, lam=15.0, wt_onehot=wt,
                                compute_dtype=torch.bfloat16)
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
    L, V = wt.shape[1], wt.shape[2]
    window = torch.ones((L, V), dtype=torch.bool, device=dev)
    for n in args.chains:
        x0 = wt.repeat(n, 1, 1)
        with torch.no_grad():
            e0, f0, g0 = en.energy_and_grad(en.params, x0)
            ctx = {"energy": en.params, "wt": x0[0], "init_x": x0,
                   "wt_e": e0[0], "wt_fit": f0[0], "wt_grad": g0[0]}
            step = ppde.make_step(en, cfg, window, n, L, V)
            draws = ppde.Draws(torch.Generator(device=dev).manual_seed(1))
            state = (x0, (e0, f0, g0), (e0, f0, x0))
            for _ in range(10):  # warm-up: first launches, allocator
                state, _ = step(ctx, state, draws)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    state, _ = step(ctx, state, draws)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "n_chains": n, "steps": args.steps,
            "step_ms": wall_us / args.steps / 1e3,
            "device_busy_share": busy_share(kernels, wall_us),
            "kernel_launches_per_step": len(kernels) / args.steps,
            "device_ms_per_step_by_kernel": {
                k[:80]: v / args.steps / 1e3 for k, v in top},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
