#!/usr/bin/env python3
"""The port's multi-device paths on several GPUs, against one GPU.

    torchrun --standalone --nproc_per_node N \
        -m ppde_tpu_torch.scripts.mesh_cards [--out F]

(``--device cpu --steps 4 --chains 8``: a rehearsal over gloo on the CPU,
the kernels' plain versions.)

One process a GPU over nccl (N a multiple of 2 that divides 12, e.g. 2 or
4). Every rank also computes the single-device result itself, so each
check holds the sharded run against one GPU on the same inputs, at GFP
width (L = 237, seeded stand-ins as in chip_smoke.py):

  * the PPDE energy (float32 Potts, 3-member CNN ensemble) through
    ``runtime.apply_mesh`` over dp = N, dp = N/2 x tp = 2 and tp = N
    (kernel A on column blocks), and over ep = 2 with a 4-member
    ensemble: E, fitness and dE/dx of 128 mutated chains within rtol 1e-5
    / atol 1e-4 (dp alone: bit for bit); then the PPDE sampler from the
    wild type, 128 chains, 60 steps: over dp alone every array bit for
    bit; over tp or ep, where the float32 sums run in another order, the
    rows of best_x equal to the single device's are counted and the best
    energies' largest difference reported (a proposal at the acceptance
    threshold can go the other way);
  * the potts + transformer-S energy and its gradient in float32 over tp
    = N (Megatron heads) and sp = N (sequence): rtol / atol 2e-4;
  * the transformer-S pipeline over pp = N (GPipe, send / recv over nccl):
    logits and dPLL/dx against ``esm2``'s single-device forward, 1e-4;
  * ``train_esm_mlm`` at transformer-S in float32 over dp = N, 4 steps:
    the weights within rtol 2e-4, atol 1e-5.

Rank 0 prints one JSON line per check and writes them to ``--out``; the
script exits non-zero if a check fails. It times nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ppde_tpu_torch import codec, energy as energy_mod, runtime
from ppde_tpu_torch.models import cnn, esm2, potts
from ppde_tpu_torch.parallel import mesh as pmesh, pipeline
from ppde_tpu_torch.samplers.protein import ppde

GFP_WT = (
    "SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTLSYGVQCFSRY"
    "PDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNS"
    "HNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVL"
    "LEFVTAAGITHGMDELYK"
)


def close(a, b, rtol, atol):
    a, b = (np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)
            for t in (a, b))
    return bool(np.allclose(a, b, rtol=rtol, atol=atol)), float(
        np.abs(a - b).max())


def energy(dev, members=3, transformer=None):
    pp = potts.synthetic(GFP_WT, seed=0, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0),
                            members, input_size=len(GFP_WT))
    wt = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(dev)
    return energy_mod.protein_poe(pp, ens, 15.0, wt,
                                  transformer=transformer), wt


def run_ppde(en, pop, dev, steps):
    return ppde.run(en, pop, steps, 0, len(GFP_WT) - 1,
                    cfg=ppde.PPDEConfig(pas_length=2, nmut_threshold=10),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    log_every=20, quiet=True, device=dev)


def mutated(wt, n, dev, seed=5):
    """n copies of the wild type with 0-9 random mutations a row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = wt.repeat(n, 1, 1).clone()
    L = x.shape[1]
    for i in range(n):
        pos = torch.randperm(L, generator=gen, device=dev)[:i % 10]
        aa = torch.randint(0, 20, (len(pos),), generator=gen, device=dev)
        x[i, pos] = torch.nn.functional.one_hot(aa, 20).float()
    return x


def check_sampler(n, dev, args):
    out = []
    for members, kw in ((3, dict(dp=n)), (3, dict(dp=n // 2, tp=2)),
                        (3, dict(dp=1, tp=n)), (4, dict(dp=n // 2, ep=2))):
        en, wt = energy(dev, members)
        dp_only = list(kw) == ["dp"]
        _, en_sh, _ = runtime.apply_mesh(en, wt.repeat(args.chains, 1, 1),
                                         **kw)
        x = mutated(wt, args.chains, dev)
        ref = en.energy_and_grad(en.params, x)
        got = en_sh.energy_and_grad(en_sh.params, x)
        oks = [(bool(torch.equal(a, b)), float((a - b).abs().max()))
               if dp_only else close(a, b, 1e-5, 1e-4)
               for a, b in zip(got, ref)]
        out.append({"check": "ppde energy and gradient", "mesh": kw,
                    "members": members, "ok": all(o for o, _ in oks),
                    "max_abs_err": [err for _, err in oks]})
        pop = wt.repeat(args.chains, 1, 1)
        r0 = run_ppde(en, pop, dev, args.steps)
        r1 = run_ppde(en_sh, pop, dev, args.steps)
        rows = int((r1.best_x == r0.best_x).all(axis=(1, 2)).sum())
        row = {"check": "ppde run", "mesh": kw, "members": members,
               "steps": args.steps, "chains": args.chains,
               "best_x_rows_equal": rows,
               "max_abs_err_best_energy": float(
                   np.abs(r1.best_energy - r0.best_energy).max()),
               "ok": True}
        if dp_only:
            row["ok"] = all(np.array_equal(getattr(r1, k), getattr(r0, k))
                            for k in ("best_x", "best_energy",
                                      "energy_history", "final_x"))
        out.append(row)
    return out


def check_transformer(n, dev, args):
    out = []
    tr = esm2.load_expert("transformer-S", GFP_WT, allow_random=True,
                          dtype=torch.float32, device=dev)
    en, wt = energy(dev, transformer=tr)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, 20, (min(16, args.chains), len(GFP_WT)),
                         generator=gen, device=dev)
    x = torch.nn.functional.one_hot(toks, 20).float()
    e0, f0, g0 = en.energy_and_grad(en.params, x)
    for kw in (dict(dp=1, tp=n), dict(dp=1, sp=n)):
        _, en_sh, _ = runtime.apply_mesh(en, x, **kw)
        e, f, g = en_sh.energy_and_grad(en_sh.params, x)
        oks = [close(a, b, 2e-4, 2e-4) for a, b in ((e, e0), (f, f0),
                                                    (g, g0))]
        out.append({"check": "transformer energy and gradient", "mesh": kw,
                    "ok": all(o for o, _ in oks),
                    "max_abs_err": [err for _, err in oks]})
    esm2.SP_CONSTRAIN = None
    return out


def check_pipeline(n, dev, args):
    params = esm2.init(torch.Generator(device=dev).manual_seed(3),
                       "transformer-S", torch.float32)
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(4, 24, (2 * n, 64), generator=gen, device=dev)
    x = torch.nn.functional.one_hot(toks, esm2.ESM_VOCAB).float()
    mesh = pmesh.make_mesh(dp=1, pp=n, device=dev)
    pparams = pipeline.pipeline_params(params, n)
    xg = x.clone().requires_grad_(True)
    pll = pipeline.pseudo_log_likelihood_pp(pparams, xg, mesh, heads=20)
    (g,) = torch.autograd.grad(pll.sum(), xg)
    xg = x.clone().requires_grad_(True)
    ref = esm2.pseudo_log_likelihood(params, xg, 20)
    (g0,) = torch.autograd.grad(ref.sum(), xg)
    oks = [close(pll, ref, 1e-4, 1e-4), close(g, g0, 1e-4, 1e-4)]
    return [{"check": "pipeline PLL and dPLL/dx", "mesh": {"pp": n},
             "ok": all(o for o, _ in oks),
             "max_abs_err": [err for _, err in oks]}]


def check_training(n, dev, args):
    from ppde_tpu_torch import training

    rng = np.random.default_rng(0)
    seqs = [GFP_WT]
    for _ in range(63):
        s = list(GFP_WT)
        for i in rng.choice(len(GFP_WT), size=3, replace=False):
            s[i] = "ACDEFGHIKLMNPQRSTVWY"[rng.integers(20)]
        seqs.append("".join(s))
    kw = dict(name="transformer-S", n_iters=4, batch_size=4 * n, warmup=1,
              quiet=True, compute_dtype=torch.float32, device=dev)
    ref = training.train_esm_mlm(seqs, **kw)
    got = training.train_esm_mlm(seqs, mesh=pmesh.make_mesh(dp=n,
                                                            device=dev), **kw)
    oks = [close(a, b, 2e-4, 1e-5) for a, b in zip(esm2._flatten(got),
                                                   esm2._flatten(ref))]
    return [{"check": "train_esm_mlm", "mesh": {"dp": n},
             "ok": all(o for o, _ in oks),
             "max_abs_err": max(err for _, err in oks)}]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--chains", type=int, default=128)
    args = ap.parse_args()
    dev = pmesh.init_distributed(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = torch.distributed.get_world_size()
    if n < 2 or n % 2 or 12 % n:
        raise SystemExit(f"needs 2, 4, 6 or 12 ranks, got {n}")
    rows = [{"check": "backend", "backend": torch.distributed.get_backend(),
             "world_size": n,
             "ok": torch.distributed.get_backend()
             == pmesh.backend_for(dev.type)}]
    for fn in (check_sampler, check_transformer, check_pipeline,
               check_training):
        rows += fn(n, dev, args)
    if pmesh.is_lead():
        for r in rows:
            print(json.dumps(r), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    torch.distributed.destroy_process_group()
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
