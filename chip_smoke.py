#!/usr/bin/env python3
"""Drive ppde_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises; the script then exits non-zero and prints
no result line):
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. kernel A (fused Potts energy + gradient) against its plain version at
     GFP width (P = 4864), B in {128, 1024, 1000}, float32 and bfloat16;
  3. kernel B (fused CNN-ensemble fitness + input gradient) against its
     plain version at GFP width (M=3, C=237, L=237), same batches and types,
     both max-pool backward modes, plus an input with exact ties;
  4. the PPDE-PAS sampler on GFP with the Potts + CNN-ensemble energy
     (synthetic seeded Potts, seeded 3-member ensemble, bf16, lambda=15,
     pas_length=2, nmut_threshold=10): 128 chains and 1024 chains. The
     kernels' launch counters are set to 0 just before and read just after;
  5. kernels C and C' (attention forward and backward) against their plain
     versions at ESM2's head shapes, float32 and bfloat16, each run twice
     (bit-for-bit repeatable), timed beside the plain version and
     scaled_dot_product_attention;
  6. the same sampler with the potts + transformer-S product of experts
     (random-init ESM2 at full width and depth, bf16, lambda=1): 128 chains
     with the transformer's gradient in chain chunks of 16 and in one
     piece; counters as in 4.
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.
Detailed results go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

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
SAMPLER_RUNS = ((128, 300, 100), (1024, 40, 20))   # chains, steps, log_every
# (Z, T, hd) of kernels C and C': the transformer path's calls at chunk 16
# and in one piece (ESM2-S: 20 heads, hd 24), the M and L head widths, the
# longest T, and a small ragged case
ATTN_CASES = ((320, 237, 24), (2560, 237, 24), (320, 237, 32),
              (320, 237, 64), (20, 512, 64), (7, 33, 16))
TRANSFORMER_RUN = (128, 40, 20)                    # chains, steps, log_every
TRANSFORMER_CHUNKS = (16, None)


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def time_ms(fn, reps):
    """Mean milliseconds of fn over reps launches, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    """Kernel A vs plain at GFP width."""
    p32 = potts.synthetic(GFP_WT, seed=0, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    P = p32.padded_dim
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        W, h = p32.W.to(dtype), p32.h.to(dtype)
        s = W.element_size()
        for B in BATCHES:
            x = random_onehot(torch, gen, B, len(GFP_WT), dev)
            xf = potts._pad_flat(p32, x)
            H, g = potts_fused.energy_and_grad(W, h, xf)
            H0, g0 = potts_fused.energy_and_grad_plain(W, h, xf)
            torch.cuda.synchronize()
            err_g = (g - g0).abs().max().item()
            err_H = (H - H0).abs().max().item()
            rel_H = ((H - H0).abs() / H0.abs().clamp_min(1.0)).max().item()
            # float32 sums in another order; products with one-hots exact
            check(torch.allclose(g, g0, rtol=1e-5, atol=1e-4),
                  f"kernel A grad B={B} {dtype}: max abs err {err_g}")
            check(torch.allclose(H, H0, rtol=1e-5, atol=1e-3),
                  f"kernel A energy B={B} {dtype}: max abs err {err_H}")
            H2, _ = potts_fused.energy_and_grad(W, h, xf)
            check(torch.equal(H, H2), "kernel A energy is not deterministic")
            reps = 20 if B <= 128 else 5
            ms = time_ms(lambda: potts_fused.energy_and_grad(W, h, xf), reps)
            plain = time_ms(
                lambda: potts_fused.energy_and_grad_plain(W, h, xf), reps)
            xs = xf.to(dtype)
            lib = time_ms(lambda: torch.addmm(h, xs, W), reps)
            # bytes: each input read once (xf, W, h), outputs written once
            # (grad, H); operations: the multiply-adds this one-hot input
            # needs (2 per nonzero of xf per column of W)
            nnz = int(torch.count_nonzero(xf).item())
            n_bytes = (B * P + P * P + P) * s + (B * P + B) * 4
            bms, by = bound_ms(n_bytes, 2 * nnz * P + 4 * B * P,
                               str(dtype).split(".")[-1])
            out.append({"B": B, "dtype": str(dtype).split(".")[-1],
                        "max_abs_err_grad": err_g, "max_abs_err_H": err_H,
                        "max_rel_err_H": rel_H, "tol": "rtol 1e-5, atol "
                        "1e-4 (grad) / 1e-3 (H)", "kernel_ms": ms,
                        "plain_ms": plain, "library_ms_addmm_grad_only": lib,
                        "bound_ms": bms, "bound_by": by,
                        "dense_ops_bound_ms": 2 * B * P * P / PEAK_OPS[
                            str(dtype).split(".")[-1]] * 1e3})
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
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        w_bytes = M * (K * V * C + C * C2 + C2) * s + M * (C + C2 + 1) * 4
        for pool in ("split", "first"):
            for name, x in inputs:
                B = x.shape[0]
                fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, dtype,
                                                            pool)
                fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(
                    ens, x, dtype, pool)
                torch.cuda.synchronize()
                res = cnn_compare(torch, fit, dx, fit0, dx0, dn)
                check(res["ok"], f"kernel B B={name} {dn} {pool}: {res}")
                fit2, dx2 = cnn_fused.ensemble_apply_and_grad(ens, x, dtype,
                                                              pool)
                check(torch.equal(fit, fit2) and torch.equal(dx, dx2),
                      "kernel B is not deterministic")
                if name == "128-ties" and pool == "first":
                    _, dx_split = cnn_fused.ensemble_apply_and_grad(
                        ens, x, dtype, "split")
                    check(not torch.allclose(dx, dx_split),
                          "tie input: split and first routing agree")
                reps = 3 if B <= 128 else 2
                ms = time_ms(lambda: cnn_fused.ensemble_apply_and_grad(
                    ens, x, dtype, pool), reps)
                plain = time_ms(
                    lambda: cnn_fused.ensemble_apply_and_grad_plain(
                        ens, x, dtype, pool), reps)
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


def check_run(torch, en, res, cfg, wt_oh, steps, n_chains, chunk, dev):
    """The checks every sampler run must pass; returns its numbers. The
    fresh evaluation of the best states goes through ``en.energy`` in chain
    chunks of ``chunk`` (None: one piece), the shapes the run itself used."""
    check(np.isfinite(res.energy_history).all(), "non-finite energies")
    check(np.isfinite(res.best_energy).all(), "non-finite best energy")
    wt = wt_oh[0].cpu().numpy()
    d_final = (res.final_x != wt[None]).any(-1).sum(-1)
    d_best = (res.best_x != wt[None]).any(-1).sum(-1)
    check(d_final.max() < cfg.nmut_threshold,
          f"final distance {d_final.max()} >= nmut threshold")
    check(d_best.max() <= cfg.nmut_threshold,
          f"best distance {d_best.max()} > nmut threshold")
    rate = float(res.n_accepted.sum()) / (steps * n_chains)
    check(0.0 < rate < 1.0, f"acceptance rate {rate}")
    check((res.best_energy >= res.energy_history[0]).all(),
          "best energy below the initial energy")
    # the carried best energies agree with a fresh evaluation of the best
    # states by the forward path (plain apart from the attention core)
    with torch.no_grad():
        bx = torch.from_numpy(res.best_x).to(dev)
        e_plain = torch.cat([en.energy(en.params, c)[0]
                             for c in bx.split(chunk or n_chains)])
    e_plain = e_plain.cpu().numpy()
    err = np.abs(e_plain - res.best_energy)
    check(np.allclose(e_plain, res.best_energy, rtol=1e-3, atol=2e-2),
          f"best energies disagree with a fresh evaluation: {err.max()}")
    return {"n_chains": n_chains, "steps": steps,
            "steps_per_sec": res.steps_per_sec,
            "chain_steps_per_sec": res.steps_per_sec * n_chains,
            "wall_steps_per_sec": res.wall_steps_per_sec,
            "acceptance_rate": rate,
            "best_energy_median": float(np.median(res.best_energy)),
            "initial_energy": float(res.energy_history[0, 0]),
            "max_distance_final": int(d_final.max()),
            "best_energy_max_abs_err_vs_plain": float(err.max())}


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
        r = check_run(torch, en, res, cfg, wt_oh, steps, n_chains, None, dev)
        r.update({"log_every": log_every, "launches_potts_energy": a_n,
                  "launches_cnn_ensemble": b_n, "card": card})
        runs.append(r)
        print("sampler", json.dumps(r), flush=True)
    return runs, launches


def phase_attention(torch, attention_fused, dev):
    """Kernels C and C' vs plain at ESM2's head shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        s = 2 if dtype == torch.bfloat16 else 4
        # float32: sums in another order; bf16: one rounding of w and ds
        # (the bound of the JAX package's own attention tests)
        tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
               else dict(rtol=3e-2, atol=3e-2))
        for Z, T, hd in ATTN_CASES:
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
            check(torch.allclose(o.float(), o0.float(), **tol),
                  f"kernel C Z={Z} T={T} hd={hd} {dn}: max abs err {err_f}")
            err_b = 0.0
            for name, g, g0 in zip(("dq", "dk", "dv"), grads, grads0):
                e = (g.float() - g0.float()).abs().max().item()
                err_b = max(err_b, e)
                check(torch.allclose(g.float(), g0.float(), **tol),
                      f"kernel C' {name} Z={Z} T={T} hd={hd} {dn}: max abs "
                      f"err {e}")
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
                 "tol": f"rtol {tol['rtol']}, atol {tol['atol']}",
                 "max_abs_err_fwd": err_f, "max_abs_err_bwd": err_b,
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
        r = check_run(torch, en, res, cfg, wt_oh, steps, n_chains, chunk, dev)
        r.update({"chunk_size": chunk, "log_every": log_every,
                  "transformer_term_of_wild_type": wt_term,
                  "launches": got, "card": card})
        runs.append(r)
        print("transformer sampler", json.dumps(r), flush=True)
    return runs, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    t = time.perf_counter()
    pa = phase_potts(torch, potts, potts_fused, dev)
    print(f"phase kernel A {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    pb = phase_cnn(torch, cnn, cnn_fused, dev)
    print(f"phase kernel B {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    # every kernel's launch counter: (wrapper module, attribute)
    counters = {"potts_energy": (potts_fused, "launches"),
                "cnn_ensemble": (cnn_fused, "launches"),
                "flash_attention_fwd": (attention_fused, "launches_fwd"),
                "flash_attention_bwd": (attention_fused, "launches_bwd")}
    runs, launches = phase_sampler(torch, codec, utils, energy_mod, potts,
                                   cnn, ppde, counters, dev, card)
    print(f"phase sampler {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    pc = phase_attention(torch, attention_fused, dev)
    print(f"phase kernels C, C' {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    tr_runs, tr_launches = phase_transformer(
        torch, codec, energy_mod, potts, cnn, esm2, ppde, counters, dev,
        card)
    print(f"phase transformer sampler {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, n in tr_launches.items():
        launches[name] += n

    # one headline case per kernel: the 1024-chain population in bf16 for A
    # and B, the chunk-16 call of the transformer path in bf16 for C and C'
    a = next(r for r in pa if r["B"] == 1024 and r["dtype"] == "bfloat16")
    b = next(r for r in pb if r["B"] == 1024 and r["dtype"] == "bfloat16"
             and r["pool_bwd"] == "split")
    c = next(r for r in pc if (r["Z"], r["T"], r["hd"]) == ATTN_CASES[0]
             and r["dtype"] == "bfloat16")
    kernels = {"kernels": [
        {"name": "potts_energy", "route": "cuda",
         "source": "ppde_tpu_torch/csrc/potts_energy.cu",
         "replaces": "ppde_tpu/ops/potts_pallas.py:55",
         "launches": launches["potts_energy"],
         "max_abs_err": max(a["max_abs_err_grad"], a["max_abs_err_H"]),
         "ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
         "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
         "library_ms": a["library_ms_addmm_grad_only"]},
        {"name": "cnn_ensemble", "route": "cuda",
         "source": "ppde_tpu_torch/csrc/cnn_ensemble.cu",
         "replaces": "ppde_tpu/ops/cnn_pallas.py:136",
         "launches": launches["cnn_ensemble"],
         "max_abs_err": max(b["max_abs_err_fit"], b["max_abs_err_dx"]),
         "ms": b["kernel_ms"], "plain_ms": b["plain_ms"],
         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
         "library_ms": None},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "ppde_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ppde_tpu/ops/attention_pallas.py:77",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": c["max_abs_err_fwd"], "ms": c["fwd_ms"],
         "plain_ms": c["fwd_plain_ms"], "bound_ms": c["fwd_bound_ms"],
         "bound_by": c["fwd_bound_by"],
         "library_ms": c["fwd_library_ms_sdpa"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "ppde_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ppde_tpu/ops/attention_pallas.py:98",
         "launches": launches["flash_attention_bwd"],
         "max_abs_err": c["max_abs_err_bwd"], "ms": c["bwd_ms"],
         "plain_ms": c["bwd_plain_ms"], "bound_ms": c["bwd_bound_ms"],
         "bound_by": c["bwd_bound_by"],
         "library_ms": c["bwd_library_ms_sdpa"]},
    ]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernel_a": pa,
                   "kernel_b": pb, "sampler": runs, "kernels_c": pc,
                   "transformer_sampler": tr_runs, **kernels}, f, indent=1)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
