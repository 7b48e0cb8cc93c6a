"""The port's benchmark: PPDE-PAS chain-steps/s on GFP, on one GPU.

    python -m ppde_tpu_torch.scripts.bench [--device cuda] [--steps 2000] ...

Counterpart of the repository's root ``bench.py``, which measures the JAX
package: the same flags with the same defaults, plus ``--device`` (default
``cuda``, which raises without a GPU; ``cpu`` runs the kernels' plain
versions), the same configurations and the same JSON line:

  * GFP potts PoE (synthetic Potts, seed 0; a seeded 3-member OnehotCNN
    ensemble; lambda 15; PPDE-PAS with pas_length 2 and nmut_threshold 10)
    at 128 chains (``--steps``) and at 1024 chains (``--steps-peak``):
    kernels A and B once a step;
  * GFP potts + transformer-S PoE (random-init ESM2 at full width and
    depth, lambda 1) at 128 chains (``--steps-transformer``): A, B, and C
    and C' once a layer a piece a step;
  * MNIST PPDE-PAS-10 PoE (EBM, lambda 10) at 128 chains
    (``--steps-mnist``): no port kernel.

``--chains N`` benches the GFP potts configuration at N chains alone.

A configuration runs ``steps`` sampler steps back to back with no host
synchronisation (an execution), keeping on the device only chain 0's energy
and the accepted count of each step, and ends the execution with one
``torch.cuda.synchronize()`` and one scalar readback. It runs ``max(1,
warmup // steps)`` executions untimed, then 3 timed ones, the state carried
from each to the next, and reports steps over the fastest execution's
seconds, with all three times beside it. Prints ONE JSON line:

  {"metric": "ppde_pas_chain_steps_per_sec_gfp_peak", "value": N,
   "unit": "chain-steps/s", "vs_baseline": N, "detail": {...}}

whose value is the fastest GFP potts configuration's chain-steps/s.
``vs_baseline`` is its ratio to the torch-CPU reference's chain-steps/s,
read from ``tools/torch_baseline.json`` (never written here);
``--measure-torch`` measures it anew for this run alone.

Checks gate the speed; a failed one raises, so the process exits non-zero
and prints no JSON line. Every run: finite energies, the final and best
states within the nmut budget (GFP) or binary (MNIST), an acceptance rate
over the timed steps strictly inside (0, 1), each chain's best energy at
least its initial energy, the carried best energies against a fresh
``en.energy`` of the best states (rtol 1e-3, atol 2e-2), and each kernel's
launches exactly as the configuration makes them (on the CPU: none).

Differences from root ``bench.py`` by design (also in the JSON line):

  * the transformer's gradient is taken in ``runtime.resolve_esm_chunk``'s
    automatic chunking for the card's memory (one piece at 128 chains on
    an 80 GB card), not in chunks of 16, a TPU optimum;
  * ``--cnn-chunk`` defaults to no chunking at any population (bench.py
    chunks by 128 above 256 chains, an XLA workaround): kernel B takes the
    population in one launch;
  * ``--fused-cnn`` is recorded and changes nothing: on CUDA kernel B
    always runs;
  * ESM2's type follows ``--dtype`` (bench.py keeps it in bf16);
  * the MNIST configuration runs on ``scripts/seeded_mnist.py``'s seeded
    regressors and the tracked EBM checkpoint, written to a temporary
    directory, not on the reference's networks.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from ppde_tpu_torch import codec, energy as energy_mod, runtime, utils
from ppde_tpu_torch.models import cnn, esm2, potts
from ppde_tpu_torch.ops import _build, attention_fused, cnn_fused, potts_fused
from ppde_tpu_torch.samplers.base import Draws
from ppde_tpu_torch.samplers.mnist import ppde as mnist_ppde
from ppde_tpu_torch.samplers.protein import ppde
from ppde_tpu_torch.scripts import mnist_sum, seeded_mnist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
TORCH_BASELINE = os.path.join(REPO, "tools", "torch_baseline.json")
METRIC = "ppde_pas_chain_steps_per_sec_gfp_peak"

GFP_WT = (
    "SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTLSYGVQCFSRY"
    "PDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNS"
    "HNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVL"
    "LEFVTAAGITHGMDELYK"
)
N_CHAINS = 128        # the reference's canonical population
N_CHAINS_PEAK = 1024  # the large population
REPS = 3              # timed executions; the fastest is reported
PPDE_CFG = ppde.PPDEConfig(pas_length=2, nmut_threshold=10)
MNIST_CFG = mnist_ppde.MNISTPPDEConfig(pas_length=10)
MNIST_WT = 1          # the wild-type pair of mnist_sum.WT_FILES
MNIST_D = 784
BEST_TOL = dict(rtol=1e-3, atol=2e-2)  # best energies vs a fresh evaluation
DIFFERENCES = {
    "transformer_chunking": "runtime.resolve_esm_chunk(0, ...) for the "
                            "card's memory (bench.py: chunks of 16)",
    "cnn_chunk": "the flag when given, else none (bench.py: 128 above 256 "
                 "chains)",
    "fused_cnn": "recorded only: on CUDA kernel B always runs",
    "esm_dtype": "follows --dtype (bench.py: bf16)",
    "mnist_weights": "scripts/seeded_mnist.py's seeded regressors and the "
                     "tracked mnist_ebm_ckpt_20000.npz",
}

# every kernel's launch counter: (wrapper module, attribute); the _f32
# counters count the float32 launches among the others
COUNTERS = {"potts_energy": (potts_fused, "launches"),
            "potts_energy_f32": (potts_fused, "launches_f32"),
            "cnn_ensemble": (cnn_fused, "launches"),
            "cnn_ensemble_f32": (cnn_fused, "launches_f32"),
            "flash_attention_fwd": (attention_fused, "launches_fwd"),
            "flash_attention_bwd": (attention_fused, "launches_bwd")}


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


_T0 = time.perf_counter()


def _log(msg):
    print(f"[bench +{time.perf_counter() - _T0:.0f}s] {msg}",
          file=sys.stderr, flush=True)


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def card_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type == "cpu":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def check_run(en, energies, best_energy, best_x, final_x, n_accepted, cfg,
              wt_oh, steps, n_chains, chunk, dev) -> dict:
    """The checks every protein sampler run must pass; returns their numbers.

    energies [records, n_chains] (host), whose first row holds the initial
    energies; best_energy [n_chains], best_x and final_x [n_chains, L, V]
    (host); n_accepted: the proposals accepted over ``steps`` steps. The
    fresh evaluation of the best states goes through ``en.energy`` in chain
    chunks of ``chunk`` (None: one piece), the shapes the run itself used.
    """
    check(np.isfinite(energies).all(), "non-finite energies")
    check(np.isfinite(best_energy).all(), "non-finite best energy")
    wt = wt_oh[0].cpu().numpy()
    d_final = (final_x != wt[None]).any(-1).sum(-1)
    d_best = (best_x != wt[None]).any(-1).sum(-1)
    check(d_final.max() < cfg.nmut_threshold,
          f"final distance {d_final.max()} >= nmut threshold")
    check(d_best.max() <= cfg.nmut_threshold,
          f"best distance {d_best.max()} > nmut threshold")
    rate = float(n_accepted) / (steps * n_chains)
    check(0.0 < rate < 1.0, f"acceptance rate {rate}")
    check((best_energy >= energies[0]).all(),
          "best energy below the initial energy")
    # the carried best energies agree with a fresh evaluation of the best
    # states by the forward path (plain apart from the attention core)
    with torch.no_grad():
        bx = torch.from_numpy(np.ascontiguousarray(best_x)).to(dev)
        e_plain = torch.cat([en.energy(en.params, c)[0]
                             for c in bx.split(chunk or n_chains)])
    e_plain = e_plain.cpu().numpy()
    err = np.abs(e_plain - best_energy)
    check(np.allclose(e_plain, best_energy, **BEST_TOL),
          f"best energies disagree with a fresh evaluation: {err.max()}")
    return {"acceptance_rate": rate,
            "best_energy_median": float(np.median(best_energy)),
            "initial_energy": float(energies[0, 0]),
            "max_distance_final": int(d_final.max()),
            "best_energy_max_abs_err_vs_plain": float(err.max())}


def check_mnist_run(en, energies, best_energy, best_x, final_x, n_accepted,
                    x1, steps, n_chains) -> dict:
    """The checks of an MNIST PPDE-PAS run (chip_smoke.py phase 9's): finite
    energies, a binary final population, an acceptance rate strictly inside
    (0, 1), each chain's best at least its start, and the carried bests
    against a fresh ``en.energy``. Arguments as ``check_run``'s, with the
    fixed summands x1 [n_chains, 784] on the run's device."""
    check(np.isfinite(energies).all() and np.isfinite(best_energy).all(),
          "non-finite energies")
    check(final_x.shape == (n_chains, MNIST_D)
          and np.isin(final_x, (0.0, 1.0)).all(),
          f"final_x of shape {final_x.shape} is not binary")
    rate = float(n_accepted) / (steps * n_chains)
    check(0.0 < rate < 1.0, f"acceptance rate {rate}")
    check((best_energy >= energies[0]).all(),
          "a chain's best energy is below its start")
    with torch.no_grad():
        e = en.energy(en.params, torch.from_numpy(np.ascontiguousarray(
            best_x, np.float32)).to(x1.device), x1)[0].cpu().numpy()
    err = np.abs(e - best_energy)
    check(np.allclose(e, best_energy, **BEST_TOL),
          f"best energies off a fresh evaluation by {err.max()}")
    return {"acceptance_rate": rate,
            "best_energy_median": float(np.median(best_energy)),
            "initial_energy": float(energies[0, 0]),
            "best_energy_max_abs_err_vs_plain": float(err.max())}


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

def transformer_chunk(n_chains: int, device: torch.device,
                      esm_name: str = "transformer-S") -> int | None:
    """The transformer's ``chunk_size`` at ``n_chains``: the automatic one
    for the card's memory (None: one piece; always so on the CPU)."""
    card_bytes = (torch.cuda.get_device_properties(device).total_memory
                  if device.type == "cuda" else None)
    return runtime.resolve_esm_chunk(0, True, n_chains, esm_name,
                                     len(GFP_WT), card_bytes)


def gfp_energy(dtype: str, n_chains: int, transformer: bool, device,
               cnn_chunk: int | None = None,
               esm_name: str = "transformer-S") -> energy_mod.Energy:
    """The GFP product-of-experts energy that root bench.py's ``bench_jax``
    builds (its lines 83-107), from the port's own functions: the synthetic
    Potts model (seed 0) and the 3-member CNN ensemble (generator seed 0)
    in ``dtype`` ("bf16" or "f32"), lambda 15; with ``transformer``, plus
    ``esm_name`` at random init and lambda 1, its gradient in
    ``transformer_chunk``'s pieces."""
    device = utils.resolve_device(device)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    pp = potts.synthetic(GFP_WT, seed=0, dtype=tdt, device=device)
    ens = cnn.init_ensemble(torch.Generator(device=device).manual_seed(0), 3,
                            input_size=len(GFP_WT))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([GFP_WT])).to(device)
    tr = chunk = None
    if transformer:
        tr = esm2.load_expert(esm_name, GFP_WT, allow_random=True, dtype=tdt,
                              device=device)
        chunk = transformer_chunk(n_chains, device, esm_name)
    return energy_mod.protein_poe(
        pp, ens, lam=1.0 if transformer else 15.0, wt_onehot=wt_oh,
        transformer=tr, chunk_size=chunk,
        compute_dtype=torch.bfloat16 if dtype == "bf16" else None,
        cnn_chunk=cnn_chunk)


def protein_setup(en: energy_mod.Energy, pop: torch.Tensor,
                  cfg: ppde.PPDEConfig = PPDE_CFG):
    """(step, ctx, state) of PPDE-PAS from the population ``pop`` [N, L, V]
    (chain 0 the wild type), set up as ``ppde.run`` does: the whole
    sequence mutable, the wild-type constants from one ``energy_and_grad``
    of the population. Call under ``torch.no_grad()``."""
    n, L, V = pop.shape
    window_ok = utils.position_window_mask(L, V, 0, L - 1, pop.device)
    ctx = {"energy": en.params, "wt": pop[0], "init_x": pop}
    e0, fit0, grad0 = en.energy_and_grad(ctx["energy"], pop)
    ctx["wt_e"], ctx["wt_fit"], ctx["wt_grad"] = e0[0], fit0[0], grad0[0]
    step = ppde.make_step(en, cfg, window_ok, n, L, V)
    return step, ctx, (pop, (e0, fit0, grad0), (e0, fit0, pop))


def timed_loop(step, ctx, state, draws, steps: int):
    """``steps`` calls of ``step`` back to back, syncing nothing: (state,
    chain 0's energy at each step [steps], proposals accepted), on the
    device (the records root bench.py's scan body keeps)."""
    energies, accepted = [], []
    for _ in range(steps):
        state, ys = step(ctx, state, draws)
        energies.append(ys["energy"][0])
        accepted.append(ys["accepted"].sum())
    return state, torch.stack(energies), torch.stack(accepted).sum()


def time_executions(step, ctx, state, draws, steps: int, warmup: int):
    """``max(1, warmup // steps)`` untimed executions of ``timed_loop``,
    then ``REPS`` timed ones, the state carried across; each ends with a
    synchronize and one scalar readback. Returns (state, timing), timing
    holding each timed execution's seconds, chain 0's energies over the
    timed steps (host) and the proposals accepted in them."""
    def execute(state):
        t0 = time.perf_counter()
        state, e_trace, acc = timed_loop(step, ctx, state, draws, steps)
        if e_trace.device.type == "cuda":
            torch.cuda.synchronize(e_trace.device)
        float(e_trace[-1])
        return state, e_trace, acc, time.perf_counter() - t0

    n_warm = max(1, warmup // max(steps, 1))
    for _ in range(n_warm):
        state = execute(state)[0]
    seconds, traces, accepted = [], [], 0
    for _ in range(REPS):
        state, e_trace, acc, dt = execute(state)
        seconds.append(dt)
        traces.append(e_trace.cpu().numpy())
        accepted += int(acc)
    return state, {"warmup_executions": n_warm, "execution_s": seconds,
                   "chain0_energies": np.concatenate(traces),
                   "accepted": accepted}


def expected_launches(device, n_calls: int, dtype: str, cnn_pieces: int,
                      attention: int) -> dict:
    """Each kernel's launches in ``n_calls`` calls of a GFP energy's
    ``energy_and_grad``: kernel A once a call, B ``cnn_pieces`` times, C and
    C' ``attention`` times each; none on the CPU, where the plain versions
    run."""
    if device.type == "cpu":
        return dict.fromkeys(COUNTERS, 0)
    b = n_calls * cnn_pieces
    f32 = dtype == "f32"
    return {"potts_energy": n_calls, "potts_energy_f32": n_calls * f32,
            "cnn_ensemble": b, "cnn_ensemble_f32": b * f32,
            "flash_attention_fwd": n_calls * attention,
            "flash_attention_bwd": n_calls * attention}


def _finish_row(row, timing, steps, launches, expected, checks):
    check(launches == expected,
          f"{row['expert']} x {row['n_chains']}: kernel launches {launches}, "
          f"expected {expected}")
    sps = steps / min(timing["execution_s"])
    row.update({"sampler_steps_per_sec": round(sps, 2),
                "chain_steps_per_sec": round(sps * row["n_chains"], 1),
                "steps": steps,
                "warmup_executions": timing["warmup_executions"],
                "execution_s": timing["execution_s"],
                "launches": launches, "checks": checks})
    _log(f"{row['expert']} x {row['n_chains']}: {sps:.2f} steps/s, "
         f"executions {[round(s, 3) for s in timing['execution_s']]} s")
    return row


def bench_torch(steps: int, warmup: int, dtype: str,
                n_chains: int = N_CHAINS, fused_cnn: bool | None = None,
                cnn_chunk: int | None = None, transformer: bool = False,
                device="cuda") -> dict:
    """One GFP configuration (root bench.py's ``bench_jax``): its row of
    the JSON line's ``detail.configs``."""
    device = utils.resolve_device(device)
    expert = "potts+transformer-S" if transformer else "potts"
    _log(f"building {expert} x {n_chains} ({dtype})")
    en = gfp_energy(dtype, n_chains, transformer, device, cnn_chunk)
    chunk = transformer_chunk(n_chains, device) if transformer else None
    pieces = -(-n_chains // chunk) if chunk else 1
    # kernel B's launches a call: energy._fit_and_grad's chunks
    cnn_pieces = (n_chains // cnn_chunk if cnn_chunk and n_chains > cnn_chunk
                  and n_chains % cnn_chunk == 0 else 1)
    layers = esm2.CONFIGS["transformer-S"]["layers"] if transformer else 0
    pop = en.wt_onehot.repeat(n_chains, 1, 1)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        before = launch_counts()
        step, ctx, state = protein_setup(en, pop)
        e0 = state[1][0]
        state, timing = time_executions(step, ctx, state, draws, steps,
                                        warmup)
        after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    n_calls = 1 + (timing["warmup_executions"] + REPS) * steps
    expected = expected_launches(device, n_calls, dtype, cnn_pieces,
                                 layers * pieces)
    final_x, (e, _, _), (best_e, _, best_x) = state
    check(np.isfinite(timing["chain0_energies"]).all(),
          "non-finite energies in the timed steps")
    checks = check_run(
        en, np.stack([e0.cpu().numpy(), e.cpu().numpy()]),
        best_e.cpu().numpy(), best_x.cpu().numpy(), final_x.cpu().numpy(),
        timing["accepted"], PPDE_CFG, en.wt_onehot, REPS * steps, n_chains,
        chunk, device)
    row = {"domain": "gfp", "n_chains": n_chains, "expert": expert,
           "dtype": dtype, "fused_cnn": fused_cnn, "cnn_chunk": cnn_chunk}
    if transformer:
        row.update({"chunk_size": chunk, "pieces": pieces})
    return _finish_row(row, timing, steps, launches, expected, checks)


def mnist_energy(weights_dir: str, data_dir: str, device):
    """The MNIST PoE energy of root bench.py's ``bench_mnist`` (EBM, lambda
    10), built by the port's ``mnist_sum.build_energy``."""
    args = SimpleNamespace(
        mnist_weights=weights_dir, data_dir=data_dir,
        energy_function="product_of_experts", unsupervised_expert="ebm",
        energy_lamda=10.0)
    return mnist_sum.build_energy(args, device)


def bench_mnist(steps: int, warmup: int, n_chains: int = N_CHAINS,
                device="cuda") -> dict:
    """The MNIST PPDE-PAS-10 PoE configuration (root bench.py's
    ``bench_mnist``) on seeded stand-ins: its row of ``detail.configs``."""
    device = utils.resolve_device(device)
    _log(f"building the MNIST PoE energy x {n_chains}")
    with tempfile.TemporaryDirectory() as tmp:
        w = seeded_mnist.write_weights_dir(os.path.join(tmp, "w"))
        d = seeded_mnist.write_data_dir(os.path.join(tmp, "d"))
        en = mnist_energy(w, d, device)

        def tiled(name):  # one wild-type digit, one copy a chain
            a = np.load(os.path.join(d, name)).reshape(MNIST_D)
            return torch.from_numpy(np.tile(a, (n_chains, 1))).to(
                device, torch.float32)

        fa, fb = mnist_sum.WT_FILES[MNIST_WT]
        x1, x2 = tiled(fa), tiled(fb)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        before = launch_counts()
        e0, fit0, grad0 = en.energy_and_grad(en.params, x2, x1)
        step = mnist_ppde.make_step_pas(en, MNIST_CFG, n_chains, MNIST_D)
        ctx = {"energy": en.params, "x1": x1}
        state, timing = time_executions(
            step, ctx, (x2, (e0, fit0, grad0), (e0, fit0, x2)), draws, steps,
            warmup)
        after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    final_x, (e, _, _), (best_e, _, best_x) = state
    check(np.isfinite(timing["chain0_energies"]).all(),
          "non-finite energies in the timed steps")
    checks = check_mnist_run(
        en, np.stack([e0.cpu().numpy(), e.cpu().numpy()]),
        best_e.cpu().numpy(), best_x.cpu().numpy(), final_x.cpu().numpy(),
        timing["accepted"], x1, REPS * steps, n_chains)
    row = {"domain": "mnist", "n_chains": n_chains,
           "expert": "ebm_poe_pas10"}
    return _finish_row(row, timing, steps, launches,
                       dict.fromkeys(COUNTERS, 0), checks)


def bench_torch_reference(steps: int = 2) -> float:
    """Faithful torch reimplementation of the reference PPDE-PAS hot loop
    (energy fwd+bwd x2, PAS inner loop, MH accept) on this host's CPU
    (root bench.py's, copied)."""
    torch.manual_seed(0)
    L, V, N = len(GFP_WT), 20, N_CHAINS
    rng = np.random.default_rng(0)
    J = torch.tensor(rng.normal(0, 0.05, (L, L, V, V)), dtype=torch.float32)
    J = 0.5 * (J + J.permute(1, 0, 3, 2))
    h = torch.tensor(rng.normal(0, 0.5, (L, V)), dtype=torch.float32)
    enc = torch.nn.Conv1d(V, L, 5)
    emb = torch.nn.Linear(L, 2 * L)
    dec = torch.nn.Linear(2 * L, 1)

    def energy(x):
        Jx = torch.einsum("ijkl,bjl->bik", J, x)
        e = torch.einsum("aik,aik->a", Jx, x) / 2 + (h[None] * x).sum((-1, -2))
        hdd = torch.relu(enc(x.transpose(1, 2)).transpose(1, 2))
        hdd = torch.relu(emb(hdd)).max(1)[0]
        return e + 15.0 * dec(hdd).squeeze(-1)

    x = torch.zeros(N, L, V)
    x[:, torch.arange(L), torch.tensor([ord(c) % V for c in GFP_WT])] = 1.0

    t0 = time.perf_counter()
    for _ in range(steps):
        for _endpoint in range(2):  # current state + proposal endpoint
            xg = x.clone().requires_grad_()
            e = energy(xg)
            (grad,) = torch.autograd.grad([e.sum()], [xg])
        for _inner in range(3):  # pas inner path (max_u for pas_length=2)
            score = grad - (grad * x).sum(-1, keepdim=True)
            probs = torch.softmax(score.reshape(N, -1) / 2.0, -1)
            idx = torch.multinomial(probs, 1)[:, 0]
            p, v = idx // V, idx % V
            x[torch.arange(N), p] = 0.0
            x[torch.arange(N), p, v] = 1.0
    dt = time.perf_counter() - t0
    return steps / dt


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000,
                    help="timed execution's length for the 128-chain config")
    ap.add_argument("--steps-peak", type=int, default=600,
                    help="timed execution's length for the 1024-chain config")
    ap.add_argument("--warmup", type=int, default=100,
                    help="untimed steps first, in max(1, warmup // steps) "
                         "executions of the timed length")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="bf16",
                    help="potts + CNN (+ ESM2) compute precision")
    ap.add_argument("--skip-torch", action="store_true",
                    help="no torch-CPU reference: vs_baseline 0")
    ap.add_argument("--measure-torch", action="store_true",
                    help="measure the torch-CPU reference anew for this run "
                         "(tools/torch_baseline.json is not written)")
    ap.add_argument("--torch-steps", type=int, default=1)
    ap.add_argument("--chains", type=int, default=None,
                    help="bench only the GFP potts config at this many "
                         "chains (default: 128 and 1024, the transformer "
                         "and MNIST configs)")
    ap.add_argument("--cnn-chunk", type=int, default=None,
                    help="kernel B over chain chunks of this size "
                         "(default: the whole population at once)")
    ap.add_argument("--fused-cnn", action="store_true", default=None,
                    help="recorded only: on CUDA kernel B always runs")
    ap.add_argument("--no-fused-cnn", dest="fused_cnn", action="store_false")
    ap.add_argument("--skip-transformer", action="store_true",
                    help="skip the potts+transformer-S config (128 chains)")
    ap.add_argument("--steps-transformer", type=int, default=240,
                    help="timed execution's length for the transformer "
                         "config")
    ap.add_argument("--skip-mnist", action="store_true",
                    help="skip the MNIST PPDE-PAS-10 PoE config")
    ap.add_argument("--steps-mnist", type=int, default=2000)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (the "
                         "kernels' plain versions)")
    return ap


def torch_reference(args):
    """(steps/s, chains, measured in this run) of the torch-CPU reference;
    (None, None, False) with ``--skip-torch``."""
    if args.measure_torch or (not args.skip_torch
                              and not os.path.exists(TORCH_BASELINE)):
        return bench_torch_reference(args.torch_steps), N_CHAINS, True
    if args.skip_torch:
        return None, None, False
    with open(TORCH_BASELINE) as f:
        d = json.load(f)
    return d["torch_cpu_steps_per_sec"], d["n_chains"], False


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = utils.resolve_device(args.device)
    build_s = _build.build_all() if device.type == "cuda" else 0.0
    card = card_name(device)
    if args.chains is not None:
        fused = args.fused_cnn if args.fused_cnn is not None \
            else args.chains > 256
        configs = [(args.chains, args.steps, fused, False)]
    else:
        configs = [(N_CHAINS, args.steps, False, False),
                   (N_CHAINS_PEAK, args.steps_peak, True, False)]
        if not args.skip_transformer:
            configs.append((N_CHAINS, args.steps_transformer, False, True))

    results = [bench_torch(steps, args.warmup, args.dtype, n_chains,
                           fused_cnn=fused, cnn_chunk=args.cnn_chunk,
                           transformer=tr, device=device)
               for n_chains, steps, fused, tr in configs]
    if args.chains is None and not args.skip_mnist:
        results.append(bench_mnist(args.steps_mnist, args.warmup,
                                   device=device))

    torch_sps, torch_chains, measured = torch_reference(args)
    # torch-CPU is throughput-bound: chain-steps/s is chain-count-invariant
    # to first order, so the ratio is taken in chain-steps/s on both sides
    torch_chain_sps = torch_sps * torch_chains if torch_sps else None
    # headline = the GFP potts configs only; the transformer and MNIST rows
    # are in detail
    gfp_potts = [r for r in results
                 if r["domain"] == "gfp" and r["expert"] == "potts"]
    peak = max(gfp_potts or results, key=lambda r: r["chain_steps_per_sec"])
    vs = (peak["chain_steps_per_sec"] / torch_chain_sps) \
        if torch_chain_sps else 0.0
    line = {
        "metric": METRIC,
        "value": peak["chain_steps_per_sec"],
        "unit": "chain-steps/s",
        "vs_baseline": round(vs, 2),
        "detail": {
            "configs": results,
            "headline_n_chains": peak["n_chains"],
            "torch_cpu_reference_steps_per_sec": (
                round(torch_sps, 4) if torch_sps else None),
            "torch_cpu_reference_chain_steps_per_sec": (
                round(torch_chain_sps, 2) if torch_chain_sps else None),
            "torch_cpu_reference_measured": measured,
            "dtype": args.dtype,
            "card": card,
            "device": str(device),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "kernel_build_s": build_s,
            "differences": DIFFERENCES,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
