"""CMA-ES baseline: an evolution strategy over a relaxed one-hot window.

Counterpart of ``ppde_tpu/samplers/protein/cmaes.py`` (parity with the
reference CMAES sampler, protein_samplers/cmaes.py:9-132): optimises the
flattened [window_len * V] relaxation starting from chain 0's one-hot,
objective = -energy of the argmax-discretised candidate, keeps a running
top-K (K = n_chains) archive re-seeded at every log step, and returns the
top-K population. Like the JAX package it scores the supervised expert
where the reference calls a stale ``get_fitness`` (:106,:124).

The ask/tell loop is host numpy (``samplers/cma_core.py``, seeded by
``seed``: no device random numbers); each generation's candidates are
scored in one device call, and its energies come back to the host for
``tell``. With ``checkpoint_dir`` the host state (archive, histories and
the ES) is written to ``cmaes_state.npz`` at every log step and a run
resumes from it.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers import cma_core
from ppde_tpu_torch.samplers.cma_core import CMAES


@dataclasses.dataclass(frozen=True)
class CMAESConfig:
    population_size: int = 16
    initial_variance: float = 0.05
    # None = auto: sep-CMA (diagonal covariance) above
    # cma_core.AUTO_DIAG_DIM, as GFP-sized windows (d = 4740) need
    diag: bool | None = None


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: CMAESConfig | None = None,
        log_every: int = 50, quiet: bool = False, seed: int = 0,
        device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """num_steps generations; the result's bests are the final top-K."""
    cfg = cfg or CMAESConfig()
    device = utils.resolve_device(device)
    x0 = torch.as_tensor(initial_population, dtype=torch.float32).to(device)
    n_chains, L, V = x0.shape
    wlen = max_pos + 1 - min_pos
    eparams = energy.params
    left, right = x0[0, :min_pos], x0[0, max_pos + 1:]

    def batch_energy(window_soft):
        """[P, wlen*V] continuous candidates -> (energy, one-hots)."""
        w = window_soft.reshape(-1, wlen, V)
        hard = torch.nn.functional.one_hot(w.argmax(-1), V).float()
        P = w.shape[0]
        full = torch.cat([left.expand(P, -1, -1), hard,
                          right.expand(P, -1, -1)], dim=1)
        return energy.energy(eparams, full)[0], full

    es = CMAES(x0[0, min_pos:max_pos + 1].reshape(-1).cpu().numpy(),
               np.sqrt(cfg.initial_variance),
               popsize=cfg.population_size, seed=seed, diag=cfg.diag)

    seq_arch: list[np.ndarray] = []   # [L, V] candidates
    e_arch: list[float] = []
    fitness_history, energy_history, oracle_history = [], [], []

    def top_k():
        e = np.asarray(e_arch)
        idx = np.argsort(-e)[:n_chains]
        if len(idx) < n_chains:  # pad by repeating the best
            idx = np.concatenate([idx, np.repeat(idx[:1],
                                                 n_chains - len(idx))])
        return np.stack([seq_arch[i] for i in idx], 0), e[idx]

    start_step = 0
    ck_path = (os.path.join(checkpoint_dir, "cmaes_state.npz")
               if checkpoint_dir else None)
    with torch.no_grad():
        e0, fit0 = energy.energy(eparams, x0)
        energy_history.append(e0.cpu().numpy())
        fitness_history.append(fit0.cpu().numpy())
        if ck_path and os.path.exists(ck_path):
            start_step, z = cma_core.load_run(ck_path, es)
            seq_arch, e_arch = list(z["seq_arch"]), list(z["e_arch"])
            fitness_history = list(z["fitness_history"])
            energy_history = list(z["energy_history"])
            oracle_history = list(z["oracle_history"])
            if not quiet:
                print(f"[resume] CMA-ES at generation {start_step} from "
                      f"{ck_path}", flush=True)

        t0 = time.perf_counter()
        for step in range(start_step, num_steps):
            X = es.ask()
            e, full = batch_energy(torch.from_numpy(X).to(device,
                                                          torch.float32))
            e_np = e.cpu().numpy()
            es.tell(X, -e_np)
            seq_arch.extend(full.cpu().numpy())
            e_arch.extend(float(v) for v in e_np)

            if step > 0 and (step + 1) % log_every == 0:
                seqs, es_top = top_k()
                seqs_d = torch.from_numpy(seqs).to(device)
                fit_top = energy.fitness(eparams, seqs_d).cpu().numpy()
                fitness_history.append(fit_top)
                energy_history.append(es_top)
                if oracle is not None:
                    oracle_history.append(
                        oracle[1](oracle[0], seqs_d).cpu().numpy())
                # re-seed the archive with the current top-K (reference
                # :108-110)
                seq_arch, e_arch = list(seqs), list(es_top)
                if ck_path:
                    cma_core.save_run(
                        ck_path, es, step + 1, seq_arch=seqs,
                        e_arch=np.asarray(e_arch),
                        fitness_history=fitness_history,
                        energy_history=energy_history,
                        oracle_history=oracle_history)
                if not quiet:
                    eq = np.quantile(es_top, [0.5, 0.9])
                    fq = np.quantile(fit_top, [0.5, 0.9])
                    print(f"[CMAES iter {step}] energy 50% {eq[0]:.3f} 90% "
                          f"{eq[1]:.3f}; pred fit 50% {fq[0]:.3f} 90% "
                          f"{fq[1]:.3f}", flush=True)
        elapsed = time.perf_counter() - t0

        seqs, es_top = top_k()
        seqs_d = torch.from_numpy(seqs).to(device)
        best_fit = energy.fitness(eparams, seqs_d).cpu().numpy()
        if oracle is not None:
            oracle_history.append(oracle[1](oracle[0], seqs_d).cpu().numpy())

    # the loop is host-paced (one device call and one readback a
    # generation): its rate is the wall rate, over the generations run in
    # this process
    rate = (num_steps - start_step) / max(elapsed, 1e-9)
    return base.SamplerResult(
        best_x=seqs, best_energy=es_top, best_fitness=best_fit,
        energy_history=np.stack(
            [np.resize(e, n_chains) for e in energy_history], 0),
        fitness_history=np.stack(
            [np.resize(f, n_chains) for f in fitness_history], 0),
        random_traj=None, final_x=seqs,
        oracle_history=(np.stack(oracle_history, 0) if oracle_history
                        else np.zeros((0,))),
        steps_per_sec=rate, wall_steps_per_sec=rate)
