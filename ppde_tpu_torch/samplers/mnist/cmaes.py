"""CMA-ES for binary MNIST over a [784, 2] categorical relaxation.

Counterpart of ``ppde_tpu/samplers/mnist/cmaes.py`` (parity with the
reference mnist_samplers/cmaes.py:8-126): candidates are [784 * 2]
continuous vectors, argmax-discretised per pixel; the starting point
one-hot encodes the initial image; the returned population is the last
n_chains // popsize generations of candidates. Like the JAX package it
scores the supervised expert where the reference calls a stale
``model.get_fitness`` (:105).

The ask/tell loop is host numpy (``samplers/cma_core.py``, seeded by
``seed``); each generation's candidates are scored in one device call.
With ``checkpoint_dir`` the host state (the trailing generations,
histories and the ES) is written to ``cmaes_state.npz`` at every log step
and a run resumes from it.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base, cma_core
from ppde_tpu_torch.samplers.cma_core import CMAES


@dataclasses.dataclass(frozen=True)
class MNISTCMAESConfig:
    population_size: int = 16
    initial_variance: float = 0.1


def run(energy: Energy, initial_population, num_steps: int, min_pos: int = 0,
        max_pos: int = 784, oracle=None, cfg: MNISTCMAESConfig | None = None,
        log_every: int = 50, quiet: bool = False, seed: int = 0,
        device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """num_steps generations; the result's bests are the final population
    sorted by energy."""
    cfg = cfg or MNISTCMAESConfig()
    device = utils.resolve_device(device)
    pop = np.asarray(initial_population, np.float32)
    n_chains, D = pop.shape[0], pop.shape[1] // 2
    x1 = torch.from_numpy(pop[:, :D]).to(device)
    x2 = torch.from_numpy(pop[:, D:]).to(device)
    eparams = energy.params

    def x1_for(k):
        return x1[:1].expand(k, D)

    def batch_energy(soln):
        """[P, D*2] -> (energy, binary images [P, D])."""
        imgs = soln.reshape(-1, D, 2).argmax(-1).float()
        return energy.energy(eparams, imgs, x1_for(imgs.shape[0]))[0], imgs

    x0 = np.zeros((D, 2), np.float64)
    x0[np.arange(D), pop[0, D:].astype(int)] = 1.0
    es = CMAES(x0.ravel(), np.sqrt(cfg.initial_variance),
               popsize=cfg.population_size, seed=seed)

    # only the trailing t generations ever feed the population
    gens: list[np.ndarray] = []   # per-generation candidate images
    gen_es: list[np.ndarray] = []
    t = max(1, n_chains // cfg.population_size)
    start_step = 0
    oracle_history: list = []
    ck_path = (os.path.join(checkpoint_dir, "cmaes_state.npz")
               if checkpoint_dir else None)
    with torch.no_grad():
        e0, fit0 = energy.energy(eparams, x2, x1)
        energy_history = [e0.cpu().numpy()]
        fitness_history = [fit0.cpu().numpy()]
        if ck_path and os.path.exists(ck_path):
            start_step, z = cma_core.load_run(ck_path, es)
            gens, gen_es = list(z["gens"]), list(z["gen_es"])
            energy_history = list(z["energy_history"])
            fitness_history = list(z["fitness_history"])
            oracle_history = list(z["oracle_history"])
            if not quiet:
                print(f"[resume] CMA-ES at generation {start_step} from "
                      f"{ck_path}", flush=True)

        t0 = time.perf_counter()
        for step in range(start_step, num_steps):
            X = es.ask()
            e, imgs = batch_energy(torch.from_numpy(X).to(device,
                                                          torch.float32))
            e_np = e.cpu().numpy()
            es.tell(X, -e_np)
            keep = -(t - 1) if t > 1 else len(gens)  # the last t - 1
            gens = gens[keep:] + [imgs.cpu().numpy()]
            gen_es = gen_es[keep:] + [e_np]

            if step > 0 and (step + 1) % log_every == 0:
                new_pop = torch.from_numpy(
                    np.concatenate(gens[-t:], 0)[:n_chains]).to(device)
                x1b = x1_for(new_pop.shape[0])
                fitness_history.append(np.resize(
                    energy.fitness(eparams, new_pop, x1b).cpu().numpy(),
                    n_chains))
                energy_history.append(
                    np.resize(np.concatenate(gen_es[-t:], 0), n_chains))
                if oracle is not None:
                    oracle_history.append(
                        oracle[1](oracle[0], new_pop, x1b).cpu().numpy())
                if ck_path:
                    cma_core.save_run(
                        ck_path, es, step + 1, gens=gens, gen_es=gen_es,
                        energy_history=energy_history,
                        fitness_history=fitness_history,
                        oracle_history=oracle_history)
                if not quiet:
                    print(f"[CMAES iter {step}] energy mean "
                          f"{energy_history[-1].mean():.3f}", flush=True)
        elapsed = time.perf_counter() - t0

        final = (np.concatenate(gens[-t:], 0)[:n_chains] if gens
                 else pop[:, D:])
        final = np.resize(final, (n_chains, D))
        e_final = (np.resize(np.concatenate(gen_es[-t:], 0), n_chains)
                   if gen_es else e0.cpu().numpy())
        fit_final = energy.fitness(eparams, torch.from_numpy(final).to(
            device), x1_for(n_chains)).cpu().numpy()

    order = np.argsort(-e_final)
    # host-paced: the rate counts the generations run in this process
    rate = (num_steps - start_step) / max(elapsed, 1e-9)
    return base.SamplerResult(
        best_x=final[order], best_energy=e_final[order],
        best_fitness=fit_final[order],
        energy_history=np.stack(energy_history, 0),
        fitness_history=np.stack(fitness_history, 0),
        random_traj=None, final_x=final,
        oracle_history=(np.stack(oracle_history, 0) if oracle_history
                        else np.zeros((0,))),
        steps_per_sec=rate, wall_steps_per_sec=rate)
