"""Random-search baseline: repeated random edits of the initial population.

Counterpart of ``ppde_tpu/samplers/protein/random_search.py`` (parity with
the reference RandomSampler, protein_samplers/random.py:8-137): the SA
proposal, always FROM THE INITIAL population (the reference never
reassigns ``x``, :82-89), every proposal "accepted", no nmut constraint.
Best per chain is the argmax-energy proposal seen in the run.

Random numbers, in order: the [n] uniforms of mu, then per step the
proposal's draws (``sa.propose``).
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.protein import sa


@dataclasses.dataclass(frozen=True)
class RandomConfig:
    muts_per_seq_param: float = 1.5
    max_edits: int = 12


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: RandomConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as ppde.run."""
    cfg = cfg or RandomConfig()
    draws, x0, mu, e0, fit0 = sa.start(energy, initial_population,
                                       cfg.muts_per_seq_param, generator,
                                       draws, device)
    ctx = {"energy": energy.params, "init_x": x0, "mu": mu}
    oracle_fn = sa.attach_oracle(ctx, oracle)

    def step(ctx, state, draws):
        _, best = state
        y = sa.propose(draws, ctx["init_x"], ctx["mu"], min_pos, max_pos,
                       cfg.max_edits)
        e_p, fit_p = energy.energy(ctx["energy"], y)
        best = base.update_best(best, e_p, fit_p, y)
        ys = {"energy": e_p, "fitness": fit_p,
              "traj": y[0].argmax(-1).to(torch.int8)}
        return (y, best), ys

    with torch.no_grad():
        (final_x, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(x0, (e0, fit0, x0)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("Random"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x0[0],
                               traj_tokens=True, best=best, final_x=final_x,
                               rec=rec)
