"""Parallel-tempering PPDE (PT-PAS) for proteins.

Counterpart of ``ppde_tpu/samplers/protein/pt.py``. The chain batch is
``n_levels`` temperature levels x ``M`` replicas; every chain runs the PAS
step against its tempered target pi_l(x) ~ exp(beta_l * E(x))
(``ppde.make_step(tempered=True)``: the carried grad stays the raw dE/dx),
and after each step adjacent levels attempt state swaps
(``samplers/pt_core.py``) with
    P(swap) = min(1, exp((beta_i - beta_j) * (E_j - E_i))).

Random numbers, in order per step: the PPDE step's draws (``ppde``'s
docstring), then the [K, M] swap uniforms.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base, pt_core
from ppde_tpu_torch.samplers.protein import ppde


@dataclasses.dataclass(frozen=True)
class PTConfig(ppde.PPDEConfig):
    n_levels: int = 8        # temperature levels K (n_chains % K == 0)
    beta_min: float = 0.25   # hottest inverse temperature; ladder is
    #                          geometric: beta_l = beta_min ** (l / (K-1))
    swap_every: int = 1      # attempt exchanges every this many steps


def ladder(n_chains: int, cfg: PTConfig) -> np.ndarray:
    """Per-chain inverse temperatures [n_chains] (see pt_core.ladder)."""
    return pt_core.ladder(n_chains, cfg.n_levels, cfg.beta_min)


def make_pt_step(energy: Energy, cfg: PTConfig, window_ok: torch.Tensor,
                 n: int, L: int, V: int):
    """(ctx, state, draws) -> (state, ys) with state = (core, count); core
    is the ppde step state, count the host step counter (swap parity).

    ctx also holds 'beta' [n]."""
    inner = ppde.make_step(energy, cfg, window_ok, n, L, V, tempered=True)
    exchange = pt_core.make_exchange(n, cfg.n_levels, cfg.swap_every,
                                     window_ok.device)

    def step(ctx, state, draws):
        core, count = state
        core, ys = inner(ctx, core, draws)
        cur_x, (e, fit, grad), best = core
        (cur_x, e, fit, grad), n_swapped = exchange(
            ctx["beta"], e, count, draws, [cur_x, e, fit, grad])
        # post-swap bookkeeping: records, best and traj follow the state a
        # chain holds after the whole PT step
        best = base.update_best(best, e, fit, cur_x)
        ys = dict(ys, energy=e, fitness=fit,
                  traj=cur_x[0].argmax(-1).to(torch.int8),
                  n_swapped=n_swapped)
        return ((cur_x, (e, fit, grad), best), count + 1), ys

    return step


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: PTConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as ppde.run; chains [c*M:(c+1)*M] run at ladder level
    c (level 0 = cold, beta = 1: those chains sample the actual target)."""
    cfg = cfg or PTConfig()
    if cfg.paper_results:
        raise ValueError("paper_results (reset-to-WT on rejection) is a "
                         "legacy reference mode; combining it with replica "
                         "exchange has no reference semantics to preserve")
    device = utils.resolve_device(device)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draws = base.Draws(generator)
    x0 = torch.as_tensor(initial_population, dtype=torch.float32).to(device)
    n, L, V = x0.shape
    window_ok = utils.position_window_mask(L, V, min_pos, max_pos, device)

    ctx = {"energy": energy.params, "wt": x0[0], "init_x": x0,
           "beta": torch.from_numpy(ladder(n, cfg)).to(device)}
    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]
        oracle_fn = lambda c, s: oracle[1](c["oracle"], s[0][0])  # noqa: E731

    with torch.no_grad():
        e0, fit0, grad0 = energy.energy_and_grad(ctx["energy"], x0)
        ctx["wt_e"], ctx["wt_fit"], ctx["wt_grad"] = e0[0], fit0[0], grad0[0]
        step = make_pt_step(energy, cfg, window_ok, n, L, V)
        ((final_x, _, best), _), rec = base.run_segmented(
            step_fn=step, ctx=ctx,
            init_state=((x0, (e0, fit0, grad0), (e0, fit0, x0)), 0),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("PT-PPDE"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x0[0],
                               traj_tokens=True, best=best, final_x=final_x,
                               rec=rec)
