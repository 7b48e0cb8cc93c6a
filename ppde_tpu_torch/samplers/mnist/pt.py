"""Parallel-tempering PPDE for binary MNIST (beyond the reference).

Counterpart of ``ppde_tpu/samplers/mnist/pt.py``, the MNIST twin of
``samplers/protein/pt.py``: the chain batch is ``n_levels`` temperature
levels x ``M`` replicas, every chain runs the PAS/GWG flip step against its
tempered target pi_l(x2) ~ exp(beta_l * E(x2; x1)), and adjacent levels
attempt state swaps (``samplers/pt_core.py``, where the detailed-balance
argument lives).

The MNIST energy is conditioned on the fixed first digit x1 per chain, so
a swap is only meaningful between chains with the same x1: ``run`` checks
that each replica column shares one x1 across all levels (the CLI's tiled
wild-type population does; a heterogeneous x1 batch raises).

Random numbers, in order per step: the PAS/GWG step's draws (``ppde``'s
docstring), then the [K, M] swap uniforms. The step counter is a host
integer (the swap parity), saved in checkpoints as a leaf.
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base, pt_core
from ppde_tpu_torch.samplers.mnist import ppde


@dataclasses.dataclass(frozen=True)
class MNISTPTConfig(ppde.MNISTPPDEConfig):
    n_levels: int = 8        # temperature levels K (n_chains % K == 0)
    beta_min: float = 0.25   # hottest inverse temperature (geometric ladder)
    swap_every: int = 1      # attempt exchanges every this many steps


def make_pt_step(energy: Energy, cfg: MNISTPTConfig, n: int, D: int,
                 device):
    """(ctx, state, draws) -> (state, ys); state = (core, count). ctx holds
    'beta' [n] in addition to the plain MNIST step's 'energy' / 'x1'."""
    inner = ppde.make_step(energy, cfg, n, D, tempered=True)
    exchange = pt_core.make_exchange(n, cfg.n_levels, cfg.swap_every, device)

    def step(ctx, state, draws):
        core, count = state
        core, ys = inner(ctx, core, draws)
        x2, (e, fit, grad), best = core
        (x2, e, fit, grad), n_swapped = exchange(
            ctx["beta"], e, count, draws, [x2, e, fit, grad])
        best = base.update_best(best, e, fit, x2)
        ys = dict(ys, energy=e, fitness=fit, traj=x2[0].to(torch.uint8),
                  n_swapped=n_swapped)
        return ((x2, (e, fit, grad), best), count + 1), ys

    return step


def run(energy: Energy, initial_population, num_steps: int, min_pos: int = 0,
        max_pos: int = 784, oracle=None, cfg: MNISTPTConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as mnist.ppde.run; chains [c*M:(c+1)*M] run at ladder
    level c (level 0 = cold, beta = 1: those chains sample the target)."""
    cfg = cfg or MNISTPTConfig()
    device = utils.resolve_device(device)
    draws = ppde.make_draws(generator, draws, device)
    x1, x2 = ppde.split_population(initial_population, device)
    n, D = x2.shape
    beta = pt_core.ladder(n, cfg.n_levels, cfg.beta_min)
    # swaps move x2 between levels of one replica column; the conditioning
    # x1 must therefore be level-invariant per column
    x1_cols = x1.reshape(cfg.n_levels, n // cfg.n_levels, D)
    if not bool((x1_cols == x1_cols[:1]).all()):
        raise ValueError(
            "PT requires each replica column to share one x1 across all "
            "temperature levels (tile the wild-type pair, as the CLI does)")

    ctx = {"energy": energy.params, "x1": x1,
           "beta": torch.from_numpy(beta).to(device)}
    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]
        oracle_fn = lambda c, s: oracle[1](c["oracle"], s[0][0], c["x1"])  # noqa: E731

    with torch.no_grad():
        e0, fit0, grad0 = energy.energy_and_grad(ctx["energy"], x2, x1)
        step = make_pt_step(energy, cfg, n, D, device)
        ((final_x2, _, best), _), rec = base.run_segmented(
            step_fn=step, ctx=ctx,
            init_state=((x2, (e0, fit0, grad0), (e0, fit0, x2)), 0),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("PT-PPDE"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x2[0],
                               best=best, final_x=final_x2, rec=rec)
