"""Simulated annealing for binary MNIST.

Counterpart of ``ppde_tpu/samplers/mnist/sa.py`` (parity with the
reference mnist_samplers/sa.py:8-120): per chain Poisson(mu_i - 1) + 1
random pixel flips at distinct positions, Metropolis acceptance at
T = T_max * decay^step, and, as in the reference, whose rejection fallback
``x2`` is never reassigned (:91), rejected chains reset to the INITIAL
image.

Random numbers, in order: at the start of a run the [n] uniforms of mu;
per step the Poisson edit counts [n], the Gumbel noise over pixels
[n, 784] (its top ``max_edits`` are the distinct positions), the accept
uniforms [n]. The step counter is a host integer, so the temperature is a
host number; a checkpoint saves it as a leaf. A resumed run draws mu again
from its freshly seeded generator before the checkpoint's state replaces
that state, so mu is the uncut run's.
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.mnist import ppde


@dataclasses.dataclass(frozen=True)
class MNISTSAConfig:
    temp: float = 10.0
    muts_per_seq_param: float = 5.0
    decay_rate: float = 0.999
    max_edits: int = 24


def propose_flips(draws, x: torch.Tensor, mu: torch.Tensor,
                  max_edits: int) -> torch.Tensor:
    """Poisson(mu - 1) + 1 distinct pixel flips per chain, at most
    ``max_edits`` (reference :20-45)."""
    n, D = x.shape
    n_edits = (draws.poisson(mu - 1.0) + 1).clamp(1, max_edits).long()
    pos = draws.gumbel((n, D)).topk(max_edits, dim=-1).indices  # [n, E]
    slots = (torch.arange(max_edits, device=x.device)[None]
             < n_edits[:, None]).to(x.dtype)
    flip = torch.zeros_like(x).scatter(1, pos, slots)  # distinct positions
    return utils.flip_bits(x, flip)


def run(energy: Energy, initial_population, num_steps: int, min_pos: int = 0,
        max_pos: int = 784, oracle=None, cfg: MNISTSAConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as mnist.ppde.run."""
    cfg = cfg or MNISTSAConfig()
    device = utils.resolve_device(device)
    draws = ppde.make_draws(generator, draws, device)
    x1, x2_init = ppde.split_population(initial_population, device)
    n = x2_init.shape[0]
    mu = cfg.muts_per_seq_param * draws.uniform(n) + 1.0

    ctx = {"energy": energy.params, "x1": x1, "init_x2": x2_init, "mu": mu}
    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]
        oracle_fn = lambda c, s: oracle[1](c["oracle"], s[0], c["x1"])  # noqa: E731

    def step(ctx, state, draws):
        x, cur_e, cur_fit, step_i, best = state
        y = propose_flips(draws, x, ctx["mu"], cfg.max_edits)
        e_p, fit_p = energy.energy(ctx["energy"], y, ctx["x1"])
        T = cfg.temp * cfg.decay_rate ** step_i
        ap = torch.exp((e_p - cur_e) / T).clamp(max=1.0)
        accepted = ap > draws.uniform(n)
        acc2 = accepted[:, None]
        new_x = torch.where(acc2, y, ctx["init_x2"])  # rejection -> initial
        new_e = torch.where(accepted, e_p, cur_e)
        new_fit = torch.where(accepted, fit_p, cur_fit)
        best = base.update_best(best, new_e, new_fit, new_x)
        ys = {"energy": new_e, "fitness": new_fit, "accepted": accepted,
              "traj": new_x[0].to(torch.uint8)}
        return (new_x, new_e, new_fit, step_i + 1, best), ys

    with torch.no_grad():
        e0, fit0 = energy.energy(ctx["energy"], x2_init, x1)
        (final_x2, _, _, _, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx,
            init_state=(x2_init, e0, fit0, 0, (e0, fit0, x2_init)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("SA"), quiet=quiet,
            checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x2_init[0],
                               best=best, final_x=final_x2, rec=rec)
