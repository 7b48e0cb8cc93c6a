"""MALA-approx for binary MNIST: Langevin on a relaxed-Bernoulli relaxation.

Counterpart of ``ppde_tpu/samplers/mnist/mala_approx.py`` (parity with the
reference mnist_samplers/mala_approx.py:7-90): logits initialised from
(1 - tau) * 0.5 + tau * x2; per step a relaxed Bernoulli sample (logistic
reparameterisation) discretised straight-through by rounding, the energy's
gradient with respect to the logits by autograd, and the update
logits <- logits + (eta / 2) g + eta^2 * N(0, 1). No MH correction.

Random numbers, in order per step: the uniforms in [1e-6, 1 - 1e-6) of the
logits' shape, then the normal noise of the same shape.
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.mnist import ppde


@dataclasses.dataclass(frozen=True)
class MNISTMALAConfig:
    step_size: float = 0.01
    relaxation_tau: float = 0.9


def relaxed_bernoulli_st(u: torch.Tensor, logits: torch.Tensor,
                         tau: float) -> torch.Tensor:
    """Straight-through relaxed Bernoulli sample from the uniforms ``u``
    (logistic reparameterisation, then rounding): the value is binary, the
    gradient the relaxation's."""
    logistic = torch.log(u) - torch.log1p(-u)
    soft = torch.sigmoid((logits + logistic) / tau)
    return soft + (torch.round(soft) - soft).detach()


def run(energy: Energy, initial_population, num_steps: int, min_pos: int = 0,
        max_pos: int = 784, oracle=None, cfg: MNISTMALAConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as mnist.ppde.run."""
    cfg = cfg or MNISTMALAConfig()
    device = utils.resolve_device(device)
    draws = ppde.make_draws(generator, draws, device)
    x1, x2 = ppde.split_population(initial_population, device)
    p0 = (1 - cfg.relaxation_tau) * 0.5 + cfg.relaxation_tau * x2
    logits0 = torch.log(p0) - torch.log1p(-p0)
    ctx = {"energy": energy.params, "x1": x1}

    def step(ctx, state, draws):
        logits, best = state
        u = draws.uniform(logits.shape, 1e-6, 1 - 1e-6)
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            xh = relaxed_bernoulli_st(u, lg, cfg.relaxation_tau)
            e, fit = energy.energy(ctx["energy"], xh, ctx["x1"])
            (g,) = torch.autograd.grad(e.sum(), lg)
        e, fit, xh = e.detach(), fit.detach(), xh.detach()
        noise = draws.normal(logits.shape) * cfg.step_size ** 2
        new_logits = logits + (cfg.step_size / 2.0) * g + noise
        best = base.update_best(best, e, fit, xh)
        ys = {"energy": e, "fitness": fit, "traj": xh[0].to(torch.uint8)}
        return (new_logits, best), ys

    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]

        def oracle_fn(c, s):
            return oracle[1](c["oracle"], (s[0] > 0).float(), c["x1"])

    with torch.no_grad():
        e0, fit0 = energy.energy(ctx["energy"], x2, x1)
        (final_logits, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(logits0, (e0, fit0, x2)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("MALA-approx"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x2[0],
                               best=best, final_x=(final_logits > 0).float(),
                               rec=rec)
