"""MALA-approx: Langevin dynamics on a Gumbel-softmax relaxation.

Counterpart of ``ppde_tpu/samplers/protein/mala_approx.py`` (parity with the
reference MALAApprox, protein_samplers/mala_approx.py:7-123): the window
[min_pos, max_pos] is relaxed to logits initialised from (1 - tau) *
uniform + tau * onehot; each step draws a Gumbel-softmax sample,
discretises it straight-through, evaluates the energy of the full sequence
and moves the logits to logits + (eta / 2) dE/dlogits + eta^2 * N(0, 1).
No MH correction (as in the reference). The gradient is autograd through
``energy.energy`` (plain PyTorch, as the JAX version is plain XLA).

Random numbers, in order per step: the Gumbel noise of the logits' shape,
then the normal noise of the same shape.
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base


@dataclasses.dataclass(frozen=True)
class MALAConfig:
    step_size: float = 0.1
    relaxation_tau: float = 0.99


def gumbel_softmax_st(gumbel: torch.Tensor, logits: torch.Tensor,
                      tau: float) -> torch.Tensor:
    """Straight-through Gumbel-softmax one-hot rows from the noise
    ``gumbel`` (RelaxedOneHotCategorical.rsample + argmax, reference
    :18-23,37-40): the value is the one-hot, the gradient the softmax's."""
    soft = torch.softmax((logits + gumbel) / tau, dim=-1)
    hard = torch.nn.functional.one_hot(soft.argmax(-1),
                                       logits.shape[-1]).to(soft.dtype)
    return soft + (hard - soft).detach()


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: MALAConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as ppde.run."""
    cfg = cfg or MALAConfig()
    device = utils.resolve_device(device)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draws = base.Draws(generator)
    x0 = torch.as_tensor(initial_population, dtype=torch.float32).to(device)
    n, L, V = x0.shape
    center = x0[:, min_pos:max_pos + 1]
    # initial relaxed logits (reference :36-39)
    soft = ((1 - cfg.relaxation_tau) * (torch.ones_like(center) / V)
            + cfg.relaxation_tau * center)
    logits0 = torch.log(soft)

    def assemble(ctx, center_hard):
        return torch.cat([ctx["left"], center_hard, ctx["right"]], dim=1)

    def step(ctx, state, draws):
        logits, best = state
        g_noise = draws.gumbel(logits.shape)
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            full = assemble(ctx, gumbel_softmax_st(g_noise, lg,
                                                   cfg.relaxation_tau))
            e, fit = energy.energy(ctx["energy"], full)
            (g,) = torch.autograd.grad(e.sum(), lg)
        e, fit, full = e.detach(), fit.detach(), full.detach()
        noise = draws.normal(logits.shape) * cfg.step_size ** 2
        new_logits = logits + (cfg.step_size / 2.0) * g + noise
        best = base.update_best(best, e, fit, full)
        ys = {"energy": e, "fitness": fit,
              "traj": full[0].argmax(-1).to(torch.int8)}
        return (new_logits, best), ys

    ctx = {"energy": energy.params, "left": x0[:, :min_pos],
           "right": x0[:, max_pos + 1:]}

    def hard_of(logits):
        return torch.nn.functional.one_hot(logits.argmax(-1), V).float()

    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]

        def oracle_fn(c, s):
            return oracle[1](c["oracle"], assemble(c, hard_of(s[0])))

    with torch.no_grad():
        e0, fit0 = energy.energy(ctx["energy"], x0)
        (final_logits, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(logits0, (e0, fit0, x0)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("MALA-approx"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
        final_x = assemble(ctx, hard_of(final_logits))
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x0[0],
                               traj_tokens=True, best=best, final_x=final_x,
                               rec=rec)
