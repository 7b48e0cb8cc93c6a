"""PPDE sampler for binary MNIST: Gibbs-With-Gradients / Path-Auxiliary.

Counterpart of ``ppde_tpu/samplers/mnist/ppde.py`` (parity with the
reference PPDE, mnist_samplers/ppde.py:10-173): the first-order flip score
grad * (-(2x - 1)) / temp, a pixel-flip categorical over the 784 pixels;
two modes:
  * pas_length > 0: a PAS path of U ~ U[1, 2 * pas_length) flips, the
    first always applied (:84-88), later ones gated by t < U, with the
    reverse path's log-ratio at the forward indices (a bit flip is its own
    inverse, so the reverse move from x_{t+1} is the same index);
  * pas_length == 0: multi-sample GWG, n_samples ~ U[1, 2 * gwg_samples)
    flips applied as a union (:79-88,125-137).
MH accept per chain with a strict '>' (:141). The path's inner loop is a
Python loop over its maximum length with masking; a step syncs nothing.

Random numbers, in order per step. PAS: the path lengths [n] in
[1, 2 * pas_length), then per inner step the Gumbel noise [n, 784] of the
flip categorical, then the accept uniforms [n]. GWG: one sample count [1]
in [1, 2 * gwg_samples), the Gumbel noise [max_s, n, 784] of all samples,
the accept uniforms [n]. A categorical draw is the argmax of Gumbel noise
plus the logits, as ``jax.random.categorical`` is, so a test can replay the
JAX package's draws.
"""
from __future__ import annotations

import dataclasses

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.base import Draws


@dataclasses.dataclass(frozen=True)
class MNISTPPDEConfig:
    pas_length: int = 10
    gwg_samples: int = 1
    temp: float = 2.0


def _flip_scores(x, grad):
    """Flip score (approximate energy change) per pixel: grad * -(2x-1)."""
    return grad * -(2.0 * x - 1.0)


def _log_prob_at(logits, idx):
    """log softmax(logits)[idx] along the last dim; idx has logits' shape
    without it."""
    picked = logits.gather(-1, idx[..., None])[..., 0]
    return picked - torch.logsumexp(logits, -1)


def _finish(energy, ctx, state, y, log_ratio, e_prop, fit_prop, grad_y,
            tempered, draws, n):
    """MH accept (strict '>') and the step's new state and records."""
    x2, (e_cur, fit_cur, grad), best = state
    d_e = e_prop - e_cur
    if tempered:
        d_e = d_e * ctx["beta"]
    accepted = torch.exp(d_e + log_ratio) > draws.uniform(n)
    acc2 = accepted[:, None]
    new_x2 = torch.where(acc2, y, x2)
    new_e = torch.where(accepted, e_prop, e_cur)
    new_fit = torch.where(accepted, fit_prop, fit_cur)
    new_grad = torch.where(acc2, grad_y, grad)
    best = base.update_best(best, new_e, new_fit, new_x2)
    ys = {"energy": new_e, "fitness": new_fit, "accepted": accepted,
          "traj": new_x2[0].to(torch.uint8)}
    return (new_x2, (new_e, new_fit, new_grad), best), ys


def make_step_pas(energy: Energy, cfg: MNISTPPDEConfig, n: int, D: int,
                  tempered: bool = False):
    """The PAS step (ctx, state, draws) -> (state, ys).

    tempered: ctx also holds per-chain inverse temperatures 'beta' [n]; a
    chain then targets pi(x) ~ exp(beta * E(x)): the proposals take
    beta * grad (flip scores are linear in grad) and the MH ratio beta * dE.
    The carried grad stays the raw dE/dx, so states swap between levels
    without rescaling (``samplers/mnist/pt.py``)."""
    max_u = max(2 * cfg.pas_length - 1, 1)

    def step(ctx, state, draws):
        x2, (_, _, grad), _ = state
        beta2 = ctx["beta"][:, None] if tempered else None
        U = draws.path_lengths(n, 2 * cfg.pas_length)               # [n]
        g_fwd = grad * beta2 if tempered else grad
        x = x2
        idxs, fwd_logps, traj = [], [], []
        for t in range(max_u):
            logits = _flip_scores(x, g_fwd) / cfg.temp
            idx = (draws.gumbel((n, D)) + logits).argmax(-1)        # [n]
            fwd_logps.append(_log_prob_at(logits, idx))
            flip = torch.nn.functional.one_hot(idx, D).to(x.dtype)
            x_new = utils.flip_bits(x, flip)
            if t > 0:  # the first flip is always applied
                x_new = torch.where((t < U)[:, None], x_new, x)
            x = x_new
            idxs.append(idx)
            traj.append(x)
        y = x
        e_prop, fit_prop, grad_y = energy.energy_and_grad(ctx["energy"], y,
                                                          ctx["x1"])
        g_rev = grad_y * beta2 if tempered else grad_y
        rev_logits = _flip_scores(torch.stack(traj), g_rev[None]) / cfg.temp
        rev_logps = _log_prob_at(rev_logits, torch.stack(idxs))  # [max_u,n]
        u_mask = torch.arange(max_u, device=U.device)[:, None] < U[None, :]
        u_mask[0] = True
        log_ratio = (u_mask * (rev_logps - torch.stack(fwd_logps))).sum(0)
        return _finish(energy, ctx, state, y, log_ratio, e_prop, fit_prop,
                       grad_y, tempered, draws, n)

    return step


def make_step_gwg(energy: Energy, cfg: MNISTPPDEConfig, n: int, D: int,
                  tempered: bool = False):
    """The GWG step; tempered: as ``make_step_pas``."""
    max_s = max(2 * cfg.gwg_samples - 1, 1)

    def step(ctx, state, draws):
        x2, (_, _, grad), _ = state
        beta2 = ctx["beta"][:, None] if tempered else None
        n_samples = draws.path_lengths(1, 2 * cfg.gwg_samples)      # [1]
        g_fwd = grad * beta2 if tempered else grad
        fwd_logits = _flip_scores(x2, g_fwd) / cfg.temp
        idxs = (draws.gumbel((max_s, n, D)) + fwd_logits).argmax(-1)
        live = torch.arange(max_s, device=x2.device) < n_samples  # [max_s]
        onehots = torch.nn.functional.one_hot(idxs, D).to(x2.dtype)
        changes = ((live[:, None, None] * onehots).sum(0) > 0).to(x2.dtype)
        y = utils.flip_bits(x2, changes)
        e_prop, fit_prop, grad_y = energy.energy_and_grad(ctx["energy"], y,
                                                          ctx["x1"])
        g_rev = grad_y * beta2 if tempered else grad_y
        rev_logits = _flip_scores(y, g_rev) / cfg.temp
        fwd_lp = _log_prob_at(fwd_logits.expand(max_s, -1, -1), idxs)
        rev_lp = _log_prob_at(rev_logits.expand(max_s, -1, -1), idxs)
        log_ratio = (live[:, None] * (rev_lp - fwd_lp)).sum(0)
        return _finish(energy, ctx, state, y, log_ratio, e_prop, fit_prop,
                       grad_y, tempered, draws, n)

    return step


def make_step(energy: Energy, cfg: MNISTPPDEConfig, n: int, D: int,
              tempered: bool = False):
    """PAS when ``cfg.pas_length > 0``, else GWG."""
    make = make_step_pas if cfg.pas_length > 0 else make_step_gwg
    return make(energy, cfg, n, D, tempered)


def split_population(initial_population, device):
    """[n, 2D] (x1 | x2) on ``device`` -> (x1, x2), each [n, D]."""
    pop = torch.as_tensor(initial_population, dtype=torch.float32).to(device)
    D = pop.shape[1] // 2
    return pop[:, :D], pop[:, D:]


def make_draws(generator, draws, device):
    """The run's ``Draws``: ``draws`` if given, else one on ``generator``
    (default: seed 0 on ``device``)."""
    if draws is not None:
        return draws
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return Draws(generator)


def run(energy: Energy, initial_population, num_steps: int, min_pos: int = 0,
        max_pos: int = 784, oracle=None, cfg: MNISTPPDEConfig | None = None,
        generator: torch.Generator | None = None, draws: Draws | None = None,
        log_every: int = 50, quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """initial_population: [n, 2 * 784], (x1 | x2) per chain; x2 evolves.
    oracle: optional (params, apply_fn) pair; apply_fn(params, x2, x1) ->
    [n]. generator / draws / checkpoint_dir: as the protein ``ppde.run``.
    min_pos / max_pos are accepted for the common sampler signature and
    unused, as in the JAX package."""
    cfg = cfg or MNISTPPDEConfig()
    device = utils.resolve_device(device)
    draws = make_draws(generator, draws, device)
    x1, x2 = split_population(initial_population, device)
    n, D = x2.shape

    ctx = {"energy": energy.params, "x1": x1}
    oracle_fn = None
    if oracle is not None:
        ctx["oracle"] = oracle[0]
        oracle_fn = lambda c, s: oracle[1](c["oracle"], s[0], c["x1"])  # noqa: E731

    with torch.no_grad():
        e0, fit0, grad0 = energy.energy_and_grad(ctx["energy"], x2, x1)
        step = make_step(energy, cfg, n, D)
        (final_x2, _, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(x2, (e0, fit0, grad0),
                                               (e0, fit0, x2)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("PPDE"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x2[0],
                               best=best, final_x=final_x2, rec=rec)
