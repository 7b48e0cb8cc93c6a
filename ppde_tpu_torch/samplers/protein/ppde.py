"""PPDE sampler (gradient-informed Path-Auxiliary Sampler) for proteins.

Counterpart of ``ppde_tpu/samplers/protein/ppde.py`` (algorithmic parity
with the reference PPDE_PAS, protein_samplers/ppde.py:8-192). Per outer
step: U ~ U[1, 2*pas_length) single-substitution moves drawn from the
first-order Taylor proposal with window and hard-nmut masking, one fused
energy+grad at the path's endpoint, a reverse-path log-ratio, and a
per-chain MH accept. The current state's (e, fit, grad) is carried from the
previous step (exact: energies are deterministic).

The proposal is factored as in the JAX package: because states are one-hot,
the [L, V] Taylor softmax splits into a position categorical with
log-weights ``logsumexp_v(grad[l] / temp) - grad[l, tok[l]] / temp`` and a
value conditional ``softmax(grad[l] / temp)`` that is constant along the
path; the reverse path reduces to logZ updates with one changed position
per step. Gathers and scatters are used freely here (the JAX package's
no-gather rule is a TPU layout rule).

Every random number comes from one ``Draws`` object, in a fixed order: the
path lengths, then per inner step the Gumbel noise of the position and of
the value categorical, then the accept uniforms. A test can hand a step the
JAX package's own draws this way (``jax.random.categorical`` is the argmax of
Gumbel noise plus the logits).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ppde_tpu_torch import profiling, utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.base import Draws


@dataclasses.dataclass(frozen=True)
class PPDEConfig:
    pas_length: int = 2
    nmut_threshold: int = 0      # 0 disables the hard constraint
    paper_results: bool = False  # reset rejected chains to the initial state
    temp: float = 2.0            # locally-balanced g(t)=sqrt(t) temperature
    # True reproduces the reference's reverse estimator, which evaluates the
    # reverse log-probs at the FORWARD indices (gathered logit identically
    # 0; protein_samplers/ppde.py:126-132) and is biased toward high
    # energies. False = the true reverse moves (see the JAX package).
    reference_reverse: bool = False


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[n, idx[n]] for t [N, K] (or [N, K, V] -> [N, V]) and idx [N]."""
    if t.ndim == 2:
        return t.gather(1, idx[:, None])[:, 0]
    return t.gather(1, idx[:, None, None].expand(-1, 1, t.shape[2]))[:, 0]


def position_log_weights(lA, g_wt, g_tok, revertible, over):
    """Log-weights [N, L] of the factored position categorical.

    lA [N,L]: logsumexp over the in-window values of grad/temp; g_wt, g_tok
    [N,L]: grad/temp at the WT and at the current token; revertible [N,L]:
    in-window positions that differ from WT; over [N]: chains at the nmut
    budget, which may only revert a mutated position to WT (reference
    :86-104 masks).
    """
    return torch.where(
        over[:, None],
        torch.where(revertible, g_wt - g_tok, utils.NEG_INF),
        lA - g_tok)


def make_step(energy: Energy, cfg: PPDEConfig, window_ok: torch.Tensor,
              n: int, L: int, V: int, tempered: bool = False):
    """The outer-step function (ctx, state, draws) -> (state, ys).

    ctx must hold 'energy' (params), 'wt' [L,V], 'init_x' [N,L,V] and the
    wild-type constants 'wt_e', 'wt_fit', 'wt_grad' (plus 'init_e',
    'init_fit', 'init_grad' with paper_results).

    tempered: ctx also holds per-chain inverse temperatures 'beta' [N]; a
    chain then targets pi(x) ~ exp(beta * E(x)): the proposals take
    beta * grad and the MH ratio beta * dE. The carried grad stays the raw
    dE/dx, so states swap between levels without rescaling
    (``samplers/protein/pt.py``). beta == 1 gives the plain step's values.
    """
    max_u = max(2 * cfg.pas_length - 1, 1)
    nmut = (cfg.nmut_threshold if cfg.nmut_threshold > 0
            else int(np.iinfo(np.int32).max))

    def step(ctx, state, draws):
        with profiling.span("ppde.proposal"):
            cur_x, (e_cur, fit_cur, grad_x), best = state
            wt = ctx["wt"]
            wt_tok = wt.argmax(-1)                                      # [L]
            wt_in_win = (window_ok & (wt > 0)).any(-1)                  # [L]
            beta3 = ctx["beta"][:, None, None] if tempered else None

            U = draws.path_lengths(n, 2 * cfg.pas_length)               # [N]
            u_mask = (torch.arange(max_u, device=U.device)[:, None]
                      < U[None, :])                             # [max_u,N]

            # ---- forward path over token sequences (factored proposals) ----
            gx = grad_x.float()
            if tempered:
                gx = gx * beta3
            gx = gx / cfg.temp                                      # [N,L,V]
            v_logits = torch.where(window_ok[None], gx, utils.NEG_INF)
            lA = torch.logsumexp(v_logits, -1)                          # [N,L]
            g_wt = gx.gather(2, wt_tok.expand(n, L)[..., None])[..., 0]
            tok0 = cur_x.argmax(-1)                                     # [N,L]
            g_tok0 = gx.gather(2, tok0[..., None])[..., 0]
            dist0 = (tok0 != wt_tok[None]).sum(-1)

            tok, g_tok, dist = tok0, g_tok0, dist0
            l_ids, v_ids, o_ids, fwd_logps = [], [], [], []
            for t in range(max_u):
                live = u_mask[t]
                over = dist >= nmut
                lw = position_log_weights(
                    lA, g_wt, g_tok, (tok != wt_tok[None]) & wt_in_win[None],
                    over)                                               # [N,L]
                l_idx = (draws.gumbel((n, L)) + lw).argmax(-1)          # [N]
                vl = _pick(v_logits, l_idx)                             # [N,V]
                v_free = (draws.gumbel((n, V)) + vl).argmax(-1)
                wt_at_l = wt_tok[l_idx]
                v_idx = torch.where(over, wt_at_l, v_free)
                lp_pos = _pick(lw, l_idx) - torch.logsumexp(lw, -1)
                g_new = _pick(vl, v_idx)
                lp_val = (g_new - torch.logsumexp(vl, -1)).masked_fill(
                    over, 0.0)
                old_v = _pick(tok, l_idx)
                col = l_idx[:, None]
                tok = tok.scatter(
                    1, col, torch.where(live, v_idx, old_v)[:, None])
                g_tok = g_tok.scatter(1, col, torch.where(
                    live, g_new, _pick(g_tok, l_idx))[:, None])
                dist = dist + live * ((v_idx != wt_at_l).long()
                                      - (old_v != wt_at_l).long())
                l_ids.append(l_idx)
                v_ids.append(v_idx)
                o_ids.append(old_v)
                fwd_logps.append(lp_pos + lp_val)
            dist_y = dist

            y = torch.nn.functional.one_hot(tok, V).to(cur_x.dtype)
        e_prop, fit_prop, grad_y = energy.energy_and_grad(ctx["energy"], y)

        with profiling.span("ppde.accept"):
            # ---- reverse path: log q(reverse move | x_{t+1}) under the
            # grad_y-anchored temp-2 proposal. The true reverse move re-sets
            # position l_t to the OLD value o_t: logit gy[l_t, o_t] - gy[l_t,
            # v_t]; the reference gathers (l_t, v_t), whose logit is 0.
            gy = grad_y.float()
            if tempered:
                gy = gy * beta3
            gy = gy / 2.0
            lsY = torch.logsumexp(gy, -1)                               # [N,L]
            gy_tok = gy.gather(2, tok0[..., None])[..., 0]              # [N,L]
            rev_logps = []
            for t in range(max_u):
                rows = _pick(gy, l_ids[t])                              # [N,V]
                gy_new = _pick(rows, v_ids[t])
                picked = (0.0 if cfg.reference_reverse
                          else _pick(rows, o_ids[t]) - gy_new)
                col = l_ids[t][:, None]
                gy_tok = gy_tok.scatter(1, col, torch.where(
                    u_mask[t], gy_new, _pick(gy_tok, l_ids[t]))[:, None])
                rev_logps.append(picked - torch.logsumexp(lsY - gy_tok, -1))
            log_ratio = (u_mask * (torch.stack(rev_logps)
                                   - torch.stack(fwd_logps))).sum(0)

            d_e = e_prop - e_cur
            if tempered:
                d_e = d_e * ctx["beta"]
            log_acc = d_e + log_ratio
            accepted = torch.exp(log_acc) >= draws.uniform(n)
            acc3 = accepted.reshape(n, 1, 1)
            fallback = ctx["init_x"] if cfg.paper_results else cur_x
            new_x = torch.where(acc3, y, fallback)
            new_e = torch.where(accepted, e_prop, e_cur)
            new_fit = torch.where(accepted, fit_prop, fit_cur)
            new_grad = torch.where(acc3, grad_y, grad_x)
            rec_e, rec_fit = new_e, new_fit
            if cfg.paper_results:
                # rejection resets to the PER-CHAIN initial state; the
                # recorded history keeps the pre-reset energies (reference
                # :141, :148-153)
                new_grad = torch.where(acc3, grad_y, ctx["init_grad"])
                new_e = torch.where(accepted, e_prop, ctx["init_e"])
                new_fit = torch.where(accepted, fit_prop, ctx["init_fit"])

            best = base.update_best(best, rec_e, rec_fit, new_x)
            traj_row = new_x[0].argmax(-1).to(torch.int8)

            if not cfg.paper_results:
                # hard constraint: chains that hit the budget restart from WT
                # (recorded energy/x stay pre-reset); the carried energy, fit
                # and grad switch to the precomputed WT values
                over = torch.where(accepted, dist_y, dist0) >= nmut
                over3 = over.reshape(n, 1, 1)
                new_x = torch.where(over3, wt[None], new_x)
                new_e = torch.where(over, ctx["wt_e"], new_e)
                new_fit = torch.where(over, ctx["wt_fit"], new_fit)
                new_grad = torch.where(over3, ctx["wt_grad"][None], new_grad)

        ys = {"energy": rec_e, "fitness": rec_fit, "accepted": accepted,
              "traj": traj_row}
        return (new_x, (new_e, new_fit, new_grad), best), ys

    return step


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: PPDEConfig | None = None,
        generator: torch.Generator | None = None, draws: Draws | None = None,
        log_every: int = 50, quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Sampler contract parity with BaseSampler.run (base_sampler.py:7-15).

    initial_population: [N, L, V] one-hots; chain 0 is the wild type.
    oracle: optional (params, apply_fn) pair; apply_fn(params, x) -> [N].
    generator: torch.Generator on ``device`` (default: seed 0); draws:
    overrides the generator with another source of the step's random
    numbers (tests replay the JAX package's draws through it).
    checkpoint_dir: persist the run there and resume from it
    (``base.run_segmented``).
    """
    with profiling.span("sampler.setup"), torch.no_grad():
        device = utils.resolve_device(device)
        cfg = cfg or PPDEConfig()
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            draws = Draws(generator)
        x0 = torch.as_tensor(initial_population,
                             dtype=torch.float32).to(device)
        n, L, V = x0.shape
        window_ok = utils.position_window_mask(L, V, min_pos, max_pos, device)

        ctx = {"energy": energy.params, "wt": x0[0], "init_x": x0}
        oracle_fn = None
        if oracle is not None:
            ctx["oracle"] = oracle[0]
            oracle_fn = lambda c, s: oracle[1](c["oracle"], s[0])  # noqa: E731

        e0, fit0, grad0 = energy.energy_and_grad(ctx["energy"], x0)
        # wild-type constants for the carried-state nmut resets
        ctx["wt_e"], ctx["wt_fit"], ctx["wt_grad"] = e0[0], fit0[0], grad0[0]
        if cfg.paper_results:
            ctx["init_e"], ctx["init_fit"], ctx["init_grad"] = e0, fit0, grad0
        step = make_step(energy, cfg, window_ok, n, L, V)
    with torch.no_grad():
        (final_x, _, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(x0, (e0, fit0, grad0),
                                               (e0, fit0, x0)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("PPDE"),
            quiet=quiet, checkpoint_dir=checkpoint_dir)
    with profiling.span("sampler.finish"):
        return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x0[0],
                                   traj_tokens=True, best=best,
                                   final_x=final_x, rec=rec)
