"""Simulated annealing over one-hot proteins, with batched proposals.

Counterpart of ``ppde_tpu/samplers/protein/sa.py`` (behavioural parity with
the reference SimulatedAnnealing, protein_samplers/sa.py:9-149): per chain
a Poisson(mu_i - 1) + 1 number of random substitutions at distinct
positions inside [min_pos, max_pos] (mu_i drawn once per run, :66),
Metropolis acceptance at T = T_max * decay^step, proposals beyond the nmut
threshold rejected (energy -inf, :95-98), and, as in the reference (:104),
rejected chains reset to the INITIAL population; their recorded energies
carry the previous value (:112).

Random numbers, in order: at the start of a run the [n] uniforms of mu;
per step the Poisson edit counts [n], the Gumbel noise over positions
[n, L], the value draws [n, max_edits] in [0, V-1), the accept uniforms
[n]. The step counter is a host integer, so the temperature is a host
number and a step syncs nothing; a checkpoint saves it as a leaf. A
resumed run draws mu again from its freshly seeded generator before the
checkpoint's generator state replaces that state, so mu is the uncut run's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.energy import Energy
from ppde_tpu_torch.samplers import base


@dataclasses.dataclass(frozen=True)
class SAConfig:
    temp: float = 0.01
    muts_per_seq_param: float = 1.5
    decay_rate: float = 0.999
    nmut_threshold: int = 0
    max_edits: int = 12  # cap on simultaneous edits per proposal


def propose(draws, x: torch.Tensor, mu: torch.Tensor, min_pos: int,
            max_pos: int, max_edits: int) -> torch.Tensor:
    """Batched random-edit proposal (reference protein_samplers/sa.py:26-56).

    For each chain: k ~ Poisson(mu - 1) + 1 (clipped to [1, max_edits])
    distinct positions in [min_pos, max_pos], each set to a uniformly random
    different amino acid.
    """
    n, L, V = x.shape
    n_edits = (draws.poisson(mu - 1.0) + 1).clamp(1, max_edits).long()

    # distinct positions: the top max_edits of Gumbel noise inside the
    # window. A stable descending sort breaks the ties at -inf (windows
    # narrower than max_edits) by index, as jax.lax.top_k does
    pos_ids = torch.arange(L, device=x.device)
    window = (pos_ids >= min_pos) & (pos_ids <= max_pos)
    g = torch.where(window[None], draws.gumbel((n, L)), -torch.inf)
    pos = torch.sort(g, dim=-1, descending=True,
                     stable=True)[1][:, :max_edits]                # [n, E]

    # a random different amino acid: draw in [0, V-1), skip the current one
    rows = x.gather(1, pos[..., None].expand(n, max_edits, V))   # [n, E, V]
    draw = draws.randint(V - 1, (n, max_edits))
    new_aa = draw + (draw >= rows.argmax(-1)).long()
    live = torch.arange(max_edits, device=x.device)[None] < n_edits[:, None]
    new_rows = torch.nn.functional.one_hot(new_aa, V).to(x.dtype)
    vals = torch.where(live[..., None], new_rows, rows)
    return x.scatter(1, pos[..., None].expand(n, max_edits, V), vals)


def make_step(energy: Energy, cfg: SAConfig, min_pos: int, max_pos: int,
              n: int):
    nmut = (cfg.nmut_threshold if cfg.nmut_threshold > 0
            else int(np.iinfo(np.int32).max))

    def step(ctx, state, draws):
        x, cur_e, cur_fit, step_i, best = state
        y = propose(draws, x, ctx["mu"], min_pos, max_pos, cfg.max_edits)
        e_p, fit_p = energy.energy(ctx["energy"], y)
        over = utils.mut_distance(y, ctx["wt"]) > nmut
        e_p = e_p.masked_fill(over, utils.NEG_INF)
        fit_p = fit_p.masked_fill(over, utils.NEG_INF)

        T = cfg.temp * cfg.decay_rate ** step_i
        ap = torch.exp((e_p - cur_e) / T).clamp(max=1.0)
        accepted = ap > draws.uniform(n)
        acc3 = accepted.reshape(n, 1, 1)

        # fallback to the INITIAL population on rejection (reference :104)
        new_x = torch.where(acc3, y, ctx["init_x"])
        # -inf proposals are rejected; recorded values sanitize -inf to 0
        # before blending (reference :109-112)
        e_p0 = e_p.masked_fill(e_p <= utils.NEG_INF, 0.0)
        fit_p0 = fit_p.masked_fill(fit_p <= utils.NEG_INF, 0.0)
        new_e = torch.where(accepted, e_p0, cur_e)
        new_fit = torch.where(accepted, fit_p0, cur_fit)

        best = base.update_best(best, new_e, new_fit, new_x)
        ys = {"energy": new_e, "fitness": new_fit, "accepted": accepted,
              "traj": new_x[0].argmax(-1).to(torch.int8)}
        return (new_x, new_e, new_fit, step_i + 1, best), ys

    return step


def start(energy: Energy, initial_population, muts_per_seq_param: float,
          generator, draws, device):
    """What SA and Random share at the start of a run: the draws, x0 on the
    device, the per-chain Poisson means mu and the initial energies."""
    device = utils.resolve_device(device)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draws = base.Draws(generator)
    x0 = torch.as_tensor(initial_population, dtype=torch.float32).to(device)
    mu = muts_per_seq_param * draws.uniform(x0.shape[0]) + 1.0
    with torch.no_grad():
        e0, fit0 = energy.energy(energy.params, x0)
    return draws, x0, mu, e0, fit0


def attach_oracle(ctx, oracle):
    """Put the oracle's params into ctx; returns run_segmented's oracle_fn
    for a state whose first element is the population (None: no oracle)."""
    if oracle is None:
        return None
    ctx["oracle"] = oracle[0]
    return lambda c, s: oracle[1](c["oracle"], s[0])


def run(energy: Energy, initial_population, num_steps: int, min_pos: int,
        max_pos: int, oracle=None, cfg: SAConfig | None = None,
        generator: torch.Generator | None = None,
        draws: base.Draws | None = None, log_every: int = 50,
        quiet: bool = False, device="cuda",
        checkpoint_dir: str | None = None) -> base.SamplerResult:
    """Same contract as ppde.run."""
    cfg = cfg or SAConfig()
    draws, x0, mu, e0, fit0 = start(energy, initial_population,
                                    cfg.muts_per_seq_param, generator, draws,
                                    device)
    n = x0.shape[0]
    ctx = {"energy": energy.params, "wt": x0[0], "init_x": x0, "mu": mu}
    oracle_fn = attach_oracle(ctx, oracle)
    step = make_step(energy, cfg, min_pos, max_pos, n)
    with torch.no_grad():
        (final_x, _, _, _, best), rec = base.run_segmented(
            step_fn=step, ctx=ctx, init_state=(x0, e0, fit0, 0,
                                               (e0, fit0, x0)),
            draws=draws, num_steps=num_steps, log_every=log_every,
            oracle_fn=oracle_fn, log_fn=base.default_log("SA"), quiet=quiet,
            checkpoint_dir=checkpoint_dir)
    return base.package_result(e0=e0, fit0=fit0, x0_traj_head=x0[0],
                               traj_tokens=True, best=best, final_x=final_x,
                               rec=rec)
