"""Domain-agnostic parallel-tempering machinery.

Counterpart of ``ppde_tpu/samplers/pt_core.py``:

  * ``ladder`` — the geometric inverse-temperature ladder as a per-chain
    [n] array (level = chain // M, level 0 cold);
  * ``make_exchange`` — one alternating even/odd replica-exchange phase.
    Both ends of a pair share one uniform (the lower level's), so the
    accept decision is symmetric; the parity comes from the step counter.

The JAX package moves states between levels by a [K, K] one-hot
permutation matmul (a TPU rule against gathers); here the partner's row is
taken by index, which gives the same values exactly. The step counter is a
host integer, so parity, gate and partner table are host decisions and the
phase syncs nothing.

Detailed balance: the exchange is its own involution with a symmetric
proposal (parity is deterministic from the counter, the partner from the
parity), so P(swap) = min(1, exp((beta_i - beta_j) (E_j - E_i))) keeps
prod_l pi_l, pi_l ~ exp(beta_l E) stationary.
"""
from __future__ import annotations

import numpy as np
import torch


def ladder(n_chains: int, n_levels: int, beta_min: float) -> np.ndarray:
    """Per-chain inverse temperatures [n_chains] (float32); level = chain //
    M with M = n_chains // n_levels. Level 0 is the cold (beta = 1) block;
    beta_l = beta_min ** (l / (K-1)) (geometric)."""
    if n_chains % n_levels:
        raise ValueError(
            f"n_chains={n_chains} must be divisible by n_levels={n_levels}")
    if not (0.0 < beta_min <= 1.0):
        raise ValueError(f"beta_min must be in (0, 1], got {beta_min}")
    k = np.arange(n_levels, dtype=np.float64)
    denom = max(n_levels - 1, 1)
    betas = beta_min ** (k / denom)
    return np.repeat(betas, n_chains // n_levels).astype(np.float32)


def make_exchange(n: int, n_levels: int, swap_every: int, device):
    """Build the replica-exchange phase.

    Returns ``phase(beta, e, count, draws, arrays) -> (swapped arrays,
    n_swapped)``: ``beta`` and ``e`` are [n], ``count`` the host step
    counter, ``arrays`` the per-chain tensors (leading dim n) that move
    with an accepted swap, typically [x, e, fit, grad] (the carried grad
    must be the RAW dE/dx). The phase draws [K, M] uniforms
    (``draws.uniform((K, M))``) on every call, gated or not.
    """
    K = n_levels
    M = n // K
    iota = np.arange(K)
    tables = []
    for parity in (0, 1):
        sgn = 1 - 2 * ((iota - parity) % 2)            # +1 pairs up, -1 down
        partner = iota + sgn
        valid = (partner >= 0) & (partner < K)
        partner = np.where(valid, partner, iota)        # edges self-pair
        tables.append(tuple(torch.from_numpy(a).to(device) for a in (
            partner, valid, iota < partner, valid & (sgn > 0))))

    def phase(beta, e, count, draws, arrays):
        u = draws.uniform((K, M))
        if count % swap_every:
            return list(arrays), torch.zeros((), dtype=torch.long,
                                             device=e.device)
        partner, valid, lower, counted = tables[(count // swap_every) % 2]
        betas_lvl = beta.reshape(K, M)[:, 0]
        e_lvl = e.reshape(K, M)
        # symmetric under l <-> partner: both ends compute the same value
        log_acc = ((betas_lvl - betas_lvl[partner])[:, None]
                   * (e_lvl[partner] - e_lvl))
        u_shared = torch.where(lower[:, None], u, u[partner])
        swap = (torch.log(u_shared) < log_acc) & valid[:, None]    # [K, M]

        def exchange(v):
            flat = v.reshape((K, M) + tuple(v.shape[1:]))
            s = swap.reshape((K, M) + (1,) * (v.ndim - 1))
            return torch.where(s, flat[partner], flat).reshape(v.shape)

        n_swapped = (swap & counted[:, None]).sum()
        return [exchange(v) for v in arrays], n_swapped

    return phase
