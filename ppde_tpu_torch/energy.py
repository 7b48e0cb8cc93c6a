"""Product-of-experts energy composition (protein domain).

Counterpart of ``ppde_tpu/energy.py`` with the same uniform API:
  * ``energy(params, x) -> (e, fit)``
  * ``energy_and_grad(params, x) -> (e, fit, grad_x)``
  * ``fitness(params, x) -> fit``

``energy_and_grad`` takes the supervised term through
``ops/cnn_fused.ensemble_apply_and_grad`` and the Potts term through
``ops/potts_fused.energy_and_grad``: on CUDA tensors always the kernels (the
JAX package's ``fused_cnn`` / ``interpret`` switches have no counterpart),
on CPU tensors their plain versions. ``energy`` and ``fitness`` are plain,
differentiable PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ppde_tpu_torch.models import cnn
from ppde_tpu_torch.models import potts as potts_mod
from ppde_tpu_torch.ops import cnn_fused


@dataclass(frozen=True)
class Energy:
    """Uniform energy API consumed by every sampler; the callables take
    ``params`` (= ``self.params``) as their first argument."""

    params: Any
    energy: Callable
    energy_and_grad: Callable
    fitness: Callable
    wt_onehot: Any = None  # [1, L, V] wild-type one-hot (protein domains)


def _fit_and_grad(p, x, compute_dtype, cnn_chunk, pool_bwd):
    """Supervised (fitness, d sum(fitness)/dx), in chain chunks of
    ``cnn_chunk`` when it divides the batch (as the JAX package's lax.map)."""
    n = x.shape[0]
    if not cnn_chunk or n <= cnn_chunk or n % cnn_chunk:
        return cnn_fused.ensemble_apply_and_grad(p["sup"], x, compute_dtype,
                                                 pool_bwd)
    outs = [cnn_fused.ensemble_apply_and_grad(p["sup"], x[i:i + cnn_chunk],
                                              compute_dtype, pool_bwd)
            for i in range(0, n, cnn_chunk)]
    return (torch.cat([f for f, _ in outs]), torch.cat([g for _, g in outs]))


def protein_poe(potts_params: potts_mod.PottsParams | None, sup_ensemble,
                lam: float, wt_onehot, compute_dtype=None,
                cnn_chunk: int | None = None,
                pool_bwd: str = "split") -> Energy:
    """E(x) = potts_delta(x) + lam * fitness(x) over [N, L_full, V] one-hots.

    compute_dtype: None (float32) or torch.bfloat16 for the supervised CNN.
    ``potts_params`` may be None (supervised term only).
    """
    params = {"sup": sup_ensemble}
    if potts_params is not None:
        params["potts"] = potts_params

    def fit_fn(p, x):
        return cnn.ensemble_apply(p["sup"], x, compute_dtype=compute_dtype,
                                  pool_bwd=pool_bwd)

    def energy(p, x):
        fit = fit_fn(p, x)
        e = lam * fit
        if "potts" in p:
            e = e + potts_mod.score(p["potts"], x, delta=True)
        return e, fit

    def energy_and_grad(p, x):
        fit, fit_grad = _fit_and_grad(p, x, compute_dtype, cnn_chunk,
                                      pool_bwd)
        e = lam * fit
        grad = lam * fit_grad
        if "potts" in p:
            pe, pg = potts_mod.score_and_grad(p["potts"], x, delta=True)
            e = e + pe
            grad = grad + pg
        return e, fit, grad

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn,
                  wt_onehot=wt_onehot)


def protein_supervised(sup_ensemble, wt_onehot, compute_dtype=None,
                       cnn_chunk: int | None = None,
                       pool_bwd: str = "split") -> Energy:
    """Supervised-only ablation: E(x) = fitness(x) (energy.py:143-164)."""
    params = {"sup": sup_ensemble}

    def fit_fn(p, x):
        return cnn.ensemble_apply(p["sup"], x, compute_dtype=compute_dtype,
                                  pool_bwd=pool_bwd)

    def energy(p, x):
        fit = fit_fn(p, x)
        return fit, fit

    def energy_and_grad(p, x):
        fit, g = _fit_and_grad(p, x, compute_dtype, cnn_chunk, pool_bwd)
        return fit, fit, g

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn,
                  wt_onehot=wt_onehot)
