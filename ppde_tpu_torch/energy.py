"""Product-of-experts energy composition (protein domain).

Counterpart of ``ppde_tpu/energy.py`` with the same uniform API:
  * ``energy(params, x) -> (e, fit)``
  * ``energy_and_grad(params, x) -> (e, fit, grad_x)``
  * ``fitness(params, x) -> fit``

``energy_and_grad`` takes the supervised term through
``ops/cnn_fused.ensemble_apply_and_grad`` and the Potts term through
``ops/potts_fused.energy_and_grad``: on CUDA tensors always the kernels (the
JAX package's ``fused_cnn`` / ``interpret`` switches have no counterpart),
on CPU tensors their plain versions. The optional transformer term (an ESM2
pseudo-log-likelihood delta, ``models/esm2.load_expert``) is differentiated
by autograd, its attention through ``ops/attention_fused`` (kernels C and
C' on CUDA). ``energy`` and ``fitness`` are plain, differentiable PyTorch
apart from that attention.
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
                lam: float, wt_onehot, transformer=None,
                chunk_size: int | None = None, compute_dtype=None,
                cnn_chunk: int | None = None,
                pool_bwd: str = "split") -> Energy:
    """E(x) = unsup_delta(x) + lam * fitness(x) over [N, L_full, V] one-hots.

    ``transformer``: optional (params, apply_fn) pair (``esm2.load_expert``)
    adding an ESM2 pseudo-log-likelihood delta term. ``potts_params`` may be
    None (transformer only, or the supervised term only). ``chunk_size``
    evaluates the transformer and its gradient over chain chunks of that
    size, one after another, which bounds the memory of the saved
    activations. compute_dtype: None (float32) or torch.bfloat16 for the
    supervised CNN.
    """
    params = {"sup": sup_ensemble}
    if potts_params is not None:
        params["potts"] = potts_params
    t_apply = None
    if transformer is not None:
        params["tr"] = transformer[0]
        t_apply = transformer[1]

    def fit_fn(p, x):
        return cnn.ensemble_apply(p["sup"], x, compute_dtype=compute_dtype,
                                  pool_bwd=pool_bwd)

    def energy(p, x):
        fit = fit_fn(p, x)
        e = lam * fit
        if "potts" in p:
            e = e + potts_mod.score(p["potts"], x, delta=True)
        if t_apply is not None:
            e = e + t_apply(p["tr"], x)
        return e, fit

    def transformer_score_and_grad(p, x):
        """(score [N], d sum(score) / dx), detached; the samplers call
        energy_and_grad under no_grad, so autograd is switched on here."""
        def one_chunk(xc):
            with torch.enable_grad():
                xg = xc.detach().requires_grad_(True)
                y = t_apply(p["tr"], xg)
                (g,) = torch.autograd.grad(y.sum(), xg)
            return y.detach(), g

        n = x.shape[0]
        if chunk_size is None or n <= chunk_size:
            return one_chunk(x)
        outs = [one_chunk(x[i:i + chunk_size])
                for i in range(0, n, chunk_size)]
        return (torch.cat([e for e, _ in outs]),
                torch.cat([g for _, g in outs]))

    def energy_and_grad(p, x):
        fit, fit_grad = _fit_and_grad(p, x, compute_dtype, cnn_chunk,
                                      pool_bwd)
        e = lam * fit
        grad = lam * fit_grad
        if "potts" in p:
            pe, pg = potts_mod.score_and_grad(p["potts"], x, delta=True)
            e = e + pe
            grad = grad + pg
        if t_apply is not None:
            te, tg = transformer_score_and_grad(p, x)
            e = e + te
            grad = grad + tg
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
