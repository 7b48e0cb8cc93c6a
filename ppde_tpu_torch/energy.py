"""Product-of-experts energy composition.

Counterpart of ``ppde_tpu/energy.py`` with the same uniform API:
  * ``energy(params, x) -> (e, fit)``
  * ``energy_and_grad(params, x) -> (e, fit, grad_x)``
  * ``fitness(params, x) -> fit``
(the MNIST energies take ``(params, x2, x1)``: x2 evolves, x1 is the fixed
summand; their gradient is autograd's, with respect to x2 only).

``energy_and_grad`` takes the supervised term through
``ops/cnn_fused.ensemble_apply_and_grad`` and the Potts term through
``ops/potts_fused.energy_and_grad``: on CUDA tensors always the kernels (the
JAX package's ``fused_cnn`` / ``interpret`` switches have no counterpart),
from weights each energy prepares once, on CPU tensors their plain
versions. ``energy``'s supervised term splits max-pool ties whatever
``pool_bwd`` says, as the JAX package's does: only ``energy_and_grad``
honours the flag. The optional transformer term (a pseudo-log-likelihood
delta of ESM2, ``models/esm2.load_expert``, or of the MSA Transformer,
``models/msa_transformer.load_expert``) is differentiated by autograd, its
attention through ``ops/attention_fused`` (kernels C and C' on CUDA) and
the MSA Transformer's tied row attention through
``ops/row_attention_fused`` (kernels T and T'). ``energy`` and ``fitness``
are plain, differentiable PyTorch apart from that attention.

Under a mesh, ``runtime.apply_mesh`` builds the same energy anew on
sharded parameters (``Energy.with_params``, so that each energy prepares
its own weights once): a column block of the Potts couplings (tp), a
``parallel.mesh.Placed`` ensemble (ep: kernel B on the rank's members,
their mean weighted by the rank's share and summed over ep),
``shard_esm``'s ESM2 (tp) and the sequence-parallel hook (sp);
``parallel/mesh.shard_energy`` adds dp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.models import cnn, mnist_nets
from ppde_tpu_torch.models import potts as potts_mod
from ppde_tpu_torch.ops import cnn_fused, potts_fused
from ppde_tpu_torch.parallel import mesh as pmesh


@dataclass(frozen=True)
class Energy:
    """Uniform energy API consumed by every sampler; the callables take
    ``params`` (= ``self.params``) as their first argument."""

    params: Any
    energy: Callable
    energy_and_grad: Callable
    fitness: Callable
    wt_onehot: Any = None  # [1, L, V] wild-type one-hot (protein domains)
    # params -> this energy built anew on other (sharded) parameters
    with_params: Callable | None = None


class _PreparedOnce:
    """The prepared form of one set of weights, ``prepare(weights)``, made at
    the first call on a CUDA tensor and kept; made anew after an in-place
    update of one of ``tensors(weights)`` (its version counter moved) or
    after one was replaced; a write through ``.data`` moves no counter and
    is not seen. Other weights handed in through ``params`` are returned as
    they are (and prepared on the spot by the wrapper)."""

    def __init__(self, weights, prepare, tensors):
        self.weights, self.prepare, self.tensors = weights, prepare, tensors
        self.prepared, self.versions = None, None

    def get(self, weights, x):
        if weights is not self.weights or x.device.type == "cpu":
            return weights
        versions = tuple((id(t), t._version) for t in self.tensors(weights))
        if versions != self.versions:
            self.prepared = self.prepare(weights)
            self.versions = versions
        return self.prepared


def _ensemble_once(sup_ensemble, compute_dtype) -> _PreparedOnce:
    """Kernel B's prepared weights of a stacked ensemble
    (``cnn_fused.prepare_ensemble`` for ``compute_dtype``)."""
    return _PreparedOnce(
        sup_ensemble,
        lambda s: cnn_fused.prepare_ensemble(s, compute_dtype),
        lambda s: [t for layer in ("encoder", "embed", "decoder")
                   for t in s[layer].values()])


def _potts_once(potts_params) -> _PreparedOnce:
    """Kernel A's prepared couplings (``potts_fused.prepare``: a float32 W
    split into three bf16 planes)."""
    return _PreparedOnce(potts_params,
                         lambda p: potts_fused.prepare(p.W, p.h),
                         lambda p: (p.W, p.h))


def _fit_and_grad(sup, x, compute_dtype, cnn_chunk, pool_bwd):
    """Supervised (fitness, d sum(fitness)/dx), in chain chunks of
    ``cnn_chunk`` when it divides the batch (as the JAX package's lax.map).
    ``sup``: a stacked ensemble or its ``cnn_fused.Prepared``."""
    n = x.shape[0]
    if not cnn_chunk or n <= cnn_chunk or n % cnn_chunk:
        return cnn_fused.ensemble_apply_and_grad(sup, x, compute_dtype,
                                                 pool_bwd)
    outs = [cnn_fused.ensemble_apply_and_grad(sup, x[i:i + cnn_chunk],
                                              compute_dtype, pool_bwd)
            for i in range(0, n, cnn_chunk)]
    return (torch.cat([f for f, _ in outs]), torch.cat([g for _, g in outs]))


def _members(sup):
    """(stacked members, ep axis or None, their share of the ensemble) of
    a stacked ensemble or of ``parallel.mesh.shard_ensemble``'s Placed."""
    if isinstance(sup, pmesh.Placed):
        return sup.local, sup.axis, sup.share
    return sup, None, 1.0


def _ensemble_fit(sup, x, compute_dtype):
    """The ensemble's mean fitness, differentiable: each rank's mean over
    its members, weighted by its share and summed over ep."""
    local, ax, share = _members(sup)
    fit = cnn.ensemble_apply(local, pmesh.copy_to(x, ax),
                             compute_dtype=compute_dtype)
    return pmesh.reduce_from(fit * share, ax)


def _sup_fit_and_grad(sup, prepared, x, compute_dtype, cnn_chunk,
                      pool_bwd):
    """``_fit_and_grad`` of the supervised term (``prepared``: kernel B's
    weights of the energy's own members): each rank's (fitness, dx)
    weighted by its share and summed over ep."""
    local, ax, share = _members(sup)
    fit, g = _fit_and_grad(prepared.get(local, x), x, compute_dtype,
                           cnn_chunk, pool_bwd)
    return pmesh.all_sum(fit * share, ax), pmesh.all_sum(g * share, ax)


def protein_poe(potts_params: potts_mod.PottsParams | None, sup_ensemble,
                lam: float, wt_onehot, transformer=None,
                chunk_size: int | None = None, compute_dtype=None,
                cnn_chunk: int | None = None,
                pool_bwd: str = "split") -> Energy:
    """E(x) = unsup_delta(x) + lam * fitness(x) over [N, L_full, V] one-hots.

    ``transformer``: optional (params, apply_fn) pair (``esm2.load_expert``
    or ``msa_transformer.load_expert``) adding its pseudo-log-likelihood
    delta term, in the spans ``energy.<span>`` and ``<span>.backward`` that
    apply_fn's ``span`` attribute names ("esm2" without one; the MSA
    Transformer's is "msa"). ``potts_params`` may be
    None (transformer only, or the supervised term only). ``chunk_size``
    evaluates the transformer and its gradient over chain chunks of that
    size, one after another, which bounds the memory of the saved
    activations. compute_dtype: None (float32) or torch.bfloat16 for the
    supervised CNN.
    """
    params = {"sup": sup_ensemble}
    prepared = _ensemble_once(_members(sup_ensemble)[0], compute_dtype)
    potts_once = _potts_once(potts_params)
    if potts_params is not None:
        params["potts"] = potts_params
    t_apply = None
    if transformer is not None:
        params["tr"] = transformer[0]
        t_apply = transformer[1]
    span = getattr(t_apply, "span", "esm2")

    def fit_fn(p, x):
        return _ensemble_fit(p["sup"], x, compute_dtype)

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
        energy_and_grad under no_grad, so autograd is switched on here.
        The backward runs in ``<span>.backward``, its kinds' work in
        ``<span>.bwd.<kind>`` (``profiling.grad_spans``)."""
        def one_chunk(xc):
            with torch.enable_grad(), profiling.grad_spans():
                xg = profiling.grad_span(xc.detach().requires_grad_(True),
                                         None)
                y = t_apply(p["tr"], xg)
                with profiling.span(span + ".backward"):
                    (g,) = torch.autograd.grad(y.sum(), xg)
            return y.detach(), g

        n = x.shape[0]
        if chunk_size is None or n <= chunk_size:
            return one_chunk(x)
        outs = [one_chunk(x[i:i + chunk_size])
                for i in range(0, n, chunk_size)]
        return (torch.cat([e for e, _ in outs]),
                torch.cat([g for _, g in outs]))

    @profiling.spanned("energy")
    def energy_and_grad(p, x):
        with profiling.span("energy.cnn"):
            fit, fit_grad = _sup_fit_and_grad(p["sup"], prepared, x,
                                              compute_dtype, cnn_chunk,
                                              pool_bwd)
        e = lam * fit
        grad = lam * fit_grad
        if "potts" in p:
            with profiling.span("energy.potts"):
                prep = potts_once.get(p["potts"], x)
                pe, pg = potts_mod.score_and_grad(
                    p["potts"], x, delta=True,
                    prepared=None if prep is p["potts"] else prep)
            e = e + pe
            grad = grad + pg
        if t_apply is not None:
            with profiling.span("energy." + span):
                te, tg = transformer_score_and_grad(p, x)
            e = e + te
            grad = grad + tg
        return e, fit, grad

    def with_params(q):
        return protein_poe(q.get("potts"), q["sup"], lam, wt_onehot,
                           None if t_apply is None else (q["tr"], t_apply),
                           chunk_size, compute_dtype, cnn_chunk, pool_bwd)

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn,
                  wt_onehot=wt_onehot, with_params=with_params)


def protein_supervised(sup_ensemble, wt_onehot, compute_dtype=None,
                       cnn_chunk: int | None = None,
                       pool_bwd: str = "split") -> Energy:
    """Supervised-only ablation: E(x) = fitness(x) (energy.py:143-164)."""
    params = {"sup": sup_ensemble}
    prepared = _ensemble_once(_members(sup_ensemble)[0], compute_dtype)

    def fit_fn(p, x):
        return _ensemble_fit(p["sup"], x, compute_dtype)

    def energy(p, x):
        fit = fit_fn(p, x)
        return fit, fit

    @profiling.spanned("energy")
    def energy_and_grad(p, x):
        with profiling.span("energy.cnn"):
            fit, g = _sup_fit_and_grad(p["sup"], prepared, x, compute_dtype,
                                       cnn_chunk, pool_bwd)
        return fit, fit, g

    def with_params(q):
        return protein_supervised(q["sup"], wt_onehot, compute_dtype,
                                  cnn_chunk, pool_bwd)

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn,
                  wt_onehot=wt_onehot, with_params=with_params)


# ---------------------------------------------------------------------------
# MNIST energies (binary images; x2 evolves, x1 is the fixed summand)
# ---------------------------------------------------------------------------

def _autograd_x2(e_and_fit, x2):
    """(e, fit, d sum(e) / d x2), detached; autograd is switched on here
    because the samplers call energy_and_grad under no_grad."""
    with torch.enable_grad():
        v = x2.detach().requires_grad_(True)
        e, fit = e_and_fit(v)
        (g,) = torch.autograd.grad(e.sum(), v)
    return e.detach(), fit.detach(), g


def mnist_poe(unsup_params, sup_ensemble, lam: float,
              unsup_kind: str = "ebm") -> Energy:
    """E(x2; x1) = log p_unsup(x2) + lam * predicted_sum(x1, x2).

    unsup_kind: 'ebm' (ResNet EBM + Bernoulli base, mlp.py:175-196) or
    'dae' (reconstruction log-prob, nets.py:162-168). Parity with
    MNISTProductOfExperts (energy.py:13-51), with the supervised-attr bug
    fixed, as in the JAX package.
    """
    log_prob = (mnist_nets.ebm_log_prob if unsup_kind == "ebm"
                else mnist_nets.dae_log_prob)
    params = {"unsup": unsup_params, "sup": sup_ensemble}

    def fit_fn(p, x2, x1):
        return mnist_nets.regression_ensemble_apply(p["sup"], x1, x2)

    def energy(p, x2, x1):
        fit = fit_fn(p, x2, x1)
        return log_prob(p["unsup"], x2) + lam * fit, fit

    def energy_and_grad(p, x2, x1):
        return _autograd_x2(lambda v: energy(p, v, x1), x2)

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn)


def mnist_supervised(sup_ensemble) -> Energy:
    """Supervised-only MNIST energy (energy.py:54-68)."""
    params = {"sup": sup_ensemble}

    def fit_fn(p, x2, x1):
        return mnist_nets.regression_ensemble_apply(p["sup"], x1, x2)

    def energy(p, x2, x1):
        fit = fit_fn(p, x2, x1)
        return fit, fit

    def energy_and_grad(p, x2, x1):
        return _autograd_x2(lambda v: energy(p, v, x1), x2)

    return Energy(params=params, energy=energy,
                  energy_and_grad=energy_and_grad, fitness=fit_fn)
