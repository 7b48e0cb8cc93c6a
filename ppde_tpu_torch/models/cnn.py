"""Supervised protein fitness predictor: one-hot CNN regressor + ensembles.

Counterpart of ``ppde_tpu/models/cnn.py``. Architecture parity with the
reference OnehotCNN (ppde/nets.py:350-376): Conv1d(V -> C, k=5, valid) ->
ReLU -> Linear(C -> 2C) -> ReLU -> max over length -> Linear(2C -> 1).
Ensembles are stacked parameter dicts (leading member axis) evaluated as
batched matmuls.

``ensemble_apply_and_grad_plain`` is the plain PyTorch version of kernel B
(``ops/cnn_fused.py``) and its specification: it rounds where the kernel
rounds (f32 sums, activations and the routed gradient cast to the compute
type), so that on the card the two differ only by summation order.
"""
from __future__ import annotations

import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.models import layers

K = 5  # conv kernel width (reference OnehotCNN default)


def init(generator: torch.Generator, n_tokens: int = 20, kernel_size: int = 5,
         input_size: int = 96, dtype=torch.float32):
    utils.resolve_device(generator.device)
    return {
        "encoder": layers.init_conv1d(generator, kernel_size, n_tokens,
                                      input_size, dtype),
        "embed": layers.init_linear(generator, input_size, input_size * 2,
                                    dtype),
        "decoder": layers.init_linear(generator, input_size * 2, 1, dtype),
    }


def init_ensemble(generator: torch.Generator, n_members: int = 3, **kw):
    """Stacked ensemble on ``generator.device`` (the JAX layout:
    encoder.w [M,K,V,C], embed.w [M,C,2C], decoder.w [M,2C,1], ...)."""
    return layers.stack_params([init(generator, **kw)
                                for _ in range(n_members)])


class _MaxPoolFirst(torch.autograd.Function):
    """max over dim 1 whose backward routes ALL gradient to the FIRST
    argmax row (torch.max(x, dim=1) semantics, reference nets.py:372);
    amax's backward splits equally across ties instead."""

    @staticmethod
    def forward(ctx, h):
        idx = torch.argmax(h, dim=1, keepdim=True)  # first max on ties
        ctx.save_for_backward(idx)
        ctx.shape = h.shape
        return torch.gather(h, 1, idx).squeeze(1)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return out.scatter_(1, idx, g.unsqueeze(1))


def max_pool_first(h: torch.Tensor) -> torch.Tensor:
    return _MaxPoolFirst.apply(h)


def _pool(h: torch.Tensor, pool_bwd: str) -> torch.Tensor:
    if pool_bwd == "first":
        return max_pool_first(h)
    if pool_bwd != "split":
        raise ValueError(f"pool_bwd must be 'split' or 'first': {pool_bwd}")
    return torch.amax(h, dim=1)


def apply(params, x: torch.Tensor, pool_bwd: str = "split") -> torch.Tensor:
    """One member: x [B, L, V] one-hot (or relaxed) -> fitness [B]."""
    h = torch.relu(layers.conv1d(params["encoder"], x))
    h = torch.relu(layers.linear(params["embed"], h))
    return layers.linear(params["decoder"], _pool(h, pool_bwd))[:, 0]


def im2col(x: torch.Tensor) -> torch.Tensor:
    """[B, L, V] -> [B, T, K*V] patches, T = L - K + 1."""
    T = x.shape[1] - K + 1
    return torch.cat([x[:, i:T + i] for i in range(K)], dim=-1)


def member_predictions(stacked, x: torch.Tensor, compute_dtype=None,
                       pool_bwd: str = "split") -> torch.Tensor:
    """Per-member predictions [M, B] (float32) of a stacked ensemble.

    compute_dtype (e.g. torch.bfloat16): weights, inputs and activations are
    rounded to it; every product sums in float32 and biases add in float32
    (the fused kernels' arithmetic). The max-pool compares the rounded
    values, so bf16 ties are seen as the kernel sees them.
    """
    cdt = compute_dtype or torch.float32

    def rnd(t):
        return t if cdt == torch.float32 else t.to(cdt).float()

    enc, emb, dec = stacked["encoder"], stacked["embed"], stacked["decoder"]
    M, k, V, C = enc["w"].shape
    x32 = x.float()
    # round the input forward only: its gradient stays float32, like dx
    x32 = x32 + (rnd(x32) - x32).detach()
    P = im2col(x32)                                              # [B,T,KV]
    enc_w = rnd(enc["w"].float()).reshape(M, 1, k * V, C)
    H1 = rnd(torch.relu(P.unsqueeze(0) @ enc_w
                        + enc["b"].float().reshape(M, 1, 1, C)))  # [M,B,T,C]
    C2 = emb["w"].shape[-1]
    H2 = rnd(torch.relu(H1 @ rnd(emb["w"].float()).reshape(M, 1, C, C2)
                        + emb["b"].float().reshape(M, 1, 1, C2)))
    B, T = H2.shape[1], H2.shape[2]
    mx = _pool(H2.reshape(M * B, T, C2), pool_bwd).reshape(M, B, C2)
    dec_w = rnd(dec["w"].float()).reshape(M, 1, C2)
    return (mx * dec_w).sum(-1) + dec["b"].float().reshape(M, 1)


def ensemble_apply(stacked, x: torch.Tensor, compute_dtype=None,
                   pool_bwd: str = "split") -> torch.Tensor:
    """Mean prediction of a stacked ensemble; x [B, L, V] -> [B] float32."""
    return member_predictions(stacked, x, compute_dtype, pool_bwd).mean(0)


def ensemble_apply_and_grad_plain(stacked, x: torch.Tensor,
                                  compute_dtype=None,
                                  pool_bwd: str = "split"):
    """(fitness [B], d sum(fitness) / dx [B, L, V]) by autograd over
    ``member_predictions`` — the plain version of kernel B.

    The gradient of the member SUM is taken and divided by M at the end, as
    the kernel does (so the bf16 rounding of the routed gradient sees
    dec_w, not dec_w / M).
    """
    with torch.enable_grad():
        xg = x.detach().float().requires_grad_(True)
        preds = member_predictions(stacked, xg, compute_dtype, pool_bwd)
        (g,) = torch.autograd.grad(preds.sum(), xg)
    M = preds.shape[0]
    return preds.detach().mean(0), g / M
