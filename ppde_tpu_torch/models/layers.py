"""Functional layers over plain parameter dicts.

Counterpart of ``ppde_tpu/models/layers.py``. conv1d inputs are NLC with
kernels [k, in, out] and linear weights are [in, out], the JAX package's
layout, so those parameters cross between the packages unchanged
(``convert.py``). The 2-D layers take torch's own layout: NCHW
activations, OIHW conv kernels and [in, out, kh, kw] transposed-conv
kernels (``convert.py`` carries the JAX package's HWIO ones over).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return F.silu(x)


def conv2d(p, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Conv2d; x [N,C,H,W], kernel [out,in,kh,kw]."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def conv_transpose2d(p, x: torch.Tensor, stride: int = 2, padding: int = 1,
                     output_padding: int = 1) -> torch.Tensor:
    """ConvTranspose2d; x [N,C,H,W], kernel [in,out,kh,kw].
    out = (in - 1) * stride - 2 * padding + k + output_padding."""
    return F.conv_transpose2d(x, p["w"], p["b"], stride=stride,
                              padding=padding, output_padding=output_padding)


def batchnorm2d(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm2d over the channel dim of an NCHW input.
    When ``mean`` or ``var`` requires grad (a trainer's leaves: the JAX
    package trains them as parameters) it is written out, since
    ``F.batch_norm`` gives running statistics no gradient."""
    if p["mean"].requires_grad or p["var"].requires_grad:
        def c(t):
            return t[None, :, None, None]

        return ((x - c(p["mean"])) * c(torch.rsqrt(p["var"] + eps))
                * c(p["gamma"]) + c(p["beta"]))
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        training=False, eps=eps)


def conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """Torch-Conv1d-compatible valid conv. x [N,L,C], kernel [k,in,out].

    Written as one im2col matmul (patch row t is x[:, t:t+k] flattened), the
    same product kernel B computes, so no cuDNN convolution is involved.
    """
    k, c_in, c_out = p["w"].shape
    T = x.shape[1] - k + 1
    patches = torch.cat([x[:, i:T + i] for i in range(k)], dim=-1)
    return patches @ p["w"].reshape(k * c_in, c_out) + p["b"]


def stack_params(param_list):
    """Stack structurally identical parameter dicts along a new leading
    axis (the ensemble layout: every leaf gets a leading member dim)."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in param_list]) for k in first}
    if isinstance(first, list):
        return [stack_params(list(ps)) for ps in zip(*param_list)]
    return torch.stack(param_list, dim=0)


def _uniform(generator: torch.Generator, shape, bound: float, dtype):
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(dtype)


def init_linear(generator: torch.Generator, n_in: int, n_out: int,
                dtype=torch.float32):
    bound = 1.0 / math.sqrt(n_in)
    return {"w": _uniform(generator, (n_in, n_out), bound, dtype),
            "b": _uniform(generator, (n_out,), bound, dtype)}


def init_conv1d(generator: torch.Generator, k: int, c_in: int, c_out: int,
                dtype=torch.float32):
    bound = 1.0 / math.sqrt(c_in * k)
    return {"w": _uniform(generator, (k, c_in, c_out), bound, dtype),
            "b": _uniform(generator, (c_out,), bound, dtype)}


def init_conv2d(generator: torch.Generator, kh: int, kw: int, c_in: int,
                c_out: int, dtype=torch.float32):
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    return {"w": _uniform(generator, (c_out, c_in, kh, kw), bound, dtype),
            "b": _uniform(generator, (c_out,), bound, dtype)}


def init_conv_transpose2d(generator: torch.Generator, kh: int, kw: int,
                          c_in: int, c_out: int, dtype=torch.float32):
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    return {"w": _uniform(generator, (c_in, c_out, kh, kw), bound, dtype),
            "b": _uniform(generator, (c_out,), bound, dtype)}


def init_batchnorm2d(c: int, dtype=torch.float32, device=None):
    return {"gamma": torch.ones(c, dtype=dtype, device=device),
            "beta": torch.zeros(c, dtype=dtype, device=device),
            "mean": torch.zeros(c, dtype=dtype, device=device),
            "var": torch.ones(c, dtype=dtype, device=device)}
