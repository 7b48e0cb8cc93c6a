"""Functional layers over plain parameter dicts, in the JAX package's layout.

Counterpart of ``ppde_tpu/models/layers.py``: conv1d inputs are NLC with
kernels [k, in, out]; linear weights are [in, out]. Keeping the layout lets
parameters cross between the packages unchanged (``convert.py``).
"""
from __future__ import annotations

import math

import torch


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


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
