"""Carry parameters from the JAX package into the port.

The functions take plain numpy arrays, as ``jax.tree.map(np.asarray, ...)``
gives them (bfloat16 arrays arrive as ml_dtypes ``bfloat16``), and return
the port's parameters on ``device`` with the dtypes kept.
"""
from __future__ import annotations

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.models.oracle import LinearOracleParams
from ppde_tpu_torch.models.potts import PottsParams


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(t, device):
    """A nested dict / list of numpy arrays as the same tree of tensors."""
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device) for v in t]
    return _tensor(t, device)


def potts_from_numpy(W, h, wt_H, seq_len: int, min_pos: int, max_pos: int,
                     reg_coef: float = 1.0, device="cuda") -> PottsParams:
    """PottsParams from the JAX package's W [P,P], h [P] and wt_H."""
    device = utils.resolve_device(device)
    return PottsParams(W=_tensor(W, device), h=_tensor(h, device),
                       wt_H=_tensor(wt_H, device).float().reshape(()),
                       seq_len=int(seq_len), min_pos=int(min_pos),
                       max_pos=int(max_pos), reg_coef=float(reg_coef))


def cnn_ensemble_from_numpy(tree, device="cuda"):
    """A stacked CNN ensemble in the JAX layout (encoder.w [M,K,V,C],
    encoder.b [M,C], embed.w [M,C,2C], embed.b [M,2C], decoder.w [M,2C,1],
    decoder.b [M,1]) as the port's parameter dict."""
    return _tree(tree, utils.resolve_device(device))


def esm2_from_numpy(tree, device="cuda"):
    """An ESM2 parameter tree of the JAX package (``models/esm2.py`` layout,
    as ``jax.tree.map(np.asarray, params)`` gives it, with ``wt_score`` and
    ``perm`` when the tree is an expert's) as the port's dict of tensors."""
    return _tree(tree, utils.resolve_device(device))


# An MSA-Transformer parameter tree of the JAX package
# (``models/msa_transformer.py`` layout, bf16 leaves as ml_dtypes
# ``bfloat16``) as the port's dict of tensors, dtypes kept.
msa_transformer_from_numpy = esm2_from_numpy


def oracle_from_numpy(coef, intercept, inv_sqrt_reg, potts_params: PottsParams,
                      device="cuda") -> LinearOracleParams:
    """LinearOracleParams from the JAX package's coef [S, 1+L*V], intercept
    [S] and inv_sqrt_reg [S], over the port's ``potts_params``."""
    device = utils.resolve_device(device)
    return LinearOracleParams(coef=_tensor(coef, device),
                              intercept=_tensor(intercept, device),
                              inv_sqrt_reg=_tensor(inv_sqrt_reg, device),
                              potts=potts_params)


def _hwio_tree(t, device):
    """A JAX-layout MNIST tree as the port's: every conv kernel ("w" of 4
    dims, 5 with a member axis) permuted (3, 2, 0, 1) on its last four
    dims. That takes HWIO [kh,kw,in,out] to OIHW, and the JAX package's
    transposed-conv layout [kh,kw,out,in] to torch's [in,out,kh,kw], which
    needs no spatial flip: the JAX package flips at call time to compute
    what torch's ConvTranspose2d computes. Other leaves are unchanged."""
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            a = np.asarray(v) if k == "w" else None
            if a is not None and a.ndim >= 4:
                lead = tuple(range(a.ndim - 4))
                v = np.ascontiguousarray(a.transpose(
                    lead + tuple(len(lead) + i for i in (3, 2, 0, 1))))
            out[k] = _hwio_tree(v, device)
        return out
    if isinstance(t, (list, tuple)):
        return [_hwio_tree(v, device) for v in t]
    return _tensor(t, device)


def mnist_from_numpy(tree, device="cuda"):
    """An MNIST parameter tree of the JAX package as the port's: a
    regression net or stacked ensemble (``mnist_nets.regression_init`` /
    ``regression_init_ensemble``), the ResNet EBM (``ebm_init``, ``mean``
    included) or the DAE (``dae_init``; its decoder's transposed convs
    change layout too)."""
    return _hwio_tree(tree, utils.resolve_device(device))


mnist_regression_from_numpy = ebm_from_numpy = dae_from_numpy = \
    mnist_from_numpy


def mnist_to_numpy(tree):
    """The exact inverse of ``mnist_from_numpy``: a port MNIST tree as numpy
    arrays in the JAX layout (every conv kernel permuted (2, 3, 1, 0) on its
    last four dims: OIHW -> HWIO, [in,out,kh,kw] -> [kh,kw,out,in]), for
    checkpoints that either package loads."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.dim() >= 4:
                a = v.detach().cpu().numpy()
                lead = tuple(range(a.ndim - 4))
                out[k] = np.ascontiguousarray(a.transpose(
                    lead + tuple(len(lead) + i for i in (2, 3, 1, 0))))
            else:
                out[k] = mnist_to_numpy(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [mnist_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
