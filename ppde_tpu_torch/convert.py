"""Carry parameters from the JAX package into the port.

The functions take plain numpy arrays, as ``jax.tree.map(np.asarray, ...)``
gives them (bfloat16 arrays arrive as ml_dtypes ``bfloat16``), and return
the port's parameters on ``device`` with the dtypes kept.
"""
from __future__ import annotations

import numpy as np
import torch

from ppde_tpu_torch import utils
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
