"""Carry parameters from the JAX package into the port.

Both functions take plain numpy arrays, as ``jax.tree.map(np.asarray, ...)``
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
    device = utils.resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, device)

    return conv(tree)
