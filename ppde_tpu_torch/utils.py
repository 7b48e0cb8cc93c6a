"""Device-side sequence utilities and device selection.

Counterpart of ``ppde_tpu/utils.py``.
"""
from __future__ import annotations

import numpy as np
import torch

# finite stand-in for -inf: over-budget chains with no revertible position
# take a softmax over an all-masked row, where -inf would give NaN
NEG_INF = -1e30


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument.

    A CUDA device must exist (no silent CPU fallback); on CUDA, TF32 is
    switched off for matmuls and cuDNN so that float32 stays float32.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def mut_distance(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Hamming distance in positions between x [N,L,V] and wt [L,V] or
    [1,L,V] (reference utils.py:5-14)."""
    wt = wt.reshape((1,) + tuple(wt.shape[-2:]))
    diff = torch.any(x != wt, dim=-1)
    return diff.to(x.dtype).sum(-1)


def position_window_mask(seq_len: int, vocab_size: int, min_pos: int,
                         max_pos: int, device="cpu") -> torch.Tensor:
    """Boolean [L,V] mask, True where mutations are allowed (positions
    min_pos..max_pos inclusive)."""
    pos = torch.arange(seq_len, device=device)
    ok = (pos >= min_pos) & (pos <= max_pos)
    return ok[:, None].expand(seq_len, vocab_size).contiguous()


def flip_bits(x: torch.Tensor, changes: torch.Tensor) -> torch.Tensor:
    """Binary-domain flip: x, changes in {0,1} [N,D]; flips where
    changes == 1."""
    return (1.0 - x) * changes + x * (1.0 - changes)


def n_hops(population: torch.Tensor, wt: torch.Tensor):
    """(mean, std) of one-sided hops ((x - wt) > 0 summed) across a
    population [N,L,V] against wt [L,V] or [1,L,V]; the std with ddof=1
    (reference metrics.py:78-85)."""
    diff = (population - wt.reshape((1,) + tuple(wt.shape[-2:]))) > 0
    hops = diff.float().sum((-2, -1))
    return hops.mean(), hops.std(unbiased=True)


def quantiles(v, qs=(0.5, 0.9)):
    """Host-side quantiles of v (a tensor or an array) for log lines."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.quantile(np.asarray(v), list(qs))
