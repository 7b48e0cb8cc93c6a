"""Potts model (dense pairwise Hamiltonian) over flattened one-hots.

Counterpart of ``ppde_tpu/models/potts.py``. The couplings are flattened
once into a symmetric [P, P] matrix W (zero diagonal blocks, zero-padded from
L*V up to P, a multiple of 128), so one evaluation is one matmul:

    Jx    = x_flat @ W                     # [B, P]
    H     = 0.5 * sum(x * Jx) + x @ h      # [B]
    dH/dx = Jx + h                         # shares the same matmul

``hamiltonian_and_grad`` goes through ``ops/potts_fused.energy_and_grad``:
kernel A on a CUDA tensor, its plain version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ppde_tpu_torch import codec, utils
from ppde_tpu_torch.ops import potts_fused

VOCAB = codec.VOCAB_SIZE
LANE = 128  # W/h are zero-padded to multiples of LANE


def _pad_up(n: int, m: int = LANE) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class PottsParams:
    """W [P,P] symmetric, W[(j,l),(i,k)] = J[i,j,k,l]; h [P]; wt_H the
    wild type's Hamiltonian (0-d); the rest is static metadata."""

    W: torch.Tensor
    h: torch.Tensor
    wt_H: torch.Tensor
    seq_len: int = 0
    min_pos: int = 0
    max_pos: int = 0
    reg_coef: float = 1.0

    @property
    def data_dim(self) -> int:
        return self.seq_len * VOCAB

    @property
    def padded_dim(self) -> int:
        return self.W.shape[-1]


def _flatten_couplings(J: np.ndarray) -> np.ndarray:
    """[L,L,V,V] J[i,j,k,l] -> [L*V, L*V] W[(j,l),(i,k)] = J[i,j,k,l]."""
    L, _, V, _ = J.shape
    W = np.transpose(J, (1, 3, 0, 2)).reshape(L * V, L * V)
    return np.ascontiguousarray(W)


def _pad_flat(params: PottsParams, x: torch.Tensor) -> torch.Tensor:
    """[B, L, V] -> zero-padded flat [B, P]."""
    xf = x.reshape(x.shape[0], -1)
    pad = params.padded_dim - xf.shape[-1]
    return torch.nn.functional.pad(xf, (0, pad)) if pad else xf


def hamiltonian(params: PottsParams, x: torch.Tensor) -> torch.Tensor:
    """H of one-hot (or relaxed) x [B, L, V] (window coordinates), forward
    only and differentiable; a float32 matmul (reference nets.py:282-290)."""
    xf = _pad_flat(params, x).float()
    Jx = xf @ params.W.float()
    return 0.5 * (xf * Jx).sum(-1) + xf @ params.h.float()


def hamiltonian_and_grad(params: PottsParams, x: torch.Tensor):
    """Fused (H [B], dH/dx [B, L, V]); x in window coordinates."""
    H, grad_flat = potts_fused.energy_and_grad(params.W, params.h,
                                               _pad_flat(params, x))
    return H, grad_flat[:, : params.data_dim].reshape(x.shape)


def window_slice(params: PottsParams, x_full: torch.Tensor) -> torch.Tensor:
    """Restrict [B, L_full, V] to the alignment window (nets.py:273-280)."""
    return x_full[:, params.min_pos: params.max_pos + 1]


def score(params: PottsParams, x_full: torch.Tensor, delta: bool = True):
    """Potts score of full-coordinate one-hots (window-sliced inside)."""
    H = hamiltonian(params, window_slice(params, x_full))
    return H - params.wt_H if delta else H


def score_and_grad(params: PottsParams, x_full: torch.Tensor,
                   delta: bool = True):
    """(score, d score / d x_full); the gradient is zero outside the
    window."""
    H, gw = hamiltonian_and_grad(params, window_slice(params, x_full))
    after = x_full.shape[1] - params.max_pos - 1
    grad = torch.nn.functional.pad(gw, (0, 0, params.min_pos, after))
    return (H - params.wt_H if delta else H), grad


def _with_wt_H(W: np.ndarray, h: np.ndarray, L: int, min_pos: int,
               max_pos: int, reg_coef: float, wt_seq: str, dtype,
               device) -> PottsParams:
    device = utils.resolve_device(device)
    params = PottsParams(
        W=torch.from_numpy(W).to(device=device, dtype=dtype),
        h=torch.from_numpy(h).to(device=device, dtype=dtype),
        wt_H=torch.zeros((), device=device), seq_len=L, min_pos=min_pos,
        max_pos=max_pos, reg_coef=float(reg_coef))
    wt_oh = torch.from_numpy(
        codec.seqs_to_onehot([wt_seq[min_pos: max_pos + 1]])).to(device)
    params.wt_H = hamiltonian(params, wt_oh)[0]
    return params


def load_npz(path: str, wt_seq: str, dtype=torch.float32,
             device="cuda") -> PottsParams:
    """Load parameters saved by ``save_npz`` of ``ppde_tpu/models/potts.py``
    (keys J [L,L,V,V], h [L,V], index_list, reg_coef, offset)."""
    z = np.load(path)
    L = z["h"].shape[0]
    W = _flatten_couplings(np.asarray(z["J"], np.float64)).astype(np.float32)
    hf = np.asarray(z["h"], np.float32).reshape(L * VOCAB)
    P = _pad_up(L * VOCAB)
    W = np.pad(W, ((0, P - W.shape[0]), (0, P - W.shape[1])))
    hf = np.pad(hf, (0, P - hf.shape[0]))
    idx = np.asarray(z["index_list"]) - int(z["offset"])
    return _with_wt_H(W, hf, L, int(idx[0]), int(idx[-1]),
                      float(z["reg_coef"]), wt_seq, dtype, device)


def synthetic(wt_seq: str, min_pos: int = 0, max_pos: int | None = None,
              seed: int = 0, coupling_scale: float = 0.05,
              field_scale: float = 0.5, dtype=torch.float32,
              device="cuda") -> PottsParams:
    """Deterministic synthetic Potts parameters for benchmarks and tests.

    Draws with numpy exactly as ``synthetic`` in ``ppde_tpu/models/potts.py``
    does, so both packages build the same W from the same seed.
    """
    if max_pos is None:
        max_pos = len(wt_seq) - 1
    L = max_pos - min_pos + 1
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((L * VOCAB, L * VOCAB), np.float32)
    W *= np.float32(coupling_scale)
    W = 0.5 * (W + W.T)
    blocks = W.reshape(L, VOCAB, L, VOCAB)
    blocks[np.arange(L), :, np.arange(L), :] = 0.0
    h = rng.normal(0.0, field_scale, (L, VOCAB)).astype(np.float32)
    # favor the WT letters slightly so WT is near a local optimum
    wt_idx = codec.seqs_to_ints([wt_seq[min_pos: max_pos + 1]])[0]
    h[np.arange(L), wt_idx] += 2.0 * field_scale

    P = _pad_up(L * VOCAB)
    W = np.pad(W, ((0, P - W.shape[0]), (0, P - W.shape[1])))
    hf = np.pad(h.reshape(-1), (0, P - L * VOCAB))
    return _with_wt_H(W, hf, L, min_pos, max_pos, 1.0, wt_seq, dtype, device)
