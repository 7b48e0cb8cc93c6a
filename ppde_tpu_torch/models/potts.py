"""Potts model (dense pairwise Hamiltonian) over flattened one-hots.

Counterpart of ``ppde_tpu/models/potts.py``. The couplings are flattened
once into a symmetric [P, P] matrix W (zero diagonal blocks, zero-padded from
L*V up to P, a multiple of 128), so one evaluation is one matmul:

    Jx    = x_flat @ W                     # [B, P]
    H     = 0.5 * sum(x * Jx) + x @ h      # [B]
    dH/dx = Jx + h                         # shares the same matmul

``hamiltonian_and_grad`` goes through ``ops/potts_fused.energy_and_grad``:
kernel A on a CUDA tensor (from couplings prepared once by the caller, or
on the spot), its plain version on a CPU tensor. ``gibbs_sweep`` /
``gibbs_sample`` draw from the model (plain products, as in the JAX
package). Both energy functions run on a column block of the couplings
from ``col0``, sum the blocks' shares of H and gather their gradients over
the ``tp`` axis (``parallel/mesh.shard_potts``); the whole couplings are the
block (0, P) with no axis, where the sum and the gather are identities.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, utils
from ppde_tpu_torch.ops import potts_fused
from ppde_tpu_torch.parallel import mesh as pmesh

VOCAB = codec.VOCAB_SIZE
LANE = 128  # W/h are zero-padded to multiples of LANE


def _pad_up(n: int, m: int = LANE) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class PottsParams:
    """W [P', N] with W[(j,l),(i,k)] = J[i,j,k,l], the columns ``col0`` to
    ``col0 + N`` of the couplings zero-padded to P' (whole: W [P, P]
    symmetric, col0 0); h [N] the same columns of the fields; wt_H the wild
    type's Hamiltonian (0-d); ``tp`` the mesh axis the column blocks lie
    over (None: whole); the rest is static metadata."""

    W: torch.Tensor
    h: torch.Tensor
    wt_H: torch.Tensor
    seq_len: int = 0
    min_pos: int = 0
    max_pos: int = 0
    reg_coef: float = 1.0
    col0: int = 0
    tp: pmesh.Axis | None = None

    @property
    def data_dim(self) -> int:
        return self.seq_len * VOCAB

    @property
    def padded_dim(self) -> int:
        return self.W.shape[0]


def _flatten_couplings(J: np.ndarray) -> np.ndarray:
    """[L,L,V,V] J[i,j,k,l] -> [L*V, L*V] W[(j,l),(i,k)] = J[i,j,k,l]."""
    L, _, V, _ = J.shape
    W = np.transpose(J, (1, 3, 0, 2)).reshape(L * V, L * V)
    return np.ascontiguousarray(W)


def _unflatten_couplings(W: np.ndarray, L: int) -> np.ndarray:
    """Inverse of _flatten_couplings: [L*V, L*V] -> [L,L,V,V]."""
    J = W.reshape(L, VOCAB, L, VOCAB)  # [j,l,i,k]
    return np.transpose(J, (2, 0, 3, 1))


def _pad_flat(params: PottsParams, x: torch.Tensor,
              dtype=None) -> torch.Tensor:
    """[B, L, V] -> zero-padded flat [B, P], cast to ``dtype`` if given (one
    copy pads and casts)."""
    xf = x.reshape(x.shape[0], -1)
    D, P = xf.shape[-1], params.padded_dim
    if dtype is None or dtype == xf.dtype:
        return torch.nn.functional.pad(xf, (0, P - D)) if P > D else xf
    out = torch.empty((xf.shape[0], P), dtype=dtype, device=xf.device)
    out[:, :D] = xf
    out[:, D:] = 0
    return out


def hamiltonian(params: PottsParams, x: torch.Tensor) -> torch.Tensor:
    """H of one-hot (or relaxed) x [B, L, V] (window coordinates), forward
    only and differentiable; a float32 matmul (reference nets.py:282-290)."""
    # the block's share; x's gradient summed over the blocks
    xf = pmesh.copy_to(_pad_flat(params, x).float(), params.tp)
    Jx = xf @ params.W.float()
    xb = xf[:, params.col0:params.col0 + params.W.shape[1]]
    share = 0.5 * (xb * Jx).sum(-1) + xb @ params.h.float()
    return pmesh.reduce_from(share, params.tp)


def hamiltonian_and_grad(params: PottsParams, x: torch.Tensor,
                         prepared: potts_fused.Prepared | None = None):
    """Fused (H [B], dH/dx [B, L, V]); x one-hot, in window coordinates.
    ``prepared``: ``potts_fused.prepare(params.W, params.h)``, kept by the
    caller (None: the kernel's wrapper prepares on the spot)."""
    # kernel A reads xf in bf16, which holds one-hots exactly: one copy
    # pads and casts
    dt = params.W.dtype if x.device.type == "cpu" else torch.bfloat16
    H, grad_flat = potts_fused.energy_and_grad(
        params.W if prepared is None else prepared, params.h,
        _pad_flat(params, x, dt), params.col0)
    H = pmesh.all_sum(H, params.tp)
    grad_flat = pmesh.gather_cat(grad_flat, params.tp, 1)
    return H, grad_flat[:, : params.data_dim].reshape(x.shape)


def window_slice(params: PottsParams, x_full: torch.Tensor) -> torch.Tensor:
    """Restrict [B, L_full, V] to the alignment window (nets.py:273-280)."""
    return x_full[:, params.min_pos: params.max_pos + 1]


def score(params: PottsParams, x_full: torch.Tensor, delta: bool = True):
    """Potts score of full-coordinate one-hots (window-sliced inside)."""
    H = hamiltonian(params, window_slice(params, x_full))
    return H - params.wt_H if delta else H


def score_and_grad(params: PottsParams, x_full: torch.Tensor,
                   delta: bool = True,
                   prepared: potts_fused.Prepared | None = None):
    """(score, d score / d x_full); the gradient is zero outside the
    window. ``prepared`` as for ``hamiltonian_and_grad``."""
    H, gw = hamiltonian_and_grad(params, window_slice(params, x_full),
                                 prepared)
    after = x_full.shape[1] - params.max_pos - 1
    grad = torch.nn.functional.pad(gw, (0, 0, params.min_pos, after))
    return (H - params.wt_H if delta else H), grad


# ---------------------------------------------------------------------------
# Gibbs sampling from the Boltzmann law p(x) ∝ exp(β·H(x)) (H is maximised
# by the samplers, so this is the stationary law of their energy)
# ---------------------------------------------------------------------------

def _field(params: PottsParams, x: torch.Tensor) -> torch.Tensor:
    """F = x_flat @ W [B, P] in float32: the per-(position, letter)
    coupling field."""
    return _pad_flat(params, x).float() @ params.W.float()


def gibbs_sweep(params: PottsParams, x: torch.Tensor, F: torch.Tensor,
                draws, beta: float = 1.0):
    """One systematic-scan Gibbs sweep over all window positions.

    Exact single-site conditionals: with W symmetric and its diagonal
    blocks zero, position i's conditional logits are
    β·(h_i + F[:, iV:(i+1)V]).
    The field is kept incrementally: resampling position i adds one
    [B,V]×[V,P] product (new minus old one-hot times V rows of W). Draws
    ``gumbel([B, V])`` a position (Gumbel-max, as ``jax.random.categorical``).

    x: [B, L, V] one-hot; F: ``_field(params, x)``. Returns (x, F) after
    resampling every position once; x is not changed in place.
    """
    L, V = params.seq_len, VOCAB
    x = x.clone()
    W = params.W.float()
    h = params.h.float()
    for i in range(L):
        sl = slice(i * V, (i + 1) * V)
        logits = beta * (h[sl][None] + F[:, sl])
        new = torch.nn.functional.one_hot(
            (draws.gumbel(logits.shape) + logits).argmax(-1), V).to(x.dtype)
        F = F + (new - x[:, i]).float() @ W[sl]
        x[:, i] = new
    return x, F


@torch.no_grad()
def gibbs_sample(params: PottsParams, generator: torch.Generator,
                 n_chains: int, n_sweeps: int, x0: torch.Tensor | None = None,
                 beta: float = 1.0) -> torch.Tensor:
    """Sample [n_chains, L, V] window one-hots from p(x) ∝ exp(β·H(x)).

    ``x0``: initial window one-hots; None = independent per-position draws
    from softmax(β·h) (``gumbel([n_chains, L, V])``). Every random number
    comes from a ``samplers.base.Draws`` on ``generator``.
    """
    from ppde_tpu_torch.samplers.base import Draws

    draws = Draws(generator)
    L, V = params.seq_len, VOCAB
    if x0 is None:
        logits = beta * params.h[: L * V].float().reshape(1, L, V)
        x0 = torch.nn.functional.one_hot(
            (draws.gumbel((n_chains, L, V)) + logits).argmax(-1),
            V).float()
    x, F = x0, _field(params, x0)
    for _ in range(n_sweeps):
        x, F = gibbs_sweep(params, x, F, draws, beta)
    return x


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


def _build(J, h, index_list, reg_coef: float, offset: int, wt_seq: str,
           dtype, device) -> PottsParams:
    """PottsParams from J [L,L,V,V], h [L,V] and the window's absolute
    residue numbers ``index_list`` (window = index_list - offset)."""
    L = np.asarray(h).shape[0]
    W = _flatten_couplings(np.asarray(J, np.float64)).astype(np.float32)
    hf = np.asarray(h, np.float32).reshape(L * VOCAB)
    P = _pad_up(L * VOCAB)
    W = np.pad(W, ((0, P - W.shape[0]), (0, P - W.shape[1])))
    hf = np.pad(hf, (0, P - hf.shape[0]))
    idx = np.asarray(index_list) - int(offset)
    return _with_wt_H(W, hf, L, int(idx[0]), int(idx[-1]), float(reg_coef),
                      wt_seq, dtype, device)


def load_npz(path: str, wt_seq: str, dtype=torch.float32,
             device="cuda") -> PottsParams:
    """Load parameters saved by ``save_npz`` of ``ppde_tpu/models/potts.py``
    (keys J [L,L,V,V], h [L,V], index_list, reg_coef, offset)."""
    z = np.load(path)
    return _build(z["J"], z["h"], z["index_list"], float(z["reg_coef"]),
                  int(z["offset"]), wt_seq, dtype, device)


def save_npz(path: str, J: np.ndarray, h: np.ndarray, index_list: np.ndarray,
             reg_coef: float, offset: int) -> None:
    """Write the artifact ``load_npz`` of either package reads."""
    np.savez_compressed(path, J=J, h=h, index_list=index_list,
                        reg_coef=reg_coef, offset=offset)


def load_pickle(protein_dir: str, dtype=torch.float32,
                device="cuda") -> PottsParams:
    """Load the reference's potts.pkl + wt.fasta artifact pair (keys J_ij
    [L,L,V,V], h_i [L,V], index_list of absolute residue numbers, reg_coef;
    reference nets.py:244-262). The FASTA id gives the window offset:
    '>NAME/START-END' -> START, else 1."""
    with open(os.path.join(protein_dir, "potts.pkl"), "rb") as f:
        p = pickle.load(f)
    wt_seqs, wt_ids = pio.read_fasta(
        os.path.join(protein_dir, "wt.fasta"), return_ids=True)
    offset = (int(wt_ids[0].split("/")[-1].split("-")[0])
              if "/" in wt_ids[0] else 1)
    return _build(p["J_ij"], p["h_i"], p["index_list"], p["reg_coef"],
                  offset, wt_seqs[0], dtype, device)


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


def as_dense_J(params: PottsParams) -> np.ndarray:
    """Recover the [L,L,V,V] coupling tensor (float64, for export)."""
    lv = params.data_dim
    W = params.W.detach().cpu().double().numpy()[:lv, :lv]
    return _unflatten_couplings(W, params.seq_len)
