"""Potts model fitting: pseudolikelihood maximisation (plmDCA).

Counterpart of ``ppde_tpu/models/potts_fit.py``: couplings J and fields h
from an .a2m MSA by L2-regularised weighted pseudolikelihood with the
standard 80%-identity sequence reweighting; each step is two matrix
products. The fit starts at zero and uses Adam on a cosine schedule, with
no random draw, so it is deterministic in both packages.

Conventions match ``models/potts.py``: couplings as a symmetric [L*V, L*V]
matrix with zero diagonal blocks; gaps contribute nothing (zero one-hot
rows) and their positions are masked out of the loss.

The identity counts of ``sequence_weights`` come from a float32 product of
one-hots, exact only without TF32 (``utils.resolve_device`` switches it
off on CUDA) and never in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from ppde_tpu_torch import codec, io as pio, utils
from ppde_tpu_torch.training import Adam, cosine_decay_schedule

VOCAB = codec.VOCAB_SIZE


def msa_to_onehot(msa: list[tuple[str, str]]) -> np.ndarray:
    """Focus-column MSA rows -> one-hot [M, L, V]; gaps become zero rows."""
    L = len(msa[0][1])
    out = np.zeros((len(msa), L, VOCAB), np.float32)
    for m, (_, seq) in enumerate(msa):
        for j, c in enumerate(seq):
            if c != "-":
                out[m, j, codec.AA_TO_INT[c]] = 1.0
    return out


def sequence_weights(onehot: np.ndarray, identity: float = 0.8,
                     batch: int = 1024, device="cuda") -> np.ndarray:
    """1 / neighborhood-size reweighting at the given identity threshold
    (numpy float32 [M])."""
    device = utils.resolve_device(device)
    M, L, V = onehot.shape
    flat = torch.from_numpy(np.ascontiguousarray(
        onehot.reshape(M, L * V), np.float32)).to(device)
    lengths = torch.from_numpy(onehot.sum((1, 2))).to(device)
    out = []
    for s in range(0, M, batch):
        chunk = flat[s:s + batch]
        sim = chunk @ flat.T  # [b, M] shared identical positions
        denom = torch.minimum(lengths[None, :], chunk.sum(-1, keepdim=True))
        out.append((sim / denom.clamp_min(1.0) >= identity).sum(-1))
    neighbors = torch.cat(out).cpu().numpy()
    return (1.0 / np.maximum(neighbors, 1.0)).astype(np.float32)


def _diag_block_mask(L: int) -> np.ndarray:
    """[L*V, L*V] mask, 0 on the L diagonal VxV blocks, 1 elsewhere."""
    m = np.ones((L, L), np.float32) - np.eye(L, dtype=np.float32)
    return np.kron(m, np.ones((VOCAB, VOCAB), np.float32))


def fit(msa_onehot: np.ndarray, weights: np.ndarray | None = None,
        lambda_J: float = 0.01, lambda_h: float = 0.01,
        steps: int = 500, lr: float = 0.05, seed: int = 0,
        verbose: bool = False, device="cuda"):
    """Fit (J [L,L,V,V], h [L,V]) by weighted pseudolikelihood: Adam on
    ``cosine_decay_schedule(lr, steps, alpha=0.02)`` from zero. Returns (J,
    h, history) as float64 numpy with J symmetric (J_ij == J_ji^T) and
    zero diagonal, and the loss of every step (read from the device once,
    at the end). ``seed`` is unused, as in the JAX package."""
    del seed
    device = utils.resolve_device(device)
    M, L, V = msa_onehot.shape
    onehot = torch.from_numpy(np.ascontiguousarray(msa_onehot,
                                                   np.float32)).to(device)
    X = onehot.reshape(M, L * V)
    present = onehot.sum(-1)                                  # [M, L]
    w = torch.from_numpy(np.asarray(
        weights if weights is not None else np.ones(M, np.float32),
        np.float32)).to(device)
    w = w / w.sum()
    mask = torch.from_numpy(_diag_block_mask(L)).to(device)

    def sym(W):
        return 0.5 * (W + W.T) * mask

    # JAX flatten order of {"W", "h"}
    W = torch.zeros((L * V, L * V), device=device, requires_grad=True)
    h = torch.zeros((L, V), device=device, requires_grad=True)
    opt = Adam([W, h], cosine_decay_schedule(lr, steps, alpha=0.02))
    history = []
    for i in range(steps):
        Ws = sym(W)
        logits = (X @ Ws).reshape(M, L, V) + h[None]
        ll = (torch.log_softmax(logits, -1) * onehot).sum(-1)   # [M, L]
        nll = -(w * (ll * present).sum(-1)).sum()
        loss = nll + lambda_J * (Ws ** 2).sum() + lambda_h * (h ** 2).sum()
        opt.step(torch.autograd.grad(loss, [W, h]))
        history.append(loss.detach())
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"[plm] step {i} loss {float(history[-1]):.4f}", flush=True)
    history = torch.stack(history).cpu().tolist()

    with torch.no_grad():
        Wn = sym(W).double().cpu().numpy()
    # [L*V, L*V] W[(j,l),(i,k)] -> J[i,j,k,l] (inverse of potts flattening)
    J = Wn.reshape(L, VOCAB, L, VOCAB).transpose(2, 0, 3, 1)
    return J, h.detach().double().cpu().numpy(), history


def fit_from_a2m(a2m_path: str, steps: int = 500, lr: float = 0.05,
                 lambda_J: float = 0.01, lambda_h: float = 0.01,
                 max_seqs: int | None = None, reweight: bool = True,
                 seed: int = 0, verbose: bool = False, device="cuda"):
    """a2m -> (J, h, index_list, offset, history) ready for
    ``potts.save_npz``; index_list holds the absolute residue numbers of
    the focus columns (region start + column offset, reference
    nets.py:250,255-261). ``max_seqs`` keeps the first (focus) row and a
    numpy draw from ``seed`` of the rest, as the JAX package does."""
    msa = pio.load_msa(a2m_path)
    if max_seqs is not None and len(msa) > max_seqs:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(msa) - 1, size=max_seqs - 1,
                          replace=False) + 1
        msa = [msa[0]] + [msa[i] for i in keep]
    onehot = msa_to_onehot(msa)
    w = sequence_weights(onehot, device=device) if reweight else None
    J, h, hist = fit(onehot, w, lambda_J, lambda_h, steps, lr, seed,
                     verbose, device)
    _, start, _ = pio.msa_region(a2m_path)
    cols = pio.focus_columns(a2m_path)
    index_list = np.asarray([start + c for c in cols])
    return J, h, index_list, start, hist
