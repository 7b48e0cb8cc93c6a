"""The plain reference of the PPDE product-of-experts energy.

Plain PyTorch in float32 with TF32 off, written from the published
descriptions and reading only the raw files of a protein directory (the
layouts ``proteins.py`` writes): nothing of the program is imported, and
nothing the program made is read.

  * Potts (EVmutation's Hamiltonian): H(x) = 1/2 sum_ij x_i J_ij x_j +
    sum_i h_i x_i over one-hots, as a delta against the wild type.
  * The OnehotCNN ensemble (PPDE's ``OnehotCNN``, ppde/nets.py:350-376):
    Conv1d(20 -> C, k=5, valid) -> ReLU -> Linear(C -> 2C) -> ReLU -> max
    over the length -> Linear(2C -> 1), the members' mean; the max's
    gradient split equally over ties (``torch.amax``).
  * each expert's term (``experts/<key>.py``'s ``reference_term``), as a
    delta against the wild type.

``precision="control"`` computes the same in the precision below the one
the configuration states: for the float32 terms (Potts, CNN) the operands
of every product rounded to TF32, sums in float32; for each expert every
tensor it marks rounded by its module's ``control_round``. The comparison
in ``compare.py`` has to fail it.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"  # PPDE's vocabulary order (20 letters)


@contextlib.contextmanager
def no_tf32():
    """Full float32 products for the reference's matmuls and convs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _ste(fn):
    """A rounding applied forward; its gradient passed straight through."""
    def q(t):
        return t + (fn(t) - t).detach()
    return q


def _identity(t):
    return t


class Precision:
    """What the operands of a product are rounded to, per term."""

    def __init__(self, precision: str):
        if precision not in ("reference", "control"):
            raise ValueError(f"precision is 'reference' or 'control': "
                             f"{precision}")
        self.control = precision == "control"
        self.f32 = self.rounding(round_tf32)

    def rounding(self, fn):
        """``fn`` applied forward in the control, nothing in the reference."""
        return _ste(fn) if self.control else _identity


# ---------------------------------------------------------------------------
# raw files
# ---------------------------------------------------------------------------

def read_wild_type(protein_dir: str) -> str:
    with open(os.path.join(protein_dir, "wt.fasta")) as f:
        return "".join(line.strip() for line in f
                       if not line.startswith(">"))


def onehot(seq: str) -> np.ndarray:
    out = np.zeros((len(seq), 20), np.float32)
    out[np.arange(len(seq)), [ALPHABET.index(c) for c in seq]] = 1.0
    return out


def load(protein_dir: str, potts_file: str, experts, device) -> dict:
    """The raw weights of a protein directory, float32 on ``device``, and
    the terms of ``experts`` ((key, module, settings) each) with their
    control roundings."""
    z = np.load(os.path.join(protein_dir, potts_file))
    J = torch.from_numpy(np.asarray(z["J"], np.float32)).to(device)
    L, _, V, _ = J.shape
    # Wf[(i,k),(j,l)] = J[i,j,k,l]; its symmetric part gives the gradient
    Wf = J.permute(0, 2, 1, 3).reshape(L * V, L * V)
    W = 0.5 * (Wf + Wf.T)
    del J, Wf
    h = torch.from_numpy(np.asarray(z["h"], np.float32)).to(device)
    members = []
    m = 0
    while os.path.exists(p := os.path.join(protein_dir,
                                           f"onehot_cnn_seed={m}.pt")):
        sd = torch.load(p, map_location=device, weights_only=True)
        members.append({k: v.float() for k, v in sd.items()})
        m += 1
    return {"wt": read_wild_type(protein_dir), "potts_W": W,
            "potts_h": h.reshape(-1), "cnn": members,
            "experts": [(mod.reference_term(protein_dir, cfg, device),
                         mod.control_round) for _, mod, cfg in experts]}


# ---------------------------------------------------------------------------
# the terms
# ---------------------------------------------------------------------------

def potts_H(W, h, x, pr: Precision):
    """H [B] of one-hots x [B, L, V] (differentiable)."""
    xf = x.reshape(x.shape[0], -1)
    Jx = pr.f32(xf) @ pr.f32(W)
    return 0.5 * (xf * Jx).sum(-1) + pr.f32(xf) @ pr.f32(h)


def cnn_fitness(members, x, pr: Precision):
    """The ensemble's mean fitness [B] of one-hots x [B, L, V]
    (differentiable)."""
    xc = x.transpose(1, 2)  # [B, V, L], Conv1d's layout
    preds = []
    for sd in members:
        h1 = torch.relu(F.conv1d(pr.f32(xc), pr.f32(sd["encoder.weight"]),
                                 sd["encoder.bias"]))          # [B, C, T]
        h2 = torch.relu(F.linear(pr.f32(h1.transpose(1, 2)),
                                 pr.f32(sd["embedding.0.weight"]),
                                 sd["embedding.0.bias"]))      # [B, T, 2C]
        pooled = torch.amax(h2, dim=1)
        preds.append(F.linear(pr.f32(pooled), pr.f32(sd["decoder.weight"]),
                              sd["decoder.bias"])[:, 0])
    return torch.stack(preds).mean(0)


class Reference:
    """The energy E(x) = [Potts delta] + [each expert's delta] + lam *
    fitness over one-hots [B, L, 20], from the raw weights of ``load``."""

    def __init__(self, raw: dict, lam: float, precision: str = "reference"):
        self.raw, self.lam = raw, lam
        self.pr = Precision(precision)
        self.terms = [(score, self.pr.rounding(rnd))
                      for score, rnd in raw["experts"]]
        dev = raw["potts_W"].device
        self.wt = torch.from_numpy(onehot(raw["wt"]))[None].to(dev)
        with torch.no_grad(), no_tf32():
            self.wt_H = potts_H(raw["potts_W"], raw["potts_h"], self.wt,
                                self.pr)
            self.wt_terms = [score(self.wt, r) for score, r in self.terms]

    def _terms(self, x):
        fit = cnn_fitness(self.raw["cnn"], x, self.pr)
        e = self.lam * fit + potts_H(self.raw["potts_W"], self.raw["potts_h"],
                                     x, self.pr) - self.wt_H
        for (score, r), wt in zip(self.terms, self.wt_terms):
            e = e + score(x, r) - wt
        return e, fit

    def energy(self, x, block: int):
        """(e [B], fit [B]) in blocks of ``block`` rows."""
        es, fs = [], []
        with torch.no_grad(), no_tf32():
            for xb in x.split(block):
                e, f = self._terms(xb.float())
                es.append(e)
                fs.append(f)
        return torch.cat(es), torch.cat(fs)

    def energy_and_grad(self, x, block: int):
        """(e [B], fit [B], dE/dx [B, L, V]) in blocks of ``block`` rows."""
        es, fs, gs = [], [], []
        with no_tf32():
            for xb in x.split(block):
                with torch.enable_grad():
                    xg = xb.float().detach().requires_grad_(True)
                    e, f = self._terms(xg)
                    (g,) = torch.autograd.grad(e.sum(), xg)
                es.append(e.detach())
                fs.append(f.detach())
                gs.append(g)
        return torch.cat(es), torch.cat(fs), torch.cat(gs)
