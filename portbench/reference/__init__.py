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
  * ESM2 (Lin et al. 2023; fair-esm's ``ESM2``) as PPDE's one-hot fork
    scores it: the one-hot [T, 20] mapped to ESM's 33 tokens with no BOS or
    EOS, the embedding x @ E times the eval-mode token-dropout factor 0.88,
    pre-LN rotary attention blocks with the erf GELU, the final layer norm
    and the tied LM head; the score is the pseudo-log-likelihood sum_i x_i .
    log_softmax(logits_i) less the wild type's.

``precision="control"`` computes the same in the precision below the one
the configuration states: for the float32 terms (Potts, CNN) the operands
of every product rounded to TF32, sums in float32; for the bfloat16 one
(ESM2) every tensor the served expert holds in bfloat16 (weights, the
residual stream, each product's and norm's output) rounded to float8 e4m3
under a per-tensor scale, the norms, softmax and logits in float32 as the
program has them. The comparison in ``compare.py`` has to fail it.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"  # PPDE's vocabulary order (20 letters)
ESM_TOKS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
ESM_VOCAB = len(ESM_TOKS)
MASK_RATIO_TRAIN = 0.15 * 0.8
FP8_MAX = 448.0  # largest float8 e4m3 value


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


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 under a per-tensor scale that maps
    its largest magnitude to e4m3's largest value."""
    t = t.float()
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


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
        control = precision == "control"
        self.f32 = _ste(round_tf32) if control else _identity
        self.bf16 = _ste(round_fp8) if control else _identity


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


def load(protein_dir: str, potts_file: str, esm_file: str | None,
         device) -> dict:
    """The raw weights of a protein directory, float32 on ``device``."""
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
    out = {"wt": read_wild_type(protein_dir), "potts_W": W,
           "potts_h": h.reshape(-1), "cnn": members, "esm": None}
    if esm_file is not None:
        out["esm"] = [torch.from_numpy(np.asarray(z2, np.float32)).to(device)
                      for z2 in _npz_leaves(os.path.join(protein_dir,
                                                         esm_file))]
    return out


def _npz_leaves(path):
    z = np.load(path)
    n = len([k for k in z.files if k.startswith("p") and k[1:].isdigit()])
    return [z[f"p{i}"] for i in range(n)]


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


def esm_tree(leaves, layers: int):
    """The ESM2 weights from the leaves of a native checkpoint (dict keys
    sorted, lists in order; linear weights [in, out])."""
    it = iter(leaves)

    def lin():
        b, w = next(it), next(it)
        return {"b": b, "w": w}

    def ln():
        b, g = next(it), next(it)
        return {"b": b, "g": g}

    embed = next(it)
    final_ln = ln()
    blocks = []
    for _ in range(layers):
        blk = {}
        for key in ("attn_ln", "fc1", "fc2", "ffn_ln", "k", "o", "q", "v"):
            blk[key] = ln() if key.endswith("_ln") else lin()
        blocks.append(blk)
    lm_bias = next(it)
    lm_dense = lin()
    lm_ln = ln()
    return {"embed": embed, "final_ln": final_ln, "layers": blocks,
            "lm_bias": lm_bias, "lm_dense": lm_dense, "lm_ln": lm_ln}


def esm_perm(device) -> torch.Tensor:
    """[20, 33]: PPDE's letters to ESM's tokens."""
    perm = torch.zeros((20, ESM_VOCAB), device=device)
    for k, a in enumerate(ALPHABET):
        perm[k, ESM_TOKS.index(a)] = 1.0
    return perm


def _rotary(x):
    """Rotary embedding of [B, H, T, hd] (fair-esm's RotaryEmbedding)."""
    T, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device=x.device,
                                          dtype=torch.float32) / hd))
    freqs = torch.outer(torch.arange(T, device=x.device,
                                     dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], -1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * emb.cos() + torch.cat([-x2, x1], -1) * emb.sin()


def esm_pll(p, x33, heads: int, pr: Precision):
    """Pseudo-log-likelihood [B] of ESM one-hots x33 [B, T, 33]. ``r``
    marks every tensor the served expert holds in its stated type (the
    weights, the residual stream, each product's and norm's output); the
    control rounds each of them one type lower."""
    r = pr.bf16

    def lin(pp, v):
        return r(v @ r(pp["w"]) + r(pp["b"]))

    def ln(pp, v):
        return r(F.layer_norm(v, v.shape[-1:], pp["g"], pp["b"], 1e-5))

    B, T, _ = x33.shape
    mask_w = x33[..., ESM_TOKS.index("<mask>")]
    h = r(x33 @ r(p["embed"]))
    h = h * (1.0 - mask_w[..., None])
    h = r(h * ((1.0 - MASK_RATIO_TRAIN) / (1.0 - mask_w.mean(-1)))[:, None,
                                                                     None])
    D = h.shape[-1]
    hd = D // heads
    for blk in p["layers"]:
        y = ln(blk["attn_ln"], h)

        def heads_of(t):
            return t.reshape(B, T, heads, hd).transpose(1, 2)

        q = r(_rotary(r(heads_of(lin(blk["q"], y)) * (1.0 / math.sqrt(hd)))))
        k = r(_rotary(heads_of(lin(blk["k"], y))))
        v = heads_of(lin(blk["v"], y))
        a = torch.softmax(q @ k.transpose(-1, -2), -1)
        o = r((a @ v).transpose(1, 2).reshape(B, T, D))
        h = r(h + lin(blk["o"], o))
        y = ln(blk["ffn_ln"], h)
        h = r(h + lin(blk["fc2"], r(F.gelu(lin(blk["fc1"], y)))))
    y = ln(p["final_ln"], h)
    y = ln(p["lm_ln"], r(F.gelu(lin(p["lm_dense"], y))))
    logits = y @ p["embed"].T + p["lm_bias"]
    return (x33 * torch.log_softmax(logits, -1)).sum((1, 2))


class Reference:
    """The energy E(x) = [Potts delta] + [ESM2 PLL delta] + lam * fitness
    over one-hots [B, L, 20], from the raw weights of ``load``."""

    def __init__(self, raw: dict, lam: float, esm_layers: int | None = None,
                 esm_heads: int = 20, precision: str = "reference"):
        self.raw, self.lam = raw, lam
        self.pr = Precision(precision)
        self.esm = (esm_tree(raw["esm"], esm_layers)
                    if raw["esm"] is not None else None)
        self.heads = esm_heads
        dev = raw["potts_W"].device
        self.wt = torch.from_numpy(onehot(raw["wt"]))[None].to(dev)
        self.perm = esm_perm(dev)
        with torch.no_grad(), no_tf32():
            self.wt_H = potts_H(raw["potts_W"], raw["potts_h"], self.wt,
                                self.pr)
            self.wt_pll = (esm_pll(self.esm, self.wt @ self.perm, self.heads,
                                   self.pr) if self.esm is not None else None)

    def _terms(self, x):
        fit = cnn_fitness(self.raw["cnn"], x, self.pr)
        e = self.lam * fit + potts_H(self.raw["potts_W"], self.raw["potts_h"],
                                     x, self.pr) - self.wt_H
        if self.esm is not None:
            e = e + esm_pll(self.esm, x @ self.perm, self.heads,
                            self.pr) - self.wt_pll
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
