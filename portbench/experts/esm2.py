"""ESM2 (Lin et al. 2023; fair-esm's ``ESM2``) as the transformer expert.

The configuration's ``"esm2"`` group gives the widths (``layers``,
``embed_dim``, ``attention_heads``, ``ffn_embed_dim``, ``vocab``), the
program's name of the model (``program_name``, e.g. ``transformer-M``), the
served type (``dtype``: bfloat16, the one the program's loader has) and the
scales of the random weights.

The file: ``esm2.npz``, every leaf in the native checkpoint's order (dict
keys sorted, lists in order), weights and the linear biases rounded to
bfloat16, the layer norms and the LM bias in float32.

The reference term, as PPDE's one-hot fork scores it: the one-hot [T, 20]
mapped to ESM's 33 tokens with no BOS or EOS, the embedding x @ E times the
eval-mode token-dropout factor 0.88, pre-LN rotary attention blocks with the
erf GELU, the final layer norm and the tied LM head; the score is the
pseudo-log-likelihood sum_i x_i . log_softmax(logits_i) (the reference takes
it less the wild type's). The control rounds every tensor the served expert
holds in bfloat16 (weights, the residual stream, each product's and norm's
output) to float8 e4m3 under a per-tensor scale, the norms, softmax and
logits in float32 as the program has them.

Kernels C (``attention_fused._fwd_cuda``) and C' (``_bwd_cuda``, which
autograd's backward calls on its own thread) are the attention core; the
program's spans inside the model are ``esm2.*``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from portbench.proteins import _normal
from portbench.reference import ALPHABET

FILE = "esm2.npz"
DTYPE = "bfloat16"  # the one type the program's loader serves
SPAN_PREFIX = "esm2."
# chains a block of the reference's autograd: ESM2 in float32 keeps ~0.3 GB
# of activations a chain at GFP's length
REFERENCE_BLOCK = 16
KERNELS = {
    "kernel_c": ("ppde_tpu_torch.ops.attention_fused", "_fwd_cuda",
                 "launches_fwd"),
    "kernel_c_bwd": ("ppde_tpu_torch.ops.attention_fused", "_bwd_cuda",
                     "launches_bwd"),
}
ESM_TOKS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
ESM_VOCAB = len(ESM_TOKS)
MASK_RATIO_TRAIN = 0.15 * 0.8
FP8_MAX = 448.0  # largest float8 e4m3 value


# ---------------------------------------------------------------------------
# the program's side: its CLI term and arguments, the type it serves
# ---------------------------------------------------------------------------

def cli_term(cfg: dict) -> str:
    return cfg["program_name"]


def cli_args(cfg: dict, files: dict) -> dict:
    """The weights written from the seed; the program decides, as for the
    CLI's defaults, the pieces the chains are scored in."""
    return {"esm_weights": files[FILE], "allow_random_esm": False,
            "esm_chunk": 0}


def check_dtype(cfg: dict) -> None:
    if cfg["dtype"] != DTYPE:
        raise ValueError(f"ESM2 dtype {cfg['dtype']!r}: the program serves "
                         f"ESM2 in {DTYPE} only")


def forward_flops(cfg: dict, T: int) -> int:
    """FLOPs of one ESM2 forward over T tokens: a layer's q, k, v, o
    projections 8 T D^2, its FFN 4 T D F, its scores and values 4 T^2 D,
    and the embedding and LM head 4 T D V (``chip_smoke.py:2401``)."""
    D, ffn = cfg["embed_dim"], cfg["ffn_embed_dim"]
    return cfg["layers"] * (8 * T * D * D + 4 * T * D * ffn
                            + 4 * T * T * D) + 4 * T * D * cfg["vocab"]


# ---------------------------------------------------------------------------
# the weights, from the seed
# ---------------------------------------------------------------------------

def esm_leaves(cfg: dict) -> list[tuple[str, tuple]]:
    """(kind, shape) of every leaf of an ESM2 tree in the native
    checkpoint's order; kind: weight, bias, ln_g, ln_b, lm_bias."""
    D, Fd, N = cfg["embed_dim"], cfg["ffn_embed_dim"], cfg["layers"]

    def lin(i, o):
        return [("bias", (o,)), ("weight", (i, o))]

    def ln(d):
        return [("ln_b", (d,)), ("ln_g", (d,))]

    layer = (ln(D) + lin(D, Fd) + lin(Fd, D) + ln(D)      # attn_ln fc1 fc2
             + lin(D, D) + lin(D, D) + lin(D, D) + lin(D, D))  # ffn_ln k o q v
    return ([("weight", (ESM_VOCAB, D))] + ln(D) + layer * N
            + [("lm_bias", (ESM_VOCAB,))] + lin(D, D) + ln(D))


def esm_arrays(gen, cfg: dict, device) -> list[np.ndarray]:
    """Every leaf, drawn as one normal vector and scaled per leaf: weights
    N(0, 1/fan_in) (the embedding N(0, init_embed_std^2)), biases, layer-norm
    offsets and the LM bias N(0, init_bias_std^2), layer-norm gains 1 +
    N(0, init_bias_std^2); weights and linear biases rounded to bfloat16."""
    leaves = esm_leaves(cfg)
    sizes = [math.prod(s) for _, s in leaves]
    z = _normal(gen, sum(sizes), device)
    out, off = [], 0
    bstd = cfg["init_bias_std"]
    for (kind, shape), n in zip(leaves, sizes):
        a = z[off:off + n].reshape(shape)
        off += n
        if kind == "weight":
            std = (cfg["init_embed_std"] if shape[0] == ESM_VOCAB
                   else 1.0 / math.sqrt(shape[0]))
            a = (a * std).to(torch.bfloat16).float()
        elif kind == "bias":
            a = (a * bstd).to(torch.bfloat16).float()
        elif kind == "ln_g":
            a = 1.0 + a * bstd
        else:
            a = a * bstd
        out.append(a.cpu().numpy())
    return out


def write(gen, cfg: dict, path: str, wt: str, device) -> dict:
    esm_file = os.path.join(path, FILE)
    leaves = esm_arrays(gen, cfg, device)
    np.savez(esm_file, step=0, **{f"p{i}": a for i, a in enumerate(leaves)})
    return {FILE: esm_file}


# ---------------------------------------------------------------------------
# the plain reference and the control's rounding
# ---------------------------------------------------------------------------

def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 under a per-tensor scale that maps
    its largest magnitude to e4m3's largest value."""
    t = t.float()
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


control_round = round_fp8


def _npz_leaves(path):
    z = np.load(path)
    n = len([k for k in z.files if k.startswith("p") and k[1:].isdigit()])
    return [z[f"p{i}"] for i in range(n)]


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


def esm_pll(p, x33, heads: int, r):
    """Pseudo-log-likelihood [B] of ESM one-hots x33 [B, T, 33]. ``r``
    marks every tensor the served expert holds in its stated type (the
    weights, the residual stream, each product's and norm's output); the
    control rounds each of them one type lower."""

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


def reference_term(protein_dir: str, cfg: dict, device):
    """The PLL of one-hots [B, L, 20] from the directory's ``esm2.npz``,
    read in float32 on ``device``."""
    leaves = [torch.from_numpy(np.asarray(z2, np.float32)).to(device)
              for z2 in _npz_leaves(os.path.join(protein_dir, FILE))]
    tree = esm_tree(leaves, cfg["layers"])
    perm = esm_perm(device)
    heads = cfg["attention_heads"]

    def score(x, r):
        return esm_pll(tree, x @ perm, heads, r)
    return score
