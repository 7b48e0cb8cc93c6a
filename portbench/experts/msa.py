"""The MSA Transformer (Rao et al. 2021, "MSA Transformer", ICML; fair-esm's
``MSATransformer``, ``esm_msa1b_t12_100M_UR50S``) as the evolutionary
expert: the chain is row 0 of an alignment whose other rows are fixed
homologs.

The configuration's ``"msa"`` group gives the widths (``layers``,
``embed_dim``, ``attention_heads``, ``ffn_embed_dim``, ``vocab``,
``max_positions``), the alignment's ``rows`` (the chain's and rows - 1
context rows), the program's name of the model (``program_name``), the
served type (``dtype``: bfloat16) and the scales of the random weights.

The files: ``msa.npz``, every leaf of the program's native layout (dict keys
sorted, lists in order; linear weights [in, out]), the embeddings, position
tables, weights and linear biases rounded to bfloat16, the layer norms and
the LM bias in float32; ``msa_context.a2m``, the rows - 1 context rows,
drawn without replacement from the rows of the tracked synthetic GFP
alignment (``data/proteins/synthetic/GFP_AEQVI_Sarkisyan2016_synth.a2m``:
Potts samples of 237 residues, no gaps) below its first row, which is GFP's
wild type and whose place the chain takes.

The reference term, following fair-esm's ``MSATransformer.forward``,
``AxialTransformerLayer``, ``RowSelfAttention`` and ``ColumnSelfAttention``:
the alignment [R, C] with a ``<cls>`` column, its one-hots times the
embedding (row 0 the chain's one-hots mapped to ESM's 33 tokens), plus the
learned column positions and the per-row MSA positions, the layer norm
before; 12 layers of tied row attention (the logits over column pairs
summed across the rows, q scaled by 1 / (sqrt(hd) sqrt(R)), one softmax per
head shared by every row), column attention (across the rows within each
column, q scaled by 1 / sqrt(hd)) and the FFN (erf GELU), each pre-LN with a
residual; the final layer norm and the LM head (dense, GELU, layer norm,
the tied embedding and a bias) on row 0; the score is the
pseudo-log-likelihood sum_c x_c . log_softmax(logits_{0, c}) over the L
residue columns (the reference takes it less the wild type's). Departures
from fair-esm: no masking and no dropout (PPDE's unmasked one-hot PLL,
eval mode); the column positions' table holds fair-esm's rows from 2 on
(its ``LearnedPositionalEmbedding`` has max_positions + 2 rows and reads
column c at row c + 2, the padding index 1 plus one), so column c reads row
c; R > 1 always, so fair-esm's one-row branch of column attention is never
taken. The control rounds every tensor the served expert holds in bfloat16
(weights, the residual stream, each product's and norm's output, the
attention weights) to float8 e4m3 under a per-tensor scale, as ESM2's.

Kernels T (``row_attention_fused._fwd_cuda``) and T' (``_bwd_cuda``) are
the tied row attention; the column attention runs kernels C and C', which
``esm2.py`` already lists under ``kernel_c`` / ``kernel_c_bwd``. A program
that has no wrapper of T and T' (a checkout from before this expert) lists
no kernels here and is refused by ``check_dtype``. The program's spans
inside the model are ``msa.*``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from portbench.experts.esm2 import ESM_TOKS, ESM_VOCAB, esm_perm, round_fp8
from portbench.proteins import _normal

FILE = "msa.npz"
CONTEXT = "msa_context.a2m"
DTYPE = "bfloat16"  # the type the benchmark serves the expert in
SPAN_PREFIX = "msa."
# chains a block of the reference's autograd: the float32 model keeps ~8 GB
# of activations a chain over GFP's 32-row alignment
REFERENCE_BLOCK = 4
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ALIGNMENT = os.path.join(ROOT, "data", "proteins", "synthetic",
                         "GFP_AEQVI_Sarkisyan2016_synth.a2m")
_WRAPPER = ("ppde_tpu_torch", "ops", "row_attention_fused.py")
SERVED = os.path.isfile(os.path.join(ROOT, *_WRAPPER))
KERNELS = {
    "kernel_t": ("ppde_tpu_torch.ops.row_attention_fused", "_fwd_cuda",
                 "launches_fwd"),
    "kernel_t_bwd": ("ppde_tpu_torch.ops.row_attention_fused", "_bwd_cuda",
                     "launches_bwd"),
} if SERVED else {}
CLS = ESM_TOKS.index("<cls>")


# ---------------------------------------------------------------------------
# the program's side: its CLI term and arguments, the type it serves
# ---------------------------------------------------------------------------

def cli_term(cfg: dict) -> str:
    return cfg["program_name"]


def cli_args(cfg: dict, files: dict) -> dict:
    """The weights and the context written from the seed; the program
    decides the pieces the chains are scored in and their recomputation."""
    return {"msa_expert_weights": files[FILE], "allow_random_esm": False,
            "msa_expert_context": files[CONTEXT],
            "msa_expert_rows": int(cfg["rows"]), "esm_chunk": 0}


def check_dtype(cfg: dict) -> None:
    if not SERVED:
        raise ValueError("this program has no MSA Transformer expert (no "
                         + "/".join(_WRAPPER) + ")")
    if cfg["dtype"] != DTYPE:
        raise ValueError(f"MSA Transformer dtype {cfg['dtype']!r}: the "
                         f"benchmark serves it in {DTYPE} only")


def forward_flops(cfg: dict, L: int) -> int:
    """FLOPs of one forward over an alignment of ``rows`` rows and C = L + 1
    columns (T = rows C tokens): a layer's two attentions' q, k, v, o
    projections 16 T D^2, its FFN 4 T D F, the tied row attention's scores
    and values 4 rows C^2 D, the column attention's 4 C rows^2 D; the
    chain's embedding 2 L V D and the LM head on row 0's L residue columns
    2 L D^2 + 2 L D V."""
    D, ffn, V = cfg["embed_dim"], cfg["ffn_embed_dim"], cfg["vocab"]
    R, C = cfg["rows"], L + 1
    T = R * C
    layer = (16 * T * D * D + 4 * T * D * ffn + 4 * R * C * C * D
             + 4 * C * R * R * D)
    return cfg["layers"] * layer + 2 * L * V * D + 2 * L * D * D \
        + 2 * L * D * V


def row_attention_bytes_ops(N: int, cfg: dict, L: int, backward: bool):
    """Kernel T (forward) or T' (backward) on N alignments: q, k, v read
    and o written once (backward: q, k, v, dout read and dq, dk, dv
    written), N rows C D elements each; 2 (backward 5) products of 2 N H
    C^2 rows hd = 2 N rows C^2 D operations."""
    D, R, C = cfg["embed_dim"], cfg["rows"], L + 1
    n = N * R * C * D
    s = 2 if cfg["dtype"] == "bfloat16" else 4
    if backward:
        return 7 * n * s, 10 * n * C
    return 4 * n * s, 4 * n * C


# ---------------------------------------------------------------------------
# the weights and the context, from the seed
# ---------------------------------------------------------------------------

def msa_leaves(cfg: dict) -> list[tuple[str, tuple]]:
    """(kind, shape) of every leaf of the program's tree in its native
    checkpoint's order (dict keys sorted, lists in order); kind: embed,
    pos, msa_pos, weight, bias, ln_g, ln_b, lm_bias."""
    D, Fd, P = cfg["embed_dim"], cfg["ffn_embed_dim"], cfg["max_positions"]

    def lin(i, o):
        return [("bias", (o,)), ("weight", (i, o))]

    def ln(d):
        return [("ln_b", (d,)), ("ln_g", (d,))]

    attn = lin(D, D) * 4                                         # k o q v
    layer = (attn + ln(D) + lin(D, Fd) + lin(Fd, D) + ln(D)  # col col_ln fc1
             + attn + ln(D))                          # fc2 ffn_ln row row_ln
    return ([("embed", (cfg["vocab"], D))] + layer * cfg["layers"]
            + [("lm_bias", (cfg["vocab"],))] + lin(D, D)       # lm_dense
            + ln(D) + ln(D) + ln(D)                 # lm_ln ln_after ln_before
            + [("msa_pos", (P, D)), ("pos", (P, D))])


def msa_arrays(gen, cfg: dict, device) -> list[np.ndarray]:
    """Every leaf, drawn as one normal vector and scaled per leaf: weights
    N(0, 1/fan_in), the embedding N(0, init_embed_std^2), the column
    positions N(0, init_pos_std^2), the MSA positions N(0, init_msa_pos_std^2)
    (fair-esm's 0.01), biases, layer-norm offsets and the LM bias N(0,
    init_bias_std^2), layer-norm gains 1 + N(0, init_bias_std^2); all but
    the layer norms and the LM bias rounded to bfloat16."""
    leaves = msa_leaves(cfg)
    sizes = [math.prod(s) for _, s in leaves]
    z = _normal(gen, sum(sizes), device)
    std = {"embed": cfg["init_embed_std"], "pos": cfg["init_pos_std"],
           "msa_pos": cfg["init_msa_pos_std"], "bias": cfg["init_bias_std"]}
    out, off = [], 0
    bstd = cfg["init_bias_std"]
    for (kind, shape), n in zip(leaves, sizes):
        a = z[off:off + n].reshape(shape)
        off += n
        if kind in std or kind == "weight":
            s = std[kind] if kind in std else 1.0 / math.sqrt(shape[0])
            a = (a * s).to(torch.bfloat16).float()
        elif kind == "ln_g":
            a = 1.0 + a * bstd
        else:
            a = a * bstd
        out.append(a.cpu().numpy())
    return out


def read_fasta(path: str) -> list[tuple[str, str]]:
    """(header, sequence) of every record."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                out.append([line, ""])
            elif line and out:
                out[-1][1] += line
    return [(h, s) for h, s in out]


def context_rows(gen, wt: str, n: int, device) -> list[tuple[str, str]]:
    """n rows of the tracked alignment below its first (the wild type's),
    drawn without replacement by ``gen``."""
    rows = read_fasta(ALIGNMENT)
    if rows[0][1] != wt:
        raise ValueError(f"the MSA expert's context is drawn from "
                         f"{ALIGNMENT}, whose first row is not the traffic's "
                         f"wild type")
    pick = torch.randperm(len(rows) - 1, generator=gen, device=device)[:n]
    return [rows[1 + int(i)] for i in pick.cpu()]


def write(gen, cfg: dict, path: str, wt: str, device) -> dict:
    weights = os.path.join(path, FILE)
    leaves = msa_arrays(gen, cfg, device)
    np.savez(weights, step=0, **{f"p{i}": a for i, a in enumerate(leaves)})
    ctx = os.path.join(path, CONTEXT)
    with open(ctx, "w") as f:
        for name, seq in context_rows(gen, wt, cfg["rows"] - 1, device):
            f.write(f"{name}\n{seq}\n")
    return {FILE: weights, CONTEXT: ctx}


# ---------------------------------------------------------------------------
# the plain reference and the control's rounding
# ---------------------------------------------------------------------------

control_round = round_fp8


def msa_tree(leaves, layers: int):
    """The weights from the leaves of a native checkpoint (linear weights
    [in, out])."""
    it = iter(leaves)

    def lin():
        b, w = next(it), next(it)
        return {"b": b, "w": w}

    def ln():
        b, g = next(it), next(it)
        return {"b": b, "g": g}

    def attn():
        return {key: lin() for key in ("k", "o", "q", "v")}

    embed = next(it)
    blocks = []
    for _ in range(layers):
        blk = {"col": attn(), "col_ln": ln(), "fc1": lin(), "fc2": lin(),
               "ffn_ln": ln(), "row": attn(), "row_ln": ln()}
        blocks.append(blk)
    lm_bias = next(it)
    lm_dense, lm_ln, ln_after, ln_before = lin(), ln(), ln(), ln()
    msa_pos, pos = next(it), next(it)
    return {"embed": embed, "layers": blocks, "lm_bias": lm_bias,
            "lm_dense": lm_dense, "lm_ln": lm_ln, "ln_after": ln_after,
            "ln_before": ln_before, "msa_pos": msa_pos, "pos": pos}


def context_onehots(rows: list[str], device) -> torch.Tensor:
    """[len(rows), C, 33] ESM one-hots of the context rows, ``<cls>``
    first."""
    toks = [[CLS] + [ESM_TOKS.index(a) for a in row] for row in rows]
    return F.one_hot(torch.tensor(toks, device=device), ESM_VOCAB).float()


def msa_pll(p, x33, ctx33, heads: int, r):
    """Pseudo-log-likelihood [B] of row 0's ESM one-hots x33 [B, L, 33]
    over the alignment whose other rows are ctx33 [R - 1, L + 1, 33]. ``r``
    marks every tensor the served expert holds in its stated type; the
    control rounds each of them one type lower."""

    def lin(pp, v):
        return r(v @ r(pp["w"]) + r(pp["b"]))

    def ln(pp, v):
        return r(F.layer_norm(v, v.shape[-1:], pp["g"], pp["b"], 1e-5))

    B, L, _ = x33.shape
    R, C = ctx33.shape[0] + 1, L + 1
    cls = torch.zeros((B, 1, ESM_VOCAB), device=x33.device)
    cls[..., CLS] = 1.0
    tok = torch.cat([torch.cat([cls, x33], 1)[:, None],
                     ctx33.expand(B, *ctx33.shape)], 1)         # [B, R, C, V]
    E = r(p["embed"])
    h = r(r(tok @ E) + r(p["pos"][:C]))
    h = ln(p["ln_before"], r(h + r(p["msa_pos"][:R, None])))
    D = h.shape[-1]
    hd = D // heads

    def split(t):
        return t.reshape(B, R, C, heads, hd)

    for blk in p["layers"]:
        # tied row attention: one softmax over column pairs per head
        y = ln(blk["row_ln"], h)
        q, k, v = (split(lin(blk["row"][n], y)) for n in "qkv")
        s = torch.einsum("brchd,brehd->bhce", q, k) / (math.sqrt(hd)
                                                       * math.sqrt(R))
        a = r(torch.softmax(s, -1))
        o = r(torch.einsum("bhce,brehd->brchd", a, v))
        h = r(h + lin(blk["row"]["o"], o.reshape(B, R, C, D)))
        # column attention: across the rows within each column
        y = ln(blk["col_ln"], h)
        q, k, v = (split(lin(blk["col"][n], y)) for n in "qkv")
        q = r(q / math.sqrt(hd))
        a = r(torch.softmax(torch.einsum("bichd,bjchd->bchij", q, k), -1))
        o = r(torch.einsum("bchij,bjchd->bichd", a, v))
        h = r(h + lin(blk["col"]["o"], o.reshape(B, R, C, D)))
        y = ln(blk["ffn_ln"], h)
        h = r(h + lin(blk["fc2"], r(F.gelu(lin(blk["fc1"], y)))))
    y = ln(p["ln_after"], h[:, 0, 1:])
    y = ln(p["lm_ln"], r(F.gelu(lin(p["lm_dense"], y))))
    logits = y @ p["embed"].T + p["lm_bias"]
    return (x33 * torch.log_softmax(logits, -1)).sum((1, 2))


def reference_term(protein_dir: str, cfg: dict, device):
    """The PLL of one-hots [B, L, 20] from the directory's ``msa.npz`` and
    ``msa_context.a2m`` (its first rows - 1 rows), read in float32 on
    ``device``."""
    z = np.load(os.path.join(protein_dir, FILE))
    n = len([k for k in z.files if k.startswith("p") and k[1:].isdigit()])
    leaves = [torch.from_numpy(np.asarray(z[f"p{i}"], np.float32)).to(device)
              for i in range(n)]
    tree = msa_tree(leaves, cfg["layers"])
    rows = [s for _, s in read_fasta(os.path.join(protein_dir, CONTEXT))]
    ctx33 = context_onehots(rows[:cfg["rows"] - 1], device)
    perm = esm_perm(device)
    heads = cfg["attention_heads"]

    def score(x, r):
        return msa_pll(tree, x @ perm, ctx33, heads, r)
    return score
