"""MSA Transformer (axial attention over alignments), the evolutionary-density
scorer.

Counterpart of ``ppde_tpu/models/msa_transformer.py`` with the same names
and the same parameter layout (a plain dict of tensors, weights
``[in, out]``, linear leaves ``{"w", "b"}``, layer norms ``{"g", "b"}`` in
float32):

    {"embed", "pos_embed", "msa_pos_embed", "layers": [{"row_ln", "row":
    {"q", "k", "v", "o"}, "col_ln", "col": {...}, "ffn_ln", "fc1", "fc2"}],
    "ln_before", "ln_after", "lm_dense", "lm_ln", "lm_bias"}

The architecture of fair-esm's ``esm_msa1b_t12_100M_UR50S`` (the reference
scorer, reference metrics.py:22-76): tied row attention (logits over column
pairs summed across the alignment's rows), column attention (across rows),
FFN, all pre-LN, learned column positions, a per-row MSA position
embedding and the tied LM head. The rounding follows the JAX package's:
scores in the compute type, softmax in float32 cast back (torch's softmax
of bf16 scores computes in float32 and rounds once), exact (erf) GELU at
every type, layer norms in float32.

Every product of the scorer (``forward_logits``, ``masked_marginals``) is a
plain PyTorch matrix product: the JAX module reaches no Pallas kernel.
Weights come from a native ``.npz`` (``training.save_ckpt``'s layout), a
fair-esm msa1b ``.pt``, or (pipeline checks only) a seeded random init.

``masked_marginals`` scores each masked wild-type column with one forward;
a batch of columns is one forward of ``batch_cols`` alignments, and the LM
head runs only at the masked position it reads.

``load_expert`` makes the model a product-of-experts term of the protein
sampler, as ``esm2.load_expert`` does ESM2: row 0 of an alignment carries
the chain's one-hots (their product with the embedding, so that the
gradient reaches them) and the context rows, embedded once, follow it; the
score is the unmasked one-hot pseudo-log-likelihood of row 0. Its tied row
attention runs in kernels T and T' (``ops/row_attention_fused``) and its
column attention in kernels C and C' (``ops/attention_fused``, one
head-major copy of q, k and v each way) and its layer norms in one kernel
each way (``esm2._layer_norm``: ``ops/layer_norm_fused``) on a CUDA
tensor, their plain versions on a CPU tensor. Spans (``profiling``): the
forward in ``msa.<kind>`` (embed, norm, qkv, row, col, attn_out, ffn, head;
the kernels in ``kernel.t`` and ``kernel.c``), inside
``profiling.grad_spans()`` the backward of each kind in ``msa.bwd.<kind>``
(T' and C' outside the kinds).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ppde_tpu_torch import codec, profiling, utils
from ppde_tpu_torch.models.esm2 import (CLS_IDX, ESM_TOK_TO_IDX, ESM_VOCAB,
                                        MASK_IDX, PAD_IDX, _flatten,
                                        _layer_norm, _linear, _map_leaves,
                                        _unflatten, potts_to_esm_perm)
from ppde_tpu_torch.ops import attention_fused, row_attention_fused

# "msa-1b" is fair-esm's esm_msa1b_t12_100M architecture (the reference's
# scorer); the smaller entries are the JAX package's family-trained scorers
CONFIGS = {
    "msa-1b": dict(layers=12, dim=768, heads=12, ffn=3072, max_pos=1024),
    "msa-S": dict(layers=4, dim=256, heads=8, ffn=1024, max_pos=1024),
    "msa-tiny": dict(layers=2, dim=32, heads=2, ffn=64, max_pos=256),
}
CFG = CONFIGS["msa-1b"]


def heads_of(name: str) -> int:
    return CONFIGS[name]["heads"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _shapes(name: str) -> dict:
    """The parameter tree of config ``name`` with shapes as leaves."""
    cfg = CONFIGS[name]
    D, Fd, N, P = cfg["dim"], cfg["ffn"], cfg["layers"], cfg["max_pos"]

    def lin(i, o):
        return {"w": (i, o), "b": (o,)}

    def ln(d):
        return {"g": (d,), "b": (d,)}

    def attn():
        return {x: lin(D, D) for x in ("q", "k", "v", "o")}

    def layer():
        return {"row_ln": ln(D), "row": attn(), "col_ln": ln(D),
                "col": attn(), "ffn_ln": ln(D), "fc1": lin(D, Fd),
                "fc2": lin(Fd, D)}

    return {"embed": (ESM_VOCAB, D), "pos_embed": (P, D),
            "msa_pos_embed": (P, D), "layers": [layer() for _ in range(N)],
            "ln_before": ln(D), "ln_after": ln(D), "lm_dense": lin(D, D),
            "lm_ln": ln(D), "lm_bias": (ESM_VOCAB,)}


def _keeps_f32(path) -> bool:
    """Layer-norm affines and the LM bias stay float32 (keyed on the path:
    layer-norm and linear leaves share the key 'b')."""
    return any(isinstance(k, str) and (k.endswith("ln") or k in (
        "ln_before", "ln_after", "lm_bias")) for k in path)


def init(generator: torch.Generator, dtype=torch.bfloat16,
         scale: float = 0.02, name: str = "msa-1b") -> dict:
    """Random parameters on ``generator.device``: normal * scale weights
    and embeddings (the MSA position embedding * 0.01) in ``dtype``, zero
    biases, unit layer norms; layer norms and the LM bias in float32."""
    device = utils.resolve_device(generator.device)

    def leaf(path, shape):
        f32 = _keeps_f32(path)
        dt = torch.float32 if f32 else dtype
        if path[-1] == "g":
            return torch.ones(shape, dtype=dt, device=device)
        if path[-1] == "b" or path[-1] == "lm_bias":
            return torch.zeros(shape, dtype=dt, device=device)
        s = 0.01 if path[-1] == "msa_pos_embed" else scale
        return (torch.randn(shape, generator=generator, device=device)
                * s).to(dt)

    return _map_leaves(_shapes(name), leaf)


def cast_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Matmul weights and embeddings -> ``dtype``; every key ending in
    'ln', ``ln_before``, ``ln_after`` and ``lm_bias`` -> float32 (the layout
    ``init`` produces)."""
    def leaf(path, a):
        return a.to(torch.float32 if _keeps_f32(path) else dtype)

    return _map_leaves(params, leaf)


# ---------------------------------------------------------------------------
# forward (esm2's _layer_norm: float32, cast back to x's type; its _linear:
# x @ w + b). Attention weights are [B, H, C, C] (row) and [C, R, R] per
# (item, head) (column).
# ---------------------------------------------------------------------------

def _qkv(p, x, H):
    """q, k, v [B, R, C, H, hd] of x [B, R, C, D]."""
    B, R, C, D = x.shape
    return tuple(_linear(p[n], x).reshape(B, R, C, H, D // H)
                 for n in ("q", "k", "v"))


def _tied_row_attention(p, x, H):
    """Tied row attention on x [B, R, C, D]: logits over column pairs summed
    across rows, q scaled by 1 / (sqrt(hd) * sqrt(R)) in the compute type
    before the product (fair-esm's scaling)."""
    B, R, C, D = x.shape
    hd = D // H
    q, k, v = _qkv(p, x, H)
    scaling = 1.0 / (math.sqrt(hd) * math.sqrt(max(R, 1)))
    # [B, H, C, R*hd] x [B, H, R*hd, C]: one product sums over rows and
    # dims; q rounded after the scaling, before the product
    qm, km, vm = (t.permute(0, 3, 2, 1, 4).reshape(B, H, C, R * hd)
                  for t in (q, k, v))
    w = torch.softmax(qm.mul_(scaling) @ km.transpose(-1, -2), -1)
    out = (w @ vm).reshape(B, H, C, R, hd).permute(0, 3, 2, 1, 4)
    return _linear(p["o"], out.reshape(B, R, C, D))


def _column_attention(p, x, H):
    """Column attention on x [B, R, C, D]: attention across rows within
    each column, q divided by sqrt(hd). One batched product over the C
    columns per (item, head), reading q, k and v where they lie (strided
    matrices, no copies); an (item, head)'s scores are [C, R, R]. Under
    autograd (the trainer) the products' outputs are stacked, since an
    ``out=`` product is not differentiable."""
    B, R, C, D = x.shape
    hd = D // H
    q, k, v = _qkv(p, x, H)                                    # [B,R,C,H,hd]
    q = q / math.sqrt(hd)
    grad = torch.is_grad_enabled() and q.requires_grad
    out = torch.empty((B, H, C, R, hd), dtype=x.dtype, device=x.device)
    outs = []
    for b in range(B):
        for h in range(H):
            qh, kh, vh = (t[b, :, :, h].transpose(0, 1)        # [C, R, hd]
                          for t in (q, k, v))
            w = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)), -1)
            if grad:
                outs.append(torch.bmm(w, vh))
            else:
                torch.bmm(w, vh, out=out[b, h])
    if grad:
        out = torch.stack(outs).reshape(B, H, C, R, hd)
    out = out.permute(0, 3, 2, 1, 4).reshape(B, R, C, D)
    return _linear(p["o"], out)


def _trunk(params, tokens: torch.Tensor, heads: int) -> torch.Tensor:
    """tokens [B, R, C] -> the last layer's residual stream [B, R, C, D]."""
    B, R, C = tokens.shape
    x = params["embed"][tokens.long()]                         # gather
    x = x + params["pos_embed"][:C][None, None]
    x = x + params["msa_pos_embed"][:R][None, :, None]
    x = _layer_norm(params["ln_before"], x)
    for layer in params["layers"]:
        x = x + _tied_row_attention(layer["row"],
                                    _layer_norm(layer["row_ln"], x), heads)
        x = x + _column_attention(layer["col"],
                                  _layer_norm(layer["col_ln"], x), heads)
        y = _layer_norm(layer["ffn_ln"], x)
        y = F.gelu(_linear(layer["fc1"], y), approximate="none")
        x = x + _linear(layer["fc2"], y)
    return x


def _lm_head(params, x: torch.Tensor) -> torch.Tensor:
    """Residual stream [..., D] -> tied-embedding logits [..., 33] in float32
    against the float32 copy of ``embed``, plus ``lm_bias``. Acts on each
    token alone."""
    x = _layer_norm(params["ln_after"], x)
    y = F.gelu(_linear(params["lm_dense"], x), approximate="none")
    y = _layer_norm(params["lm_ln"], y)
    return y.float() @ params["embed"].float().T + params["lm_bias"]


def forward_logits(params, tokens: torch.Tensor,
                   heads: int = 12) -> torch.Tensor:
    """tokens [B, R, C] int -> logits [B, R, C, 33] (float32).

    ``heads`` is static config (CONFIGS[name]["heads"]), kept out of the
    parameter dict as in esm2.forward_logits."""
    return _lm_head(params, _trunk(params, tokens, heads))


def tokenize_msa(rows: list[str]) -> np.ndarray:
    """Alignment rows -> [R, C+1] int tokens with a prepended <cls>; short
    rows are padded with <pad>."""
    C = len(rows[0])
    out = np.full((len(rows), C + 1), PAD_IDX, np.int32)
    out[:, 0] = CLS_IDX
    for r, row in enumerate(rows):
        for c, ch in enumerate(row):
            out[r, c + 1] = ESM_TOK_TO_IDX.get(ch, ESM_TOK_TO_IDX["<unk>"])
    return out


@torch.no_grad()
def masked_marginals(params, wt_window: str, msa_rows: list[str],
                     cols: list[int], batch_cols: int = 4,
                     heads: int = 12) -> np.ndarray:
    """log-softmax token probabilities at masked WT columns.

    Builds the [1 + len(msa_rows), C+1] alignment with the WT window as the
    first row, masks one window column of the WT row per batch item, and
    returns [len(cols), 33] log-probs at those positions (float32 numpy).
    ``batch_cols`` columns go through one forward; the last batch runs at
    its own size.
    """
    device = params["embed"].device
    base = torch.from_numpy(tokenize_msa([wt_window] + msa_rows)).to(
        device, torch.long)                                    # [R, C+1]
    out = []
    for s in range(0, len(cols), batch_cols):
        pos = torch.tensor(cols[s:s + batch_cols], device=device) + 1
        toks = base.repeat(len(pos), 1, 1)
        item = torch.arange(len(pos), device=device)
        toks[item, 0, pos] = MASK_IDX
        h = _trunk(params, toks, heads)[item, 0, pos]           # [b, D]
        out.append(torch.log_softmax(_lm_head(params, h), -1).cpu())
    return torch.cat(out).numpy()


# ---------------------------------------------------------------------------
# the product-of-experts term: row 0 carries the chain
# ---------------------------------------------------------------------------

def _expert_qkv(p, y, H):
    """q, k, v [N, R, C, H, hd] of y [N, R, C, D]: views of the projections'
    contiguous outputs."""
    with profiling.span("msa.qkv"):
        q, k, v = _qkv(p, y, H)
    return tuple(profiling.grad_span(t, "msa.bwd.qkv") for t in (q, k, v))


def _attn_out(p, h, o):
    """h plus the output projection of o [N, R, C, D]."""
    with profiling.span("msa.attn_out"):
        h = h + _linear(p, o)
    return profiling.grad_span(h, "msa.bwd.attn_out")


def _expert_row(p, h, y, H):
    """h plus the tied row attention of y [N, R, C, D]: kernels T and T'
    read q, k, v where the projections put them; the scale 1 / (sqrt(hd)
    sqrt(R)) applies to the float32 scores."""
    N, R, C, D = y.shape
    hd = D // H
    q, k, v = _expert_qkv(p, y, H)
    with profiling.span("msa.row"):
        o = row_attention_fused.tied_row_attention(
            q, k, v, 1.0 / (math.sqrt(hd) * math.sqrt(R)))
    o = profiling.grad_span(o, None)  # T' runs outside the kinds
    return _attn_out(p["o"], h, o.reshape(N, R, C, D))


def _expert_col(p, h, y, H):
    """h plus the column attention of y [N, R, C, D]: q, k, v copied once
    each into kernel C's [Z = N C H, T = R, hd], q divided by sqrt(hd) in
    the compute type (fair-esm's order), the output copied back."""
    N, R, C, D = y.shape
    hd = D // H
    q, k, v = _expert_qkv(p, y, H)
    with profiling.span("msa.col"):
        qc, kc, vc = (t.permute(0, 2, 3, 1, 4).contiguous().view(
            N * C * H, R, hd) for t in (q, k, v))
        qc = qc * (1.0 / math.sqrt(hd))
    qc, kc, vc = (profiling.grad_span(t, "msa.bwd.col") for t in (qc, kc, vc))
    o = profiling.grad_span(attention_fused.flash_attention(qc, kc, vc), None)
    with profiling.span("msa.col"):
        o = o.reshape(N, C, H, R, hd).permute(0, 3, 1, 2, 4).reshape(
            N, R, C, D)
    return _attn_out(p["o"], h, profiling.grad_span(o, "msa.bwd.col"))


def expert_layer(layer, h, heads: int):
    """One axial layer (tied row attention, column attention, FFN; each
    pre-LN with a residual) on the residual stream h [N, R, C, D]."""
    for kind, block in (("row", _expert_row), ("col", _expert_col)):
        with profiling.span("msa.norm"):
            y = _layer_norm(layer[kind + "_ln"], h)
        h = block(layer[kind], h, profiling.grad_span(y, "msa.bwd.norm"),
                  heads)
    with profiling.span("msa.norm"):
        y = _layer_norm(layer["ffn_ln"], h)
    y = profiling.grad_span(y, "msa.bwd.norm")
    with profiling.span("msa.ffn"):
        y = F.gelu(_linear(layer["fc1"], y), approximate="none")
        h = h + _linear(layer["fc2"], y)
    return profiling.grad_span(h, "msa.bwd.ffn")


def expert_score(params, x: torch.Tensor, heads: int,
                 remat: bool = False) -> torch.Tensor:
    """The pseudo-log-likelihood [N] of the chains x [N, L, 20] (PPDE's
    one-hots) as row 0 of the alignment whose other rows ``params["ctx"]``
    holds: sum_c x33_c . log_softmax(logits_{0, c}) over the L residue
    columns. ``remat``: ``torch.utils.checkpoint`` around every layer when
    autograd records (the layers' inputs kept, one layer recomputed at a
    time in the backward)."""
    with profiling.span("msa.embed"):
        x33 = x.to(params["perm"].dtype) @ params["perm"]        # [N, L, 33]
        N, L, _ = x33.shape
        emb = params["embed"]
        row0 = torch.cat([emb[CLS_IDX].expand(N, 1, -1), x33 @ emb], 1)
        row0 = row0 + params["pos_embed"][:L + 1]
        row0 = row0 + params["msa_pos_embed"][0]
        row0 = _layer_norm(params["ln_before"], row0)
        ctx = params["ctx"]                                      # [R-1, C, D]
        h = torch.cat([row0[:, None], ctx.expand(N, *ctx.shape)], 1)
    h = profiling.grad_span(h, "msa.bwd.embed")
    remat = remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            h = checkpoint(expert_layer, layer, h, heads, use_reentrant=False)
        else:
            h = expert_layer(layer, h, heads)
    with profiling.span("msa.head"):
        y = _layer_norm(params["ln_after"], h[:, 0, 1:])
        y = F.gelu(_linear(params["lm_dense"], y), approximate="none")
        y = _layer_norm(params["lm_ln"], y)
        logits = y.float() @ emb.float().T + params["lm_bias"]
        return (x33.float() * torch.log_softmax(logits, -1)).sum((1, 2))


def load_expert(name: str, wt_seq: str, context_rows: list[str],
                weights_path: str | None = None, allow_random: bool = False,
                dtype=torch.bfloat16, remat: bool | None = None,
                device="cuda"):
    """Build the MSA Transformer expert: (params, apply_fn) where
    apply_fn(params, x_potts_onehot [N, L, 20]) -> score(x) - score(wt) [N].

    ``context_rows``: the alignment's other rows, each of the wild type's
    length (at least one: the model's column attention needs two rows),
    tokenized, embedded and layer-normed once here (``params["ctx"]``) and
    broadcast over the chains. Weights as ``load`` resolves them.
    ``remat``: per-layer recomputation in the gradient (None: off).
    ``params`` also holds ``perm``, ``ctx`` and ``wt_score``."""
    device = utils.resolve_device(device)
    L = len(wt_seq)
    if not context_rows or any(len(r) != L for r in context_rows):
        raise ValueError(f"the MSA expert needs at least one context row, "
                         f"each of the wild type's length {L}; got "
                         f"{sorted({len(r) for r in context_rows})}")
    params = load(weights_path, allow_random, dtype, name, device)
    R = len(context_rows) + 1
    if R > params["msa_pos_embed"].shape[0] \
            or L + 1 > params["pos_embed"].shape[0]:
        raise ValueError(f"{R} rows of {L + 1} columns exceed the model's "
                         f"position tables")
    heads = CONFIGS[name]["heads"]
    with torch.no_grad():
        toks = torch.from_numpy(tokenize_msa(context_rows)).to(device,
                                                               torch.long)
        ctx = params["embed"][toks] + params["pos_embed"][:L + 1]
        ctx = ctx + params["msa_pos_embed"][1:R, None]
        params = dict(params, ctx=_layer_norm(params["ln_before"], ctx),
                      perm=torch.from_numpy(potts_to_esm_perm()).to(device,
                                                                    dtype))
        wt = torch.from_numpy(codec.seqs_to_onehot([wt_seq])).to(device)
        params["wt_score"] = expert_score(params, wt, heads)
    remat = bool(remat)

    def apply_fn(params, x):
        score = expert_score(params, x, heads, remat)
        with profiling.span("msa.head"):
            score = score - params["wt_score"]
        return profiling.grad_span(score, "msa.bwd.head")

    apply_fn.span = "msa"  # energy.protein_poe's energy.msa, msa.backward
    return params, apply_fn


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def load(weights_path: str | None, allow_random: bool = False,
         dtype=torch.bfloat16, name: str = "msa-1b",
         device="cuda") -> dict:
    """Weights resolution: a native .npz (``training.save_ckpt`` layout of
    the ``name`` architecture, per-leaf validated), a fair-esm msa1b torch
    checkpoint, or (pipeline checks only) a seeded random init."""
    device = utils.resolve_device(device)
    if weights_path is not None:
        if weights_path.endswith(".npz"):
            return load_npz_checkpoint(weights_path, name, dtype, device)
        return load_torch_checkpoint(weights_path, dtype, device)
    if allow_random:
        return init(torch.Generator(device=device).manual_seed(0), dtype,
                    name=name)
    raise FileNotFoundError(
        "No MSA-Transformer weights: pass a fair-esm esm_msa1b_t12_100M "
        "checkpoint path (not downloadable here), a family-trained .npz "
        "(scripts/finetune_msa.py), or allow_random for pipeline tests.")


def load_npz_checkpoint(path: str, name: str, dtype=torch.bfloat16,
                        device="cuda") -> dict:
    """Load a native checkpoint (``training.save_ckpt``'s npz: leaves
    p0..pN in the JAX package's tree order, dict keys sorted) with per-leaf
    shape validation against the ``name`` architecture."""
    device = utils.resolve_device(device)
    z = np.load(path, allow_pickle=False)
    like = _shapes(name)
    shapes = _flatten(like)
    n_stored = len([k for k in z.files if k.startswith("p")])
    if n_stored != len(shapes):
        raise ValueError(
            f"{path}: {n_stored} leaves but MSA-T config '{name}' has "
            f"{len(shapes)} — wrong architecture for this checkpoint")
    leaves = []
    for i, shape in enumerate(shapes):
        a = z[f"p{i}"]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"{path}: leaf p{i} has shape {tuple(a.shape)}, MSA-T "
                f"config '{name}' expects {tuple(shape)}")
        leaves.append(torch.from_numpy(np.asarray(a, np.float32)).to(device))
    return cast_params(_unflatten(like, leaves), dtype)


def load_torch_checkpoint(path: str, dtype=torch.bfloat16,
                          device="cuda") -> dict:
    """Convert a fair-esm msa1b state dict (.pt) to the port's layout: the
    ``encoder.`` and ``sentence_encoder.`` prefixes stripped, every linear
    weight transposed to [in, out], ``msa_position_embedding`` reshaped to
    [-1, 768], the column positions' table without its first two rows (the
    padding row and the one below it, which no column reads), so that
    ``pos_embed[c]`` is column c's as fair-esm reads it. (The JAX package's
    loader keeps all 1,026 rows, so its columns read two rows too low.)"""
    device = utils.resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k.removeprefix("encoder.").removeprefix("sentence_encoder."): v
          for k, v in sd.items()}
    sd = {k: v.float() for k, v in sd.items() if hasattr(v, "numpy")}

    def arr(t, dt):
        return t.contiguous().to(device, dt)

    def lin(prefix):
        return {"w": arr(sd[f"{prefix}.weight"].T, dtype),
                "b": arr(sd[f"{prefix}.bias"], dtype)}

    def ln(prefix):
        return {"g": arr(sd[f"{prefix}.weight"], torch.float32),
                "b": arr(sd[f"{prefix}.bias"], torch.float32)}

    def attn(prefix):
        return {x: lin(f"{prefix}.layer.{x}_proj") for x in ("q", "k", "v")} \
            | {"o": lin(f"{prefix}.layer.out_proj")}

    layers = []
    for i in range(CFG["layers"]):
        p = f"layers.{i}"
        layers.append({
            "row_ln": ln(f"{p}.row_self_attention.layer_norm"),
            "row": attn(f"{p}.row_self_attention"),
            "col_ln": ln(f"{p}.column_self_attention.layer_norm"),
            "col": attn(f"{p}.column_self_attention"),
            "ffn_ln": ln(f"{p}.feed_forward_layer.layer_norm"),
            "fc1": lin(f"{p}.feed_forward_layer.layer.fc1"),
            "fc2": lin(f"{p}.feed_forward_layer.layer.fc2"),
        })
    return {
        "embed": arr(sd["embed_tokens.weight"], dtype),
        # fair-esm's LearnedPositionalEmbedding has max_positions +
        # padding_idx + 1 rows and reads column c at row c + padding_idx +
        # 1 (padding_idx = 1): rows 2.. are the columns 0.. that _trunk reads
        "pos_embed": arr(sd["embed_positions.weight"][PAD_IDX + 1:], dtype),
        "msa_pos_embed": arr(
            sd["msa_position_embedding"].reshape(-1, CFG["dim"]), dtype),
        "layers": layers,
        "ln_before": ln("emb_layer_norm_before"),
        "ln_after": ln("emb_layer_norm_after"),
        "lm_dense": lin("lm_head.dense"),
        "lm_ln": ln("lm_head.layer_norm"),
        "lm_bias": arr(sd["lm_head.bias"], torch.float32),
    }
