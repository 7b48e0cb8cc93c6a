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

Every product is a plain PyTorch matrix product: the JAX module reaches no
Pallas kernel. Weights come from a native ``.npz`` (``training.save_ckpt``'s
layout), a fair-esm msa1b ``.pt``, or (pipeline checks only) a seeded random
init.

``masked_marginals`` scores each masked wild-type column with one forward;
a batch of columns is one forward of ``batch_cols`` alignments, and the LM
head runs only at the masked position it reads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ppde_tpu_torch import utils
from ppde_tpu_torch.models.esm2 import (CLS_IDX, ESM_TOK_TO_IDX, ESM_VOCAB,
                                        MASK_IDX, PAD_IDX, _flatten,
                                        _layer_norm, _linear, _map_leaves,
                                        _unflatten)

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
    [-1, 768]."""
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
        "pos_embed": arr(sd["embed_positions.weight"], dtype),
        "msa_pos_embed": arr(
            sd["msa_position_embedding"].reshape(-1, CFG["dim"]), dtype),
        "layers": layers,
        "ln_before": ln("emb_layer_norm_before"),
        "ln_after": ln("emb_layer_norm_after"),
        "lm_dense": lin("lm_head.dense"),
        "lm_ln": ln("lm_head.layer_norm"),
        "lm_bias": arr(sd["lm_head.bias"], torch.float32),
    }
