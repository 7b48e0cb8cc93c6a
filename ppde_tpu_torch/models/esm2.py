"""ESM2 protein language model: one-hot input, differentiable.

Counterpart of ``ppde_tpu/models/esm2.py`` with the same names and the same
parameter layout: a plain dict of tensors, weights ``[in, out]``,

    {"embed", "layers": [{"attn_ln", "q", "k", "v", "o", "ffn_ln", "fc1",
    "fc2"}], "final_ln", "lm_dense", "lm_ln", "lm_bias"}

(linear leaves ``{"w", "b"}``, layer norms ``{"g", "b"}`` in float32).

  * the ESM2 architecture (rotary attention, pre-LN, tied LM head, eval-mode
    token-dropout rescale) as pure functions over that dict;
  * inputs are FLOAT one-hots [B, T, 33]: the token embedding is a matmul
    ``x @ E``, so the whole score is differentiable with respect to x;
  * the pseudo-log-likelihood scorer used as the unsupervised expert
    (sum_i x_i . log_softmax(logits_i), delta against the wild type), with
    the fixed 20 -> 33 vocabulary permutation;
  * converters from fair-esm state dicts and native npz checkpoints (the
    ``p0..pN`` leaf order of the JAX package's tree, so a file written by
    either package loads in the other), and LoRA adapters (init, merge).

The attention core goes through ``ops/attention_fused.flash_attention``:
kernels C and C' on a CUDA tensor (always: there is no switch and no einsum
path on the card), their plain version on a CPU tensor; the glue between
the q, k, v projections and it (head-major layout, q scale, rotary) through
``ops/rotary_fused.qkv_rotary``, one kernel in each direction on a CUDA
tensor, the plain composition on a CPU tensor; the layer norms likewise
through ``ops/layer_norm_fused.layer_norm``. The projections, the FFN, the
embedding and the LM head are plain matrix products.

Multi-device (``parallel/mesh.py``): parameters from ``shard_esm`` hold the
rank's heads and hidden units (Megatron tensor parallelism over tp: kernels
C and C' run on the rank's heads, the partial products of o and fc2 are
summed over tp), and ``forward_logits(constrain=)`` / ``SP_CONSTRAIN``
splits the residual stream's sequence axis over sp.

Spans (``profiling``): the forward runs in ``esm2.<kind>`` by block kind
(embed, norm, qkv, rotary, attn_out, ffn, head; kernel C in ``kernel.c``);
inside ``profiling.grad_spans()`` the boundary tensors of each kind are
hooked, so that the backward of its work runs in ``esm2.bwd.<kind>``
(kernel C' in ``kernel.c_bwd``, outside the kinds).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ppde_tpu_torch import codec, profiling, utils
from ppde_tpu_torch.ops import attention_fused, layer_norm_fused, rotary_fused
from ppde_tpu_torch.parallel import mesh as pmesh

# Canonical ESM alphabet (fair-esm proteinseq_toks + specials), index order.
ESM_TOKS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
ESM_VOCAB = len(ESM_TOKS)  # 33
ESM_TOK_TO_IDX = {t: i for i, t in enumerate(ESM_TOKS)}
MASK_IDX = ESM_TOK_TO_IDX["<mask>"]
CLS_IDX = ESM_TOK_TO_IDX["<cls>"]
EOS_IDX = ESM_TOK_TO_IDX["<eos>"]
PAD_IDX = ESM_TOK_TO_IDX["<pad>"]

CONFIGS = {
    "transformer-S": dict(layers=12, dim=480, heads=20, ffn=1920),   # 35M
    "transformer-M": dict(layers=30, dim=640, heads=20, ffn=2560),   # 150M
    "transformer": dict(layers=30, dim=640, heads=20, ffn=2560),
    "transformer-L": dict(layers=33, dim=1280, heads=20, ffn=5120),  # 650M
}
# mask_ratio_train for the eval-mode token-dropout rescale (0.15 * 0.8)
MASK_RATIO_TRAIN = 0.15 * 0.8

# Sequence-parallel hook: when set (parallel/mesh.sp_constraint, by
# runtime.apply_mesh(sp=...)), every forward_logits call without an explicit
# ``constrain`` splits the residual stream's T axis over the mesh's sp axis.
# Module-level, as in the JAX package: experts bake their apply_fn closures
# into an Energy at build time, so a hook here reaches them unchanged.
SP_CONSTRAIN = None


def potts_to_esm_perm() -> np.ndarray:
    """[20, 33] permutation mapping our AA one-hots to ESM one-hots."""
    perm = np.zeros((codec.VOCAB_SIZE, ESM_VOCAB), np.float32)
    for k in range(codec.VOCAB_SIZE):
        perm[k, ESM_TOK_TO_IDX[codec.INT_TO_AA[k]]] = 1.0
    return perm


def seq_to_esm_onehot(seq: str, dtype=np.float32) -> np.ndarray:
    """AA string -> [T, 33] one-hot (no cls/eos)."""
    out = np.zeros((len(seq), ESM_VOCAB), dtype)
    for i, c in enumerate(seq):
        out[i, ESM_TOK_TO_IDX.get(c, ESM_TOK_TO_IDX["<unk>"])] = 1.0
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _map_leaves(tree, fn, path=()):
    """Copy of a parameter tree (dicts and lists) with fn(path, leaf) at
    every leaf."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _flatten(tree) -> list:
    """Leaves in the JAX package's tree order: dict keys sorted, lists in
    order (what ``jax.tree.flatten`` gives for the same tree)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(like, leaves: list):
    """The tree ``like`` with its leaves taken from ``leaves`` in
    ``_flatten`` order (consumed from the front)."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return leaves.pop(0)


def _shapes(name: str) -> dict:
    """The parameter tree of config ``name`` with shapes as leaves."""
    cfg = CONFIGS[name]
    D, Fd, N = cfg["dim"], cfg["ffn"], cfg["layers"]

    def lin(i, o):
        return {"w": (i, o), "b": (o,)}

    def ln(d):
        return {"g": (d,), "b": (d,)}

    def layer():
        return {"attn_ln": ln(D), "q": lin(D, D), "k": lin(D, D),
                "v": lin(D, D), "o": lin(D, D), "ffn_ln": ln(D),
                "fc1": lin(D, Fd), "fc2": lin(Fd, D)}

    return {"embed": (ESM_VOCAB, D), "layers": [layer() for _ in range(N)],
            "final_ln": ln(D), "lm_dense": lin(D, D), "lm_ln": ln(D),
            "lm_bias": (ESM_VOCAB,)}


def init(generator: torch.Generator, name: str = "transformer-S",
         dtype=torch.bfloat16, scale: float = 0.02) -> dict:
    """Random parameters on ``generator.device``: normal * scale weights in
    ``dtype``, zero biases, unit layer norms and the LM bias in float32."""
    device = utils.resolve_device(generator.device)
    f32 = torch.float32

    def leaf(path, shape):
        name = path[-1]
        if name == "g":
            return torch.ones(shape, dtype=f32, device=device)
        if name in ("w", "embed"):
            return (torch.randn(shape, generator=generator, device=device)
                    * scale).to(dtype)
        # biases: the layer norms' and the LM head's stay float32
        keep_f32 = name == "lm_bias" or path[-2] in _F32_KEYS
        return torch.zeros(shape, dtype=f32 if keep_f32 else dtype,
                           device=device)

    return _map_leaves(_shapes(name), leaf)


def _layer_norm(p, x, eps=1e-5):
    """Layer norm in float32 (biased variance), rounded once to x's type:
    ``ops/layer_norm_fused``'s kernels on a CUDA tensor, its plain
    composition on a CPU tensor."""
    return layer_norm_fused.layer_norm(x, p["g"], p["b"], eps)


@functools.lru_cache(maxsize=16)
def _rotary_tables(T: int, hd: int, dtype, device):
    """cos and sin [1, 1, T, hd] of the rotary angles, in float32 and then
    cast to ``dtype``; kept, since every layer of every call asks for the
    same tables."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=device) / hd))
    t = torch.arange(T, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                    # [T, hd/2]
    emb = torch.cat([freqs, freqs], -1)            # [T, hd]
    return (torch.cos(emb)[None, None].to(dtype),
            torch.sin(emb)[None, None].to(dtype))


def _rotary(q, k):
    """Rotary position embedding on [B, H, T, hd] query/key tensors."""
    cos, sin = _rotary_tables(q.shape[-2], q.shape[-1], q.dtype, q.device)

    def rot_half(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], -1)

    return q * cos + rot_half(q) * sin, k * cos + rot_half(k) * sin


def _linear(p, x):
    """x @ w + b over the last axis, the bias added in the product's
    epilogue."""
    return torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), p["w"]).reshape(
        *x.shape[:-1], -1)


def _attention(p, h, x, heads, tp=None, gather=None, rows=None):
    """h plus the rotary self-attention of x [B, T, D]. ``tp``: the rank
    holds heads / tp of the heads (q, k, v by columns, o by rows) and the
    partial products of o are summed over tp. ``gather`` / ``rows``
    (sequence parallelism): x, the rank's positions, is gathered to the
    whole sequence before the projections, and the rank keeps its own rows
    of the merged heads' output before the o projection."""
    with profiling.span("esm2.qkv"):
        if gather is not None:
            x = gather(x)
        B, T, D = x.shape
        hd = D // heads
        if tp is not None:
            if heads % tp.size:
                raise ValueError(f"tp={tp.size} does not divide the {heads} "
                                 "attention heads")
            heads //= tp.size
            x = pmesh.copy_to(x, tp)
        q, k, v = (_linear(p[name], x) for name in ("q", "k", "v"))
    q, k, v = (profiling.grad_span(t, "esm2.bwd.qkv") for t in (q, k, v))
    # contiguous [B, heads, T, hd], q scaled, q and k rotated: the merge of
    # (B, heads) below is a view
    with profiling.span("esm2.rotary"):
        cos, sin = _rotary_tables(T, hd, q.dtype, q.device)
        q, k, v = rotary_fused.qkv_rotary(q, k, v, cos, sin, heads,
                                          1.0 / math.sqrt(hd))
    q, k, v = (profiling.grad_span(t, "esm2.bwd.rotary") for t in (q, k, v))
    # (B, heads) merge into one batch dimension Z, in that order; kernel C'
    # runs outside the backward kinds
    out = profiling.grad_span(attention_fused.flash_attention(
        q.reshape(B * heads, T, hd), k.reshape(B * heads, T, hd),
        v.reshape(B * heads, T, hd)), None)
    with profiling.span("esm2.attn_out"):
        out = out.reshape(B, heads, T, hd).permute(0, 2, 1, 3).reshape(
            B, T, heads * hd)
        if rows is not None:
            out = rows(out)
        h = h + _row_linear(p["o"], out, tp)
    return profiling.grad_span(h, "esm2.bwd.attn_out")


def _row_linear(p, x, tp):
    """x @ w + b where ``tp`` holds w by rows and x by columns: the partial
    products summed over tp, the bias added once."""
    if tp is None:
        return _linear(p, x)
    y = pmesh.reduce_from(x.reshape(-1, x.shape[-1]) @ p["w"], tp)
    return (y + p["b"]).reshape(*x.shape[:-1], -1)


def embed_tokens(params, x_onehot: torch.Tensor) -> torch.Tensor:
    """One-hot [B, T, 33] -> embedded residual stream [B, T, D].

    Eval-mode semantics of the one-hot ESM fork: the embedding is x @ E (so
    gradients flow to x); the token-dropout rescale uses the soft mask
    weight x[..., MASK_IDX] (exact for one-hot inputs): zero masked
    embeddings, scale by (1 - mask_ratio_train) / (1 - observed ratio).
    """
    with profiling.span("esm2.embed"):
        dtype = params["embed"].dtype
        x = x_onehot.to(dtype)
        h = x @ params["embed"]
        mask_w = x_onehot[..., MASK_IDX].float()              # [B, T]
        h = h * (1.0 - mask_w[..., None]).to(dtype)
        ratio = mask_w.mean(-1, keepdim=True)                 # [B, 1]
        scale = (1.0 - MASK_RATIO_TRAIN) / (1.0 - ratio)
        h = h * scale[..., None].to(dtype)
    return profiling.grad_span(h, "esm2.bwd.embed")


def _gelu(x, approx_gelu: bool):
    return F.gelu(x, approximate="tanh" if approx_gelu else "none")


def transformer_layer(layer, h, heads: int, approx_gelu: bool, tp=None,
                      sp=None, T: int | None = None):
    """One pre-LN rotary-attention transformer block on [B, T, D].

    ``tp``: Megatron tensor parallelism (``shard_esm``'s layer). ``sp``
    (an ``SPConstraint``): h holds this rank's positions of the padded
    sequence; the layer-normed stream is gathered to the whole sequence of
    length ``T`` for attention, and the rank keeps its own rows."""
    with profiling.span("esm2.norm"):
        y = _layer_norm(layer["attn_ln"], h)
    y = profiling.grad_span(y, "esm2.bwd.norm")
    if sp is None:
        h = _attention(layer, h, y, heads, tp)
    else:
        h = _attention(layer, h, y, heads, tp,
                       functools.partial(sp.gather, T=T), sp.split)
    with profiling.span("esm2.norm"):
        y = _layer_norm(layer["ffn_ln"], h)
    y = profiling.grad_span(y, "esm2.bwd.norm")
    with profiling.span("esm2.ffn"):
        y = _gelu(_linear(layer["fc1"], pmesh.copy_to(y, tp)), approx_gelu)
        h = h + _row_linear(layer["fc2"], y, tp)
    return profiling.grad_span(h, "esm2.bwd.ffn")


def lm_head(params, h: torch.Tensor, approx_gelu: bool) -> torch.Tensor:
    """Residual stream [B, T, D] -> tied-embedding LM logits [B, T, 33],
    in float32 against the float32 copy of ``embed``."""
    with profiling.span("esm2.head"):
        h = _layer_norm(params["final_ln"], h)
        y = _gelu(_linear(params["lm_dense"], h), approx_gelu)
        y = _layer_norm(params["lm_ln"], y)
        logits = y.float() @ params["embed"].float().T
        return logits + params["lm_bias"]


def _use_approx_gelu(params) -> bool:
    # exact erf GELU for float32 params (fair-esm numeric parity); tanh GELU
    # at bf16, where the approximation error is below bf16 resolution
    return params["embed"].dtype == torch.bfloat16


def forward_logits(params, x_onehot: torch.Tensor, heads: int = 20,
                   remat: bool = False, constrain=None) -> torch.Tensor:
    """One-hot [B, T, 33] -> LM logits [B, T, 33] (float32).

    ``heads`` is static: the architecture's config stays out of the
    parameter dict. ``remat``: ``torch.utils.checkpoint`` around every
    layer when autograd records, so that a gradient (with respect to the
    input or to the weights: LoRA adapters leave the embedding frozen)
    keeps only the layers' boundary residuals and recomputes one forward;
    off by default, on for transformer-L in ``load_expert`` and the
    trainers (the memory of its whole-batch gradient).

    ``constrain``: a ``parallel.mesh.SPConstraint`` (default
    ``SP_CONSTRAIN``): sequence parallelism. The embedding (its
    token-dropout statistics over the whole sequence) runs whole; between
    layers each rank holds its part of the sequence padded to a multiple of
    sp; the logits are gathered whole. Parameters from ``shard_esm`` (the
    ``"_tp"`` entry) run the layers tensor-parallel.
    """
    if constrain is None:
        constrain = SP_CONSTRAIN
    sp = constrain if constrain is not None and constrain.axis.size > 1 \
        else None
    tp = params.get("_tp")
    T = x_onehot.shape[1]
    if sp is not None:
        x_onehot = pmesh.copy_to(x_onehot, sp.axis)
    h = embed_tokens(params, x_onehot)
    if sp is not None:
        with profiling.span("esm2.embed"):
            h = sp.split(h)
    approx_gelu = _use_approx_gelu(params)
    remat = remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            h = checkpoint(transformer_layer, layer, h, heads, approx_gelu,
                           tp, sp, T, use_reentrant=False)
        else:
            h = transformer_layer(layer, h, heads, approx_gelu, tp, sp, T)
    logits = lm_head(params, h, approx_gelu)
    if sp is None:
        return logits
    with profiling.span("esm2.head"):
        return sp.gather_keep(logits, T)


def pseudo_log_likelihood(params, x_onehot: torch.Tensor, heads: int = 20,
                          remat: bool = False,
                          constrain=None) -> torch.Tensor:
    """sum_i x_i . log_softmax(logits_i) per sequence."""
    logits = forward_logits(params, x_onehot, heads, remat, constrain)
    with profiling.span("esm2.head"):
        lp = torch.log_softmax(logits, -1)
        return (x_onehot.float() * lp).sum((1, 2))


def load_expert(name: str, wt_seq: str, weights_path: str | None = None,
                allow_random: bool = False, dtype=torch.bfloat16,
                remat: bool | None = None, device="cuda"):
    """Build the unsupervised transformer expert: (params, apply_fn) where
    apply_fn(params, x_potts_onehot [N, L, 20]) -> delta PLL against the
    wild type. ``params`` also holds ``wt_score`` and ``perm``.

    remat: None = auto (per-layer checkpointing for transformer-L only)."""
    device = utils.resolve_device(device)
    if weights_path is not None:
        if weights_path.endswith(".npz"):
            params = load_npz_checkpoint(weights_path, name, dtype, device)
        else:
            params = load_torch_checkpoint(weights_path, name, dtype, device)
    elif allow_random:
        params = init(torch.Generator(device=device).manual_seed(0), name,
                      dtype)
    else:
        raise FileNotFoundError(
            "No ESM2 weights available: pass weights_path pointing at a "
            "fair-esm esm2_t*.pt checkpoint or a native .npz checkpoint, or "
            "allow_random=True for smoke testing.")

    if remat is None:
        remat = name == "transformer-L"
    heads = CONFIGS[name]["heads"]
    perm = torch.from_numpy(potts_to_esm_perm()).to(device, dtype)
    wt = torch.from_numpy(seq_to_esm_onehot(wt_seq))[None].to(device)
    with torch.no_grad():
        wt_score = pseudo_log_likelihood(params, wt, heads)
    params = dict(params, wt_score=wt_score, perm=perm)

    def apply_fn(params, x):
        with profiling.span("esm2.embed"):
            x_esm = x.to(params["perm"].dtype) @ params["perm"]
        score = pseudo_log_likelihood(params, x_esm, heads, remat)
        with profiling.span("esm2.head"):
            score = score - params["wt_score"]
        return profiling.grad_span(score, "esm2.bwd.head")

    return params, apply_fn


# ---------------------------------------------------------------------------
# mixed precision + native checkpoints
# ---------------------------------------------------------------------------

# Keys whose leaves stay float32 under cast_params: the layer norms'
# affines and the LM-head bias, plus expert-time extras.
_F32_KEYS = frozenset(
    {"attn_ln", "ffn_ln", "final_ln", "lm_ln", "lm_bias", "wt_score"})


def cast_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Cast the matmul weights (embed, q/k/v/o, fc1/fc2, lm_dense, perm) to
    ``dtype``, keeping layer norms and the LM-head bias float32: the layout
    ``init`` and ``from_state_dict`` produce directly."""
    def leaf(path, a):
        return a if set(path) & _F32_KEYS else a.to(dtype)

    return _map_leaves(params, leaf)


def save_npz_checkpoint(path: str, params: dict, step: int = 0):
    """Save params as a flattened-tree npz: leaves p0..pN in the JAX
    package's tree order plus ``step``, weights upcast to float32. Stored
    without compression (the JAX package deflates; ``np.load`` reads
    both): float32 weights barely deflate, and deflating transformer-L's
    2.6 GB takes minutes."""
    flat = _flatten(params)
    np.savez(
        path, step=step, treedef="ppde_tpu_torch esm2 tree, sorted keys",
        **{f"p{i}": a.detach().float().cpu().numpy()
           for i, a in enumerate(flat)})


def load_npz_checkpoint(path: str, name: str, dtype=torch.bfloat16,
                        device="cuda") -> dict:
    """Load a native ESM2 checkpoint (``save_npz_checkpoint`` of either
    package) with per-leaf shape validation against the ``name``
    architecture, mapped to the usual mixed layout (weights in ``dtype``,
    layer norms and lm_bias float32)."""
    device = utils.resolve_device(device)
    z = np.load(path, allow_pickle=False)
    like = _shapes(name)
    shapes = _flatten(like)
    n_stored = len([k for k in z.files if k.startswith("p")])
    if n_stored != len(shapes):
        raise ValueError(
            f"{path}: {n_stored} leaves but config '{name}' has "
            f"{len(shapes)}: wrong architecture for this checkpoint")
    leaves = []
    for i, shape in enumerate(shapes):
        a = z[f"p{i}"]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"{path}: leaf p{i} has shape {tuple(a.shape)}, config "
                f"'{name}' expects {tuple(shape)}")
        leaves.append(torch.from_numpy(np.asarray(a, np.float32)).to(device))
    return cast_params(_unflatten(like, leaves), dtype)


# ---------------------------------------------------------------------------
# LoRA adapters (parameter-efficient family fine-tuning)
# ---------------------------------------------------------------------------

# every per-layer matmul is adaptable; embed and lm_dense stay frozen (the
# LM head is tied to embed)
LORA_TARGETS = ("q", "k", "v", "o", "fc1", "fc2")


def lora_init(generator: torch.Generator, name: str, rank: int,
              dtype=torch.float32) -> dict:
    """Zero-delta LoRA adapter tree for config ``name`` on
    ``generator.device``: per layer and target W [i, o], a down-projection
    a [i, r] ~ normal / sqrt(i) and an up-projection b [r, o] of zeros, so
    the merged model equals the base exactly at first."""
    cfg = CONFIGS[name]
    D, Fd = cfg["dim"], cfg["ffn"]
    shapes = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D),
              "fc1": (D, Fd), "fc2": (Fd, D)}
    device = utils.resolve_device(generator.device)

    def one():
        out = {}
        for t in LORA_TARGETS:
            i, o = shapes[t]
            a = torch.randn((i, rank), generator=generator, device=device)
            out[t] = {"a": (a / math.sqrt(i)).to(dtype),
                      "b": torch.zeros((rank, o), dtype=dtype,
                                       device=device)}
        return out

    return {"layers": [one() for _ in range(cfg["layers"])]}


def lora_merge(params: dict, lora: dict, alpha: float = 16.0) -> dict:
    """Merge adapters into a copy of ``params``: W' = W + (alpha/r) a@b,
    accumulated in float32 and cast back to W's type. ``lora`` is
    ``{"layers": [{target: {"a": [i, r], "b": [r, o]}}]}``."""
    merged = dict(params)
    if len(lora["layers"]) != len(params["layers"]):
        raise ValueError(
            f"LoRA tree has {len(lora['layers'])} layers, params have "
            f"{len(params['layers'])}")
    out_layers = []
    for lp, la in zip(params["layers"], lora["layers"]):
        lnew = dict(lp)
        for t in LORA_TARGETS:
            a, b = la[t]["a"], la[t]["b"]
            w = lp[t]["w"]
            if (a.shape[0], b.shape[1]) != tuple(w.shape):
                raise ValueError(
                    f"LoRA target '{t}': adapter {tuple(a.shape)}x"
                    f"{tuple(b.shape)} does not match weight "
                    f"{tuple(w.shape)}")
            scale = alpha / a.shape[1]
            delta = (a.float() @ b.float()) * scale
            lnew[t] = {"w": (w.float() + delta).to(w.dtype), "b": lp[t]["b"]}
        out_layers.append(lnew)
    merged["layers"] = out_layers
    return merged


# ---------------------------------------------------------------------------
# fair-esm checkpoint conversion
# ---------------------------------------------------------------------------

def load_torch_checkpoint(path: str, name: str, dtype=torch.bfloat16,
                          device="cuda") -> dict:
    """Convert a fair-esm ESM2 state_dict (.pt) to the port's layout."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k.removeprefix("encoder.").removeprefix("sentence_encoder."): v
          for k, v in sd.items()}
    sd = {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    return from_state_dict(sd, name, dtype, device)


def from_state_dict(sd: dict, name: str, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """Map fair-esm ESM2 module names (numpy arrays, torch ``[out, in]``
    weights) onto the port's layout."""
    device = utils.resolve_device(device)
    cfg = CONFIGS[name]

    def arr(key, dt, transpose=False):
        a = np.asarray(sd[key], np.float32)
        a = np.ascontiguousarray(a.T if transpose else a)
        return torch.from_numpy(a).to(device, dt)

    def lin(prefix):
        return {"w": arr(f"{prefix}.weight", dtype, transpose=True),
                "b": arr(f"{prefix}.bias", dtype)}

    def ln(prefix):
        return {"g": arr(f"{prefix}.weight", torch.float32),
                "b": arr(f"{prefix}.bias", torch.float32)}

    layers = []
    for i in range(cfg["layers"]):
        p = f"layers.{i}"
        layers.append({
            "attn_ln": ln(f"{p}.self_attn_layer_norm"),
            "q": lin(f"{p}.self_attn.q_proj"),
            "k": lin(f"{p}.self_attn.k_proj"),
            "v": lin(f"{p}.self_attn.v_proj"),
            "o": lin(f"{p}.self_attn.out_proj"),
            "ffn_ln": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        })
    return {
        "embed": arr("embed_tokens.weight", dtype),
        "layers": layers,
        "final_ln": ln("emb_layer_norm_after"),
        "lm_dense": lin("lm_head.dense"),
        "lm_ln": ln("lm_head.layer_norm"),
        "lm_bias": arr("lm_head.bias", torch.float32),
    }
