"""Kernel B: fused OnehotCNN-ensemble fitness + input gradient
(``csrc/cnn_ensemble.cu``).

Replaces the Pallas TPU kernel ``ppde_tpu/ops/cnn_pallas.py:
ensemble_fit_and_patch_grad`` (wrapper ``ensemble_apply_and_grad``, with the
im2col/col2im it does in XLA; the member-grid twin
``ensemble_fit_and_patch_grad_m`` has the same contract). It computes, for
one-hot x [B, L, V] and a stacked ensemble of M members,

    fit = mean_m dec(max_T relu(emb(relu(conv1d(x)))))        [B]
    dx  = d sum(fit) / dx                                      [B, L, V]

Bound on the H100: the operations of the embed product (GFP B = 1024:
2*B*M*T*C*2C = 0.16 TFLOP, about 0.17 ms at the bf16 tensor-core peak and
2.4 ms at the float32 FMA peak); the bytes are small. Both kernels follow
the member-grid twin's schedule: a persistent block per SM stays on one
member and walks samples; the member's weights, laid out once by
``prepare_ensemble``, stream through a ring of shared-memory slots
(cp.async.bulk + mbarriers); the conv is a gather-add of enc_w rows, the
max-pool's maxima and routed rows are taken from the accumulators, and the
routed rows of emb_w^T are gathered with the loads of four rows in flight.
bf16 (the sampler's ``--compute_dtype bf16``) runs the embed product and dP
on wgmma with H1 / G1 as the shared-memory operand; float32 (the CLI's
default) runs them on FMAs from 8 x 8 register tiles, rows in blocks of 128,
and keeps a bitmask of H1 > 0 for the backward pass (see the .cu source).

Shapes that neither takes (T = L-K+1 > 256, C > 256, 2C > 512, or bf16's
L*V > 5248 and L > 320: wild types longer than 256 residues, whose
reference-width CNN has C = L) go to the wide kernels, in either type
(namespace wide): a forward kernel per (sample, column tile, member) walks
the sample's rows in tiles of 128, rebuilding H1 from the conv chunk by
chunk of depth and streaming the member's emb_w column tile from L2 through
a ring of cp.async.bulk stages; it folds each tile's column maxima, counts
and first rows in row order and keeps the rows at a tile's maximum as four
words of bits a channel. bf16 runs the embed product on wgmma (column tiles
of 256 or 200, the conv a tensor-core product too, H1 in the swizzled
layout wgmma reads); float32 on FMAs from 8 x 8 register tiles (tiles of
128 x 256). A backward kernel per (sample,
member) lists each row's routed channels, gathers G1 from the rows of
emb_w^T under the conv's relu mask and runs dP = G1 enc_w^T (bf16 on
wgmma, float32 on FMAs) and col2im tile by tile. No length or channel
limit: only K*V > 128 raises.

Weights are prepared once: ``prepare_ensemble(stacked, dtype)`` returns a
``Prepared`` that ``ensemble_apply_and_grad`` takes in place of the stacked
layout (``energy.protein_poe`` keeps one per energy); handing in the stacked
layout prepares on every call. Which kernel runs is the library's choice
(``cnn_kernel_for``, by shape and type); each kernel's layout is made at
its first call and kept on the ``Prepared``.

The plain version is ``models.cnn.ensemble_apply_and_grad_plain``.
``ensemble_apply_and_grad`` runs it for a CPU tensor and the kernel for a
CUDA tensor, in the span ``kernel.b``; the counters of ``profiling``
``cnn_ensemble`` (kernel launches), ``cnn_ensemble_f32`` (those in
float32), ``cnn_ensemble_wide`` and ``cnn_ensemble_wide_f32`` (those by the
wide kernels) count them, also read as the module's ``launches``,
``launches_f32``, ``launches_wide`` and ``launches_wide_f32``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.models.cnn import ensemble_apply_and_grad_plain
from ppde_tpu_torch.ops import _build

__all__ = ["ensemble_apply_and_grad", "ensemble_apply_and_grad_plain",
           "prepare_ensemble", "Prepared"]

__getattr__ = profiling.counter_attributes(
    {"launches": "cnn_ensemble", "launches_f32": "cnn_ensemble_f32",
     "launches_wide": "cnn_ensemble_wide",
     "launches_wide_f32": "cnn_ensemble_wide_f32"})
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel's tiles (csrc/cnn_ensemble.cu, namespace tc)
TILE_K = 64      # depth of a weight tile: 128-byte rows
MAX_C = 256      # conv channels: 4 tiles deep
CHUNK = 96       # embed columns per chunk
KV_PAD = 104     # K*V padded
# the float32 kernel's layout (namespace simt)
F32_CHUNK = 128  # columns of a product: an embed chunk; dP (K*V padded)
F32_DEPTH = 16   # depth of a weight stage: C is padded to a multiple
# the wide kernels' layout (namespace wide): rows in tiles of WIDE_ROWS, C
# padded to WIDE_DEPTH[type], C2 to a multiple of the column tile
# (``wide_cols``); K*V at most WIDE_KV (enc_w padded to it)
WIDE_ROWS, WIDE_KV = 128, 128
WIDE_DEPTH = {torch.float32: 16, torch.bfloat16: TILE_K}
WIDE_COLS_F32, WIDE_COLS_BF16 = 256, (256, 200)


# the kernels, as the library's cnn_kernel_for names them
SIMT, TC, WIDE = 0, 1, 2


@dataclasses.dataclass
class Prepared:
    """An ensemble cast once for kernel B, each kernel's layout made at its
    first call and kept.

    ``stacked`` is the plain layout it was made from (the CPU path and the
    plain version use it); ``tensors`` the decoder in the compute type;
    ``layouts`` the layouts made so far, by kernel (``SIMT``, ``TC``,
    ``WIDE``)."""

    stacked: dict
    dtype: torch.dtype
    dims: tuple  # (M, K, V, C, C2)
    tensors: dict
    layouts: dict = dataclasses.field(default_factory=dict)

    def layout(self, kind: int) -> dict:
        """The tensors kernel ``kind`` reads (made at the first call)."""
        if kind not in self.layouts:
            self.layouts[kind] = {**self.tensors, **_LAYOUTS[kind](
                self.stacked, self.dtype)}
        return self.layouts[kind]


def swizzle_tiles(wt: torch.Tensor) -> torch.Tensor:
    """[..., N, 256] (k contiguous) -> [..., 4, N, 64]: four tiles of
    128-byte rows whose 16-byte chunks are XORed with the row's low three
    bits, the layout wgmma reads from shared memory (128-byte swizzle). The
    kernel copies a tile as it lies."""
    if wt.shape[-1] != MAX_C:
        raise ValueError(f"expected a depth of {MAX_C}, got {wt.shape[-1]}")
    return _swizzle(wt)


def _swizzle(wt: torch.Tensor) -> torch.Tensor:
    """``swizzle_tiles`` at any depth D that is a multiple of 64: [..., N,
    D] -> [..., D / 64, N, 64]."""
    *lead, N, kd = wt.shape
    t = wt.reshape(*lead, N, kd // TILE_K, 8, 8).transpose(-4, -3)
    rows = torch.arange(N, device=wt.device)
    idx = torch.arange(8, device=wt.device)[None, :] ^ (rows[:, None] & 7)
    idx = idx[:, :, None].expand(N, 8, 8).expand(t.shape)
    return torch.gather(t, -2, idx).reshape(
        *lead, kd // TILE_K, N, TILE_K).contiguous()


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(
        t, (0, cols - t.shape[-1], 0, rows - t.shape[-2]))


def prepare_ensemble(stacked, compute_dtype=None) -> Prepared:
    """Cast a stacked ensemble (the layout of ``models.cnn.init_ensemble``)
    once, for many calls of ``ensemble_apply_and_grad``; the kernels'
    layouts are made at their first calls."""
    cdt = compute_dtype or torch.float32
    if cdt not in _DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16: {cdt}")
    M, K, V, C = stacked["encoder"]["w"].shape
    C2 = stacked["embed"]["w"].shape[-1]
    dec = stacked["decoder"]
    t = {"decw": dec["w"].to(cdt).reshape(M, C2).contiguous(),
         "decb": dec["b"].to(torch.float32).reshape(M).contiguous()}
    return Prepared(stacked, cdt, (M, K, V, C, C2), t)


def simt_layout(stacked, compute_dtype=torch.float32) -> dict:
    """The float32 kernel's tensors, C padded to F32_DEPTH: enc_w's rows
    [j][c], its transpose [c][j] (F32_CHUNK columns), emb_w in column
    chunks [ch][c][c2], emb_w^T's rows [c2][c] and the biases."""
    enc, emb = stacked["encoder"], stacked["embed"]
    M, K, V, C = enc["w"].shape
    C2 = emb["w"].shape[-1]
    f32 = torch.float32
    encw = enc["w"].reshape(M, K * V, C).to(f32)
    Cp = -(-C // F32_DEPTH) * F32_DEPTH
    n_chunk = -(-C2 // F32_CHUNK)
    return {
        # rows of enc_w [j][c] (the conv's gather)
        "encw": _pad_to(encw, K * V, Cp).contiguous(),
        # B operand of dP = G1 @ enc_w^T: [c][j]
        "encT": _pad_to(encw.transpose(1, 2), Cp, F32_CHUNK).contiguous(),
        # B operand of H2 = H1 @ emb_w, chunk by chunk: [ch][c][c2]
        "emb": _pad_to(emb["w"].to(f32), Cp, n_chunk * F32_CHUNK).reshape(
            M, Cp, n_chunk, F32_CHUNK).transpose(1, 2).contiguous(),
        # rows of emb_w^T [c2][c] (the gather of G1)
        "embwT": _pad_to(emb["w"].to(f32).transpose(1, 2), C2,
                         Cp).contiguous(),
        "encb": _pad_to(enc["b"].to(f32).reshape(M, 1, C), 1,
                        Cp).reshape(M, Cp).contiguous(),
        "embb": _pad_to(emb["b"].to(f32).reshape(M, 1, C2), 1,
                        n_chunk * F32_CHUNK).reshape(M, -1).contiguous()}


def tc_layout(stacked, compute_dtype=torch.bfloat16) -> dict:
    """The bf16 kernel's tensors: enc_w and emb_w^T as swizzled tiles of
    depth MAX_C (emb_w^T in chunks of CHUNK rows), emb_w^T's rows [c2][c]
    and the float32 biases."""
    enc, emb = stacked["encoder"], stacked["embed"]
    M, K, V, C = enc["w"].shape
    C2 = emb["w"].shape[-1]
    f32 = torch.float32
    encw = enc["w"].reshape(M, K * V, C).to(torch.bfloat16)
    embwT = emb["w"].to(torch.bfloat16).transpose(1, 2)    # [M, C2, C]
    n_chunk = -(-C2 // CHUNK)
    return {
        # B operand of dP = G1 @ enc_w^T and the conv's rows: [j][c]
        "enc_blob": swizzle_tiles(_pad_to(encw, KV_PAD, MAX_C)),
        # B operand of H2 = H1 @ emb_w, chunk by chunk: [c2][c]
        "emb_blob": swizzle_tiles(
            _pad_to(embwT, n_chunk * CHUNK, MAX_C).reshape(
                M, n_chunk, CHUNK, MAX_C)),
        "embwT": _pad_to(embwT, C2, MAX_C).contiguous(),
        "encb": _pad_to(enc["b"].to(f32).reshape(M, 1, C), 1,
                        MAX_C).reshape(M, MAX_C).contiguous(),
        "embb": _pad_to(emb["b"].to(f32).reshape(M, 1, C2), 1,
                        n_chunk * CHUNK).reshape(M, -1).contiguous()}


def wide_cols(C2: int, compute_dtype) -> int:
    """The wide kernels' column tile for C2 embed channels: float32 256;
    bf16 a wgmma n of 256 or 200, whichever pads C2 less (ties: 256)."""
    if compute_dtype != torch.bfloat16:
        return WIDE_COLS_F32
    return min(WIDE_COLS_BF16, key=lambda n: -(-C2 // n) * n)


def wide_layout(stacked, compute_dtype) -> dict:
    """The wide kernels' tensors, C padded to Cp = WIDE_DEPTH[type], C2 to
    ncol column tiles of N = ``wide_cols``, zero-padded. bf16: enc_w [j][c]
    (j padded to WIDE_KV) and emb_w^T [c2][c] as swizzled tiles of depth 64
    ("enc" [M, Cp/64, 128, 64], "emb" [M, ncol, Cp/64, N, 64]), emb_w^T's
    rows "embwT" [M, C2, Cp] in bf16. float32: enc_w in stages of 16
    channels ("enc" [M, Cp/16, K*V, 16]), its transpose "encT" [M, Cp,
    WIDE_KV] (dP), emb_w in column tiles ("emb" [M, ncol, Cp, 256]),
    "embwT" [M, C2, Cp]. Both: the float32 biases ("encb" [M, Cp], "embb"
    [M, ncol * N]) and the decoder in float32 of the type's values."""
    enc, emb, dec = stacked["encoder"], stacked["embed"], stacked["decoder"]
    M, K, V, C = enc["w"].shape
    C2 = emb["w"].shape[-1]
    f32, KV = torch.float32, K * V
    depth, N = WIDE_DEPTH[compute_dtype], wide_cols(C2, compute_dtype)
    Cp, ncol = -(-C // depth) * depth, -(-C2 // N)
    encw = enc["w"].reshape(M, KV, C).to(compute_dtype)
    embw = emb["w"].to(compute_dtype)
    embwT = _pad_to(embw.transpose(1, 2), C2, Cp).contiguous()
    out = {
        "embwT": embwT,
        "encb": _pad_to(enc["b"].to(f32).reshape(M, 1, C), 1,
                        Cp).reshape(M, Cp).contiguous(),
        "embb": _pad_to(emb["b"].to(f32).reshape(M, 1, C2), 1,
                        ncol * N).reshape(M, ncol * N).contiguous(),
        "decw": dec["w"].to(compute_dtype).to(f32).reshape(M, C2)
        .contiguous(),
        "decb": dec["b"].to(f32).reshape(M).contiguous()}
    if compute_dtype == torch.bfloat16:
        out["enc"] = _swizzle(_pad_to(encw, WIDE_KV, Cp))
        out["emb"] = _swizzle(_pad_to(embwT, ncol * N, Cp).reshape(
            M, ncol, N, Cp))
    else:
        out["enc"] = _pad_to(encw, KV, Cp).reshape(
            M, KV, Cp // depth, depth).transpose(1, 2).contiguous()
        out["encT"] = _pad_to(encw.transpose(1, 2), Cp, WIDE_KV).contiguous()
        out["emb"] = _pad_to(embw, Cp, ncol * N).reshape(
            M, Cp, ncol, N).transpose(1, 2).contiguous()
    return out


_LAYOUTS = {SIMT: simt_layout, TC: tc_layout, WIDE: wide_layout}


def _lib():
    lib = _build.library("cnn_ensemble")
    fn = lib.cnn_ensemble_fit_and_grad
    if fn.argtypes is None:  # declare once: ints would cut the pointers
        for f, n_ptr, n_int in (
                (fn, 13, 8), (lib.cnn_ensemble_fit_and_grad_bf16, 12, 8),
                (lib.cnn_ensemble_fit_and_grad_wide, 16, 10)):
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
                + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.cnn_smem_bytes.argtypes = [ctypes.c_int]
        lib.cnn_smem_bytes.restype = ctypes.c_long
        for name, n_int in (("cnn_kernel_for", 6), ("cnn_wide_depth", 1),
                            ("cnn_wide_cols", 2)):
            getattr(lib, name).argtypes = [ctypes.c_int] * n_int
            getattr(lib, name).restype = ctypes.c_int
        for name in ("cnn_max_kv", "cnn_f32_depth", "cnn_bf16_chunk",
                     "cnn_wide_rows", "cnn_wide_max_kv"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
    return lib


def ensemble_apply_and_grad(stacked, x: torch.Tensor, compute_dtype=None,
                            pool_bwd: str = "split"):
    """(fitness [B], d sum(fitness) / dx [B, L, V]), both float32.

    stacked: the ensemble layout of ``models.cnn.init_ensemble``
    (encoder.w [M,K,V,C], embed.w [M,C,2C], decoder.w [M,2C,1], ...), or the
    ``Prepared`` that ``prepare_ensemble`` made of it (then compute_dtype,
    if given, must be the prepared one).
    compute_dtype: None (float32) or torch.bfloat16.
    """
    prep = stacked if isinstance(stacked, Prepared) else None
    if prep is not None:
        if compute_dtype is not None and compute_dtype != prep.dtype:
            raise TypeError(f"prepared for {prep.dtype}, asked for "
                            f"{compute_dtype}")
        compute_dtype = prep.dtype
    if x.device.type == "cpu":
        return ensemble_apply_and_grad_plain(
            prep.stacked if prep is not None else stacked, x, compute_dtype,
            pool_bwd)
    if pool_bwd not in ("split", "first"):
        raise ValueError(f"pool_bwd must be 'split' or 'first': {pool_bwd}")
    if prep is None:
        prep = prepare_ensemble(stacked, compute_dtype)
    cdt = prep.dtype
    M, K, V, C, C2 = prep.dims
    B, L, Vx = x.shape
    if Vx != V or L < K:
        raise ValueError(f"x {tuple(x.shape)} does not fit an encoder of "
                         f"K={K}, V={V}")
    if prep.tensors["decw"].device != x.device:
        raise ValueError("x and the ensemble must lie on the same device")
    lib = _lib()
    kind = lib.cnn_kernel_for(L, V, K, C, C2, _DTYPES[cdt])
    if kind < 0:
        raise ValueError(f"kernel B takes K*V <= {lib.cnn_wide_max_kv()}; "
                         f"got K={K}, V={V}")
    dt = _DTYPES[cdt]
    if ((lib.cnn_max_kv(), lib.cnn_f32_depth(), lib.cnn_bf16_chunk(),
         lib.cnn_wide_rows(), lib.cnn_wide_max_kv(), lib.cnn_wide_depth(dt),
         lib.cnn_wide_cols(C2, dt))
            != (F32_CHUNK, F32_DEPTH, CHUNK, WIDE_ROWS, WIDE_KV,
                WIDE_DEPTH[cdt], wide_cols(C2, cdt))):
        raise RuntimeError("kernel B's library and cnn_fused.py disagree on "
                           "the weight layouts")
    with profiling.span("kernel.b"):
        f32 = torch.float32
        dev = x.device
        pred = torch.empty((M, B), dtype=f32, device=dev)
        dxm = torch.empty((M, B, L * V), dtype=f32, device=dev)
        fit = torch.empty((B,), dtype=f32, device=dev)
        dx = torch.empty((B, L, V), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        w = prep.layout(kind)
        if kind == WIDE:
            n_rt = -(-(L - K + 1) // WIDE_ROWS)
            xc = x.to(cdt).to(f32).contiguous()
            tok = torch.empty((B, L, 2), dtype=torch.int32, device=dev)
            stat = torch.empty((M, B, 3, C2), dtype=f32, device=dev)
            marks = torch.empty((M, B, n_rt, C2, 4), dtype=torch.int32,
                                device=dev)
            with torch.cuda.device(dev):
                err = lib.cnn_ensemble_fit_and_grad_wide(
                    xc.data_ptr(), tok.data_ptr(),
                    *(w[k].data_ptr() for k in (
                        "enc", "encT" if "encT" in w else "enc", "emb",
                        "embwT", "encb", "embb", "decw", "decb")),
                    pred.data_ptr(), dxm.data_ptr(), stat.data_ptr(),
                    marks.data_ptr(), fit.data_ptr(), dx.data_ptr(), B, L,
                    V, K, C, C2, M, int(pool_bwd == "first"),
                    int(cdt == torch.bfloat16), wide_cols(C2, cdt), stream)
        else:
            smem = lib.cnn_smem_bytes(_DTYPES[cdt])
            if smem > SMEM_LIMIT:
                raise ValueError(f"kernel B needs {smem} bytes of shared "
                                 f"memory (limit {SMEM_LIMIT})")
            xc = x.to(cdt).contiguous()
            if kind == SIMT:
                fn, names = lib.cnn_ensemble_fit_and_grad, (
                    "encw", "encT", "emb", "embwT", "encb", "embb")
            else:
                fn, names = lib.cnn_ensemble_fit_and_grad_bf16, (
                    "enc_blob", "emb_blob", "embwT", "encb", "embb")
            with torch.cuda.device(dev):
                err = fn(xc.data_ptr(), *(w[k].data_ptr() for k in names),
                         w["decw"].data_ptr(), w["decb"].data_ptr(),
                         pred.data_ptr(), dxm.data_ptr(), fit.data_ptr(),
                         dx.data_ptr(), B, L, V, K, C, C2, M,
                         int(pool_bwd == "first"), stream)
        if err:
            raise RuntimeError(f"kernel B (cnn_ensemble) launch failed: "
                               f"cudaError {err}")
        is_f32, is_wide = int(cdt == torch.float32), int(kind == WIDE)
        profiling.count("cnn_ensemble")
        profiling.count("cnn_ensemble_f32", is_f32)
        profiling.count("cnn_ensemble_wide", is_wide)
        profiling.count("cnn_ensemble_wide_f32", is_wide * is_f32)
    return fit, dx
