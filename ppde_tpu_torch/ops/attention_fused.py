"""Kernels C and C': attention forward and backward for the ESM2 experts
(``csrc/flash_attention.cu``).

Replace the Pallas TPU kernels ``ppde_tpu/ops/attention_pallas.py:
_fwd_call`` and ``_bwd_call`` (``flash_attention`` with its custom VJP). For
q, k, v [Z, T, hd] (Z = batch * heads, q scaled by the caller, no mask),
float32 or bfloat16, all three alike:

    o = cast(softmax(q k^T)) v          scores and softmax in float32 (row
                                        max subtracted), float32 sums

and the gradients dq, dk, dv from dout by the identities of the TPU
backward kernel, which recomputes the weights from q and k (only q, k and v
are saved for the backward pass).

Bound on the H100: the bytes of the thin tensors (4 Z T hd elements forward,
7 backward), and beside them the special function units' rate for the one
exp per score (forward) or two (backward); at T = 1024 the products' operations
(4 Z T^2 hd forward, 10 backward). The [Z, T, T] scores never reach device
memory. In bf16 with T <= 256 the scores live in registers: in the forward
and the dq half a warp holds its 16 score rows against all columns, in the
dk/dv half its 16 keys against 16 queries at a time. Otherwise (float32, or
T > 256) the kernels are key-tiled: a block's 64 rows walk the other
operand 64 rows at a time, in passes (the row max and sum first, then the
weights normalised in float32, cast and multiplied), so T has no upper
limit; in float32 the scores and dout v^T are summed on FMAs, the other
products on the tensor cores as three TF32 products.
Both load 16 bytes at a time from 16-byte aligned tensors, so they take any
T >= 1 and hd a multiple of 8 up to 64 (``HD_MAX``); the wrapper raises
beyond that. No atomics: outputs repeat bit for bit (see the .cu source).

``flash_attention`` and ``flash_attention_bwd`` run the plain versions for
CPU tensors and the kernels for CUDA tensors, in the spans ``kernel.c`` and
``kernel.c_bwd``; the counters of ``profiling`` ``flash_attention_fwd`` and
``flash_attention_bwd`` count kernel launches, ``flash_attention_fwd_kt``
and ``flash_attention_bwd_kt`` those of them by the key-tiled kernels (the
module's ``launches_fwd``, ``launches_bwd``, ``launches_fwd_kt`` and
``launches_bwd_kt`` read them).
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.ops import _build

# launches of kernel C and C' (its two halves count as one), and those of
# them by the key-tiled kernels (the library's choice)
__getattr__ = profiling.counter_attributes(
    {"launches_fwd": "flash_attention_fwd",
     "launches_bwd": "flash_attention_bwd",
     "launches_fwd_kt": "flash_attention_fwd_kt",
     "launches_bwd_kt": "flash_attention_bwd_kt"})
HD_MAX = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C, rounding where the kernel rounds:
    float32 scores and softmax, weights cast to the input type, float32
    sums, output in the input type. Differentiable."""
    s = torch.einsum("zqd,zkd->zqk", q.float(), k.float())
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("zqk,zkd->zqd", w.float(), v.float()).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor):
    """Plain PyTorch version of kernel C': (dq, dk, dv) by the identities of
    the TPU backward kernel with its rounding points (float32 w32 for delta;
    w and ds cast to the input type before the products)."""
    dt = q.dtype
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    w32 = torch.softmax(torch.einsum("zqd,zkd->zqk", qf, kf), dim=-1)
    dw = torch.einsum("zqd,zkd->zqk", df, vf)
    delta = (w32 * dw).sum(-1, keepdim=True)
    ds = (w32 * (dw - delta)).to(dt).float()
    w = w32.to(dt).float()
    dq = torch.einsum("zqk,zkd->zqd", ds, kf).to(dt)
    dk = torch.einsum("zqk,zqd->zkd", ds, qf).to(dt)
    dv = torch.einsum("zqk,zqd->zkd", w, df).to(dt)
    return dq, dk, dv


def _lib():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:  # declare once: ints would cut the pointers
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_key_tiled.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_key_tiled.restype = ctypes.c_int
    return lib


def _check(q, *others):
    """Raise on what the kernels do not take; returns (Z, T, hd)."""
    if q.dim() != 3:
        raise ValueError(f"need [Z, T, hd] tensors, got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.device != q.device:
            raise ValueError("q, k, v (and dout) must lie on the same device")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v (and dout) must share one type, got "
                            f"{q.dtype} and {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"q, k, v (and dout) must share one shape, got "
                             f"{tuple(q.shape)} and {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError("q, k, v (and dout) must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, *others)):
        raise ValueError("q, k, v (and dout) must start on a 16-byte "
                         "boundary (the kernels load 16 bytes at a time)")
    Z, T, hd = q.shape
    if Z < 1 or T < 1 or not 8 <= hd <= HD_MAX or hd % 8:
        raise ValueError(f"kernels C and C' take Z >= 1, T >= 1 and hd a "
                         f"multiple of 8 up to {HD_MAX}; got Z={Z}, T={T}, "
                         f"hd={hd}")
    return Z, T, hd


def _fwd_cuda(q, k, v):
    Z, T, hd = _check(q, k, v)
    lib = _lib()
    with profiling.span("kernel.c"):
        o = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), Z, T,
                hd, _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel C (flash_attention_fwd) launch failed: "
                           f"cudaError {err}")
    profiling.count("flash_attention_fwd")
    profiling.count("flash_attention_fwd_kt",
                    lib.flash_attention_key_tiled(T, _DTYPES[q.dtype]))
    return o


def _bwd_cuda(q, k, v, dout):
    Z, T, hd = _check(q, k, v, dout)
    lib = _lib()
    with profiling.span("kernel.c_bwd"):
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(q),
                      torch.empty_like(q))
        # per query row: max, sum and delta, handed from the dq half to the
        # dk/dv half
        stats = torch.empty((Z, 3, T), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            err = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                Z, T, hd, _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel C' (flash_attention_bwd) launch failed: "
                           f"cudaError {err}")
    profiling.count("flash_attention_bwd")
    profiling.count("flash_attention_bwd_kt",
                    lib.flash_attention_key_tiled(T, _DTYPES[q.dtype]))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel C forward, kernel C' backward; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _fwd_cuda(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        return _bwd_cuda(*ctx.saved_tensors, dout.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over contiguous [Z, T, hd] tensors (scale q before
    the call): kernels C / C' on CUDA, ``attention_plain`` and autograd on
    CPU. On CUDA it takes any T >= 1 and hd a multiple of 8 up to 64, and
    raises beyond."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _FlashAttention.apply(q, k, v)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent dout: kernel C'
    on CUDA, ``attention_bwd_plain`` on CPU."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout)
    return _bwd_cuda(q, k, v, dout)
