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
7 backward); the [Z, T, T] scores never reach device memory. The kernels
keep 64 rows of scores against all T columns in shared memory and load 16
bytes at a time, so they take 1 <= T <= 512 (``T_MAX``) and hd a multiple of
8 up to 64 (``HD_MAX``); the wrapper raises beyond that. No atomics: outputs
repeat bit for bit (see the .cu source).

``flash_attention`` and ``flash_attention_bwd`` run the plain versions for
CPU tensors and the kernels for CUDA tensors; ``launches_fwd`` and
``launches_bwd`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch.ops import _build

launches_fwd = 0  # launches of kernel C
launches_bwd = 0  # launches of kernel C' (its two halves count as one)
T_MAX = 512
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
    Z, T, hd = q.shape
    if Z < 1 or not 1 <= T <= T_MAX or not 8 <= hd <= HD_MAX or hd % 8:
        raise ValueError(f"kernels C and C' take Z >= 1, 1 <= T <= {T_MAX} "
                         f"and hd a multiple of 8 up to {HD_MAX}; got Z={Z}, "
                         f"T={T}, hd={hd}")
    return Z, T, hd


def _fwd_cuda(q, k, v):
    global launches_fwd
    Z, T, hd = _check(q, k, v)
    lib = _lib()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), Z, T, hd,
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel C (flash_attention_fwd) launch failed: "
                           f"cudaError {err}")
    launches_fwd += 1
    return o


def _bwd_cuda(q, k, v, dout):
    global launches_bwd
    Z, T, hd = _check(q, k, v, dout)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
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
    launches_bwd += 1
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
    CPU. On CUDA it takes 1 <= T <= 512 and hd a multiple of 8 up to 64, and
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
