"""Kernels T and T': the MSA Transformer's tied row attention, forward and
backward (``csrc/row_attention.cu``).

Replace no Pallas TPU kernel: the JAX package writes tied row attention as
two einsums (``ppde_tpu/models/msa_transformer.py``), which XLA lays out
itself; the port's plain composition (``models/msa_transformer.py::
_tied_row_attention``) copies q, k and v into [B, H, C, R * hd]. For q, k, v
[N, R, C, H, hd] (row r, column c, head h of alignment n: the projections'
own layout, contiguous), float32 or bfloat16, all three alike, and a scale:

    s = scale sum_r q_r k_r^T            [N, H, C, C], float32 sums
    o_r = cast(softmax(s)) v_r           float32 softmax and sums, o in the
                                         input type

and the gradients dq, dk, dv from dout, w = cast(softmax(s)) recomputed from
q and k (only q, k and v are saved for the backward pass):

    dw = sum_r dout_r v_r^T,  delta = rowsum(w dw),  ds = cast(w (dw - delta))
    dq_r = cast(scale ds k_r),  dk_r = cast(scale ds^T q_r),
    dv_r = cast(w^T dout_r)

Bound on the H100: the bytes, each of q, k, v and o (backward q, k, v, dout
and dq, dk, dv) once: 4 N R C H hd elements forward, 7 backward; the
products are 4 N H C^2 R hd operations forward, 10 backward. The kernels
read and write the tensors where they lie; bf16 with C <= 256 and hd a
multiple of 16 holds the scores in registers, every other call (float32, C
up to 2,048) runs SIMT kernels over a float32 scratch (see the .cu source).
The kernels take hd a multiple of 8 up to 64 (``HD_MAX``), C up to 2,048
(``C_MAX``), N H up to 65,535 and a scratch (the SIMT kernels' float32
scores, N H C^2 elements forward, twice that backward) of at most
``SCRATCH_MAX`` bytes; the wrapper raises beyond that.

``tied_row_attention`` and ``tied_row_attention_bwd`` run the plain versions
for CPU tensors and the kernels for CUDA tensors, in the spans ``kernel.t``
and ``kernel.t_bwd``; the counters of ``profiling`` ``row_attention_fwd``
and ``row_attention_bwd`` count the calls, one each way whatever kernels
the call runs (the module's ``launches_fwd`` and ``launches_bwd`` read
them).
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.ops import _build

__getattr__ = profiling.counter_attributes(
    {"launches_fwd": "row_attention_fwd", "launches_bwd": "row_attention_bwd"})
HD_MAX = 64
C_MAX = 2048
SCRATCH_MAX = 8 << 30  # bytes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_EQ = "nrchd,nrehd->nhce"  # sum over rows and the head's dims


def tied_row_attention_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel T, rounding where the kernel rounds:
    float32 scores and softmax, weights cast to the input type, float32
    sums, output in the input type. Differentiable."""
    s = torch.einsum(_EQ, q.float(), k.float()) * scale
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("nhce,nrehd->nrchd", w.float(), v.float()).to(q.dtype)


def tied_row_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor,
                                 scale: float):
    """Plain PyTorch version of kernel T': (dq, dk, dv) with its rounding
    points (w cast to the input type before delta and ds, ds cast before the
    products)."""
    dt = q.dtype
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    w = torch.softmax(torch.einsum(_EQ, qf, kf) * scale, -1).to(dt).float()
    dw = torch.einsum(_EQ, df, vf)
    delta = (w * dw).sum(-1, keepdim=True)
    ds = (w * (dw - delta)).to(dt).float()
    dq = (torch.einsum("nhce,nrehd->nrchd", ds, kf) * scale).to(dt)
    dk = (torch.einsum("nhce,nrchd->nrehd", ds, qf) * scale).to(dt)
    dv = torch.einsum("nhce,nrchd->nrehd", w, df).to(dt)
    return dq, dk, dv


def _lib():
    lib = _build.library("row_attention")
    if lib.row_attention_fwd.argtypes is None:  # ints would cut pointers
        lib.row_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.row_attention_fwd.restype = ctypes.c_int
        lib.row_attention_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.row_attention_bwd.restype = ctypes.c_int
        lib.row_attention_scratch_bytes.argtypes = [ctypes.c_int] * 6
        lib.row_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, *others):
    """Raise on what the kernels do not take; returns (N, R, C, H, hd)."""
    if q.dim() != 5:
        raise ValueError(f"need [N, R, C, H, hd] tensors, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"row attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
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
    N, R, C, H, hd = q.shape
    if (min(N, R, C, H) < 1 or C > C_MAX or N * H > 65535
            or not 8 <= hd <= HD_MAX or hd % 8):
        raise ValueError(f"kernels T and T' take N, R, H >= 1, 1 <= C <= "
                         f"{C_MAX}, N H <= 65535 and hd a multiple of 8 up "
                         f"to {HD_MAX}; got {tuple(q.shape)}")
    return N, R, C, H, hd


def _scratch(lib, shape, dtype, device, backward):
    N, _, C, H, hd = shape
    n = lib.row_attention_scratch_bytes(N, C, H, hd, _DTYPES[dtype],
                                        int(backward))
    if n > SCRATCH_MAX:
        kernel = "T'" if backward else "T"
        raise ValueError(f"kernel {kernel} at {tuple(shape)} {dtype} needs "
                         f"{n} bytes of scratch, more than SCRATCH_MAX = "
                         f"{SCRATCH_MAX}: call it on fewer alignments at a "
                         f"time")
    return torch.empty(max(n, 16), dtype=torch.uint8, device=device)


def _fwd_cuda(q, k, v, scale):
    shape = N, R, C, H, hd = _check(q, k, v)
    lib = _lib()
    with profiling.span("kernel.t"):
        o = torch.empty_like(q)
        scratch = _scratch(lib, shape, q.dtype, q.device, False)
        with torch.cuda.device(q.device):
            err = lib.row_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                scratch.data_ptr(), N, R, C, H, hd, scale, _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel T (row_attention_fwd) launch failed: "
                           f"cudaError {err}")
    profiling.count("row_attention_fwd")
    return o


def _bwd_cuda(q, k, v, dout, scale):
    shape = N, R, C, H, hd = _check(q, k, v, dout)
    lib = _lib()
    with profiling.span("kernel.t_bwd"):
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(q),
                      torch.empty_like(q))
        scratch = _scratch(lib, shape, q.dtype, q.device, True)
        with torch.cuda.device(q.device):
            err = lib.row_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                scratch.data_ptr(), N, R, C, H, hd, scale, _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel T' (row_attention_bwd) launch failed: "
                           f"cudaError {err}")
    profiling.count("row_attention_bwd")
    return dq, dk, dv


class _RowAttention(torch.autograd.Function):
    """Kernel T forward, kernel T' backward; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _fwd_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        return (*_bwd_cuda(*ctx.saved_tensors, dout.contiguous(), ctx.scale),
                None)


def tied_row_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Tied row attention of contiguous [N, R, C, H, hd] tensors: kernels T
    / T' on CUDA, ``tied_row_attention_plain`` and autograd on CPU."""
    if q.device.type == "cpu":
        return tied_row_attention_plain(q, k, v, scale)
    return _RowAttention.apply(q, k, v, scale)


def tied_row_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           scale: float):
    """(dq, dk, dv) of ``tied_row_attention`` for the cotangent dout: kernel
    T' on CUDA, ``tied_row_attention_bwd_plain`` on CPU."""
    if q.device.type == "cpu":
        return tied_row_attention_bwd_plain(q, k, v, dout, scale)
    return _bwd_cuda(q, k, v, dout, scale)
