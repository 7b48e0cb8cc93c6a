"""The glue between ESM2's q, k, v projections and kernel C, forward and
backward: the q scale, the rotary position embedding and the head-major
layout in one kernel (``csrc/qkv_rotary.cu``).

Replaces no Pallas TPU kernel: the JAX package writes this glue in plain
``jnp`` (``ppde_tpu/models/esm2.py``), which XLA fuses. In PyTorch's eager ops
it was 14 kernels a layer in each direction (three head-major copies, the q
scale, rotary's chunk, neg, cat, products and sums), which moved about 4.7
times the bytes the function needs. For the projections' outputs q, k, v
[B, T, heads * hd] (contiguous), the rotary tables cos, sin
(``models/esm2.py::_rotary_tables``, [1, 1, T, hd]) and the scale s:

    q' = rotary(q s),  k' = rotary(k),  v' = v      each [B, heads, T, hd]

contiguous, so that kernel C reads them as [B * heads, T, hd], with the
rounding points of the PyTorch composition ``qkv_rotary_plain``: the kernel's
outputs and gradients equal that composition's (and autograd's through it)
bit for bit, in float32 and bfloat16. The backward is the transposed pass in
one kernel (un-rotate, scale, back to [B, T, heads * hd]); rotation is
linear, so only the tables are saved for it.

Bound on the H100: the bytes, each input read once and each output written
once (6 B T heads hd elements a direction). The kernels take any B, T >= 1
and hd a multiple of 8 up to 64 (``HD_MAX``), tensors that start on a
16-byte boundary; the wrapper raises beyond that.

``qkv_rotary`` and ``qkv_rotary_bwd`` run the plain versions for CPU tensors
and the kernels for CUDA tensors (no span of their own: ESM2 launches them
inside ``esm2.rotary`` and ``esm2.bwd.rotary``); the counters of
``profiling`` ``qkv_rotary_fwd`` and ``qkv_rotary_bwd`` count the launches
(the module's ``launches_fwd`` and ``launches_bwd`` read them).
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.ops import _build

__getattr__ = profiling.counter_attributes(
    {"launches_fwd": "qkv_rotary_fwd", "launches_bwd": "qkv_rotary_bwd"})
HD_MAX = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def qkv_rotary_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, heads: int,
                     scale: float):
    """Plain PyTorch version, the composition the kernel replaces, op for
    op: each of q, k, v [B, T, heads * hd] copied to a contiguous [B, heads,
    T, hd], q multiplied by ``scale``, q and k rotated. Differentiable."""
    B, T = q.shape[:2]

    def heads_major(t):
        return t.reshape(B, T, heads, -1).permute(0, 2, 1, 3).contiguous()

    q, k, v = heads_major(q) * scale, heads_major(k), heads_major(v)
    return _rotate(q, cos, sin), _rotate(k, cos, sin), v


def qkv_rotary_bwd_plain(gq: torch.Tensor, gk: torch.Tensor,
                         gv: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, scale: float):
    """Plain PyTorch version of the backward: (dq, dk, dv) [B, T, heads *
    hd] of ``qkv_rotary_plain`` for the cotangents [B, heads, T, hd],
    rounding where autograd through it rounds (the rotation's two products,
    their sum, the scale)."""
    def unrotate(g):
        g1, g2 = (g * sin).chunk(2, dim=-1)
        return g * cos + torch.cat([g2, -g1], -1)

    def seq_major(g):
        B, H, T, hd = g.shape
        return g.permute(0, 2, 1, 3).reshape(B, T, H * hd)

    return (seq_major(unrotate(gq) * scale), seq_major(unrotate(gk)),
            seq_major(gv))


def _lib():
    lib = _build.library("qkv_rotary")
    for fn in (lib.qkv_rotary_fwd, lib.qkv_rotary_bwd):
        if fn.argtypes is None:  # declare once: ints would cut the pointers
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(ts, cos, sin, heads):
    """Raise on what the kernels do not take: ``ts`` the three forward
    inputs [B, T, heads * hd] or the three cotangents [B, heads, T, hd];
    returns (B, T, heads, hd)."""
    x = ts[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"qkv_rotary takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in (*ts[1:], cos, sin):
        if t.device != x.device:
            raise ValueError("q, k, v and the tables must lie on the same "
                             "device")
        if t.dtype != x.dtype:
            raise TypeError(f"q, k, v and the tables must share one type, "
                            f"got {x.dtype} and {t.dtype}")
    if any(t.shape != x.shape for t in ts[1:]):
        raise ValueError(f"q, k, v must share one shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in (*ts, cos, sin)):
        raise ValueError("q, k, v and the tables must be contiguous")
    if any(t.data_ptr() % 16 for t in (*ts, cos, sin)):
        raise ValueError("q, k, v and the tables must start on a 16-byte "
                         "boundary (the kernels load 16 bytes at a time)")
    if x.dim() == 3:
        B, T, D = x.shape
        hd = D // heads if heads >= 1 and D % heads == 0 else 0
    elif x.dim() == 4:
        B, H, T, hd = x.shape
        if H != heads:
            raise ValueError(f"cotangents of {H} heads, expected {heads}")
    else:
        raise ValueError(f"need [B, T, heads * hd] inputs or [B, heads, T, "
                         f"hd] cotangents, got {tuple(x.shape)}")
    if B < 1 or T < 1 or not 8 <= hd <= HD_MAX or hd % 8:
        raise ValueError(f"qkv_rotary takes B >= 1, T >= 1 and hd a "
                         f"multiple of 8 up to {HD_MAX}; got B={B}, T={T}, "
                         f"{heads} heads of hd={hd} ({tuple(x.shape)})")
    if cos.shape[-2:] != (T, hd) or cos.numel() != T * hd \
            or sin.shape != cos.shape:
        raise ValueError(f"tables of shape {tuple(cos.shape)} and "
                         f"{tuple(sin.shape)}, expected [T, hd] = "
                         f"[{T}, {hd}]")
    if x.numel() >= 1 << 31:
        raise ValueError(f"qkv_rotary takes fewer than 2**31 elements a "
                         f"tensor, got {x.numel()}")
    return B, T, heads, hd


def _launch(name, ts, cos, sin, outs, shape, scale):
    B, T, H, hd = shape
    fn = getattr(_lib(), name)
    with torch.cuda.device(ts[0].device):
        err = fn(*(t.data_ptr() for t in (*ts, cos, sin, *outs)), B, T, H,
                 hd, scale, _DTYPES[ts[0].dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    profiling.count(name)


def _fwd_cuda(q, k, v, cos, sin, heads, scale):
    B, T, H, hd = shape = _check((q, k, v), cos, sin, heads)
    outs = [torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
            for _ in range(3)]
    _launch("qkv_rotary_fwd", (q, k, v), cos, sin, outs, shape, scale)
    return tuple(outs)


def _bwd_cuda(gq, gk, gv, cos, sin, scale):
    B, T, H, hd = shape = _check((gq, gk, gv), cos, sin, gq.shape[1])
    outs = [torch.empty((B, T, H * hd), dtype=gq.dtype, device=gq.device)
            for _ in range(3)]
    _launch("qkv_rotary_bwd", (gq, gk, gv), cos, sin, outs, shape, scale)
    return tuple(outs)


class _QKVRotary(torch.autograd.Function):
    """The forward kernel, the backward kernel; saves the tables only."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, heads, scale):
        ctx.save_for_backward(cos, sin)
        ctx.scale = scale
        return _fwd_cuda(q, k, v, cos, sin, heads, scale)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        cos, sin = ctx.saved_tensors
        return (*_bwd_cuda(gq.contiguous(), gk.contiguous(), gv.contiguous(),
                           cos, sin, ctx.scale), None, None, None, None)


def qkv_rotary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, heads: int,
               scale: float):
    """(rotary(q scale), rotary(k), v), each a contiguous [B, heads, T,
    hd], from contiguous [B, T, heads * hd] q, k, v and the tables of
    ``esm2._rotary_tables``: the kernels on CUDA (forward and backward),
    ``qkv_rotary_plain`` and autograd on CPU. On CUDA it takes hd a
    multiple of 8 up to 64, and raises beyond."""
    if q.device.type == "cpu":
        return qkv_rotary_plain(q, k, v, cos, sin, heads, scale)
    return _QKVRotary.apply(q, k, v, cos, sin, heads, scale)


def qkv_rotary_bwd(gq: torch.Tensor, gk: torch.Tensor, gv: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, scale: float):
    """(dq, dk, dv) [B, T, heads * hd] of ``qkv_rotary`` for the
    cotangents [B, heads, T, hd]: the backward kernel on CUDA,
    ``qkv_rotary_bwd_plain`` on CPU."""
    if gq.device.type == "cpu":
        return qkv_rotary_bwd_plain(gq, gk, gv, cos, sin, scale)
    return _bwd_cuda(gq, gk, gv, cos, sin, scale)
