"""The layer norm of ESM2 and the MSA Transformer, forward and backward:
one kernel each way (``csrc/layer_norm.cu``), bf16 or float32 in and out,
float32 only in registers.

Replaces no Pallas TPU kernel: the JAX package's ``_layer_norm``
(``ppde_tpu/models/esm2.py:135``) is ``jnp``, which XLA fuses with its
casts.
In PyTorch's eager ops it was three kernels each way (x cast to float32,
``F.layer_norm``, the cast back; backward the cotangent's cast, the input
gradient, the cast back), which moved 22 units of one [rows, D] tensor in
the stream's type where the function needs 5. For x [..., D] in float32 or
bfloat16 and g, b [D] in float32:

    y = (x - mean(x)) rsqrt(var(x) + eps) g + b

the variance biased, every sum and product in float32, y rounded once to
x's type: the function and the rounding point of the composition
``layer_norm_plain``. The float32 sums run in another order than
``F.layer_norm``'s, so the outputs agree to a float32 rounding before the
one rounding to x's type (at most one bf16 unit in the last place).

Bound on the H100: the bytes, x read and y written once forward (2 units),
x and dy read and dx written once backward (3 units), plus mu and rstd (8
bytes a row) kept between them. The kernels take rows of D a whole number
of 16-byte vectors up to 4,096 elements in bf16 and 2,048 in float32
(``D_MAX``), tensors that start on a 16-byte boundary; the wrapper raises
beyond that. A view whose rows do not lie one after the other (msa-1b's
head reads ``h[:, 0, 1:]``) is copied to a contiguous tensor first.

``layer_norm`` runs ``layer_norm_plain`` for CPU tensors and the kernels
for CUDA tensors (no span of its own: ESM2 and the MSA Transformer launch
them inside ``esm2.norm``, ``esm2.head``, ``msa.<kind>`` and their backward
spans). g's and b's gradients, when autograd asks for them (the trainers),
come from per-block partial sums and a second small kernel; the sampler's
path asks for neither and pays for neither. The counters of ``profiling``
``layer_norm_fwd`` and ``layer_norm_bwd`` count the calls of each kernel
(the module's ``launches_fwd`` and ``launches_bwd`` read them).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ppde_tpu_torch import profiling
from ppde_tpu_torch.ops import _build

__getattr__ = profiling.counter_attributes(
    {"launches_fwd": "layer_norm_fwd", "launches_bwd": "layer_norm_bwd"})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widest row the kernels take: 32 lanes of 16 vectors of 16 bytes
D_MAX = {torch.float32: 2048, torch.bfloat16: 4096}
ROWS_A_BLOCK = 8  # csrc/layer_norm.cu's WARPS: a warp a row
# blocks of the backward that also sums g's and b's gradients, a multiple of
# the card's SMs: each holds its columns' partial sums of all its rows
BLOCKS_PER_SM = 4


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version, the composition the kernels replace, op for
    op: x cast to float32, ``F.layer_norm`` with g, b, the cast back to
    x's type. Differentiable."""
    y = F.layer_norm(x.float(), x.shape[-1:], g, b, eps)
    return y.to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, g: torch.Tensor,
                         eps: float = 1e-5, affine: bool = False):
    """Plain PyTorch version of the backward kernel's formula: (dx, dg, db)
    for the cotangent dy of ``layer_norm_plain(x, g, b, eps)``, with

        xh = (x - mu) rstd,  dx = rstd (g dy - mean(g dy) - xh mean(g dy xh))

    in float32 (float64 for float64 inputs), dx rounded to x's type; dg =
    sum of dy xh and db = sum of dy over every row when ``affine``, else
    None."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dyf, gf = x.to(acc), dy.to(acc), g.to(acc)
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    xh = (xf - mu) * rstd
    gd = gf * dyf
    dx = rstd * (gd - gd.mean(-1, keepdim=True)
                 - xh * (gd * xh).mean(-1, keepdim=True))
    if not affine:
        return dx.to(x.dtype), None, None
    rows = tuple(range(x.dim() - 1))
    return dx.to(x.dtype), (dyf * xh).sum(rows), dyf.sum(rows)


def _lib():
    lib = _build.library("layer_norm")
    if lib.layer_norm_fwd.argtypes is None:  # ints would cut the pointers
        lib.layer_norm_fwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.layer_norm_fwd.restype = ctypes.c_int
        lib.layer_norm_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.layer_norm_bwd.restype = ctypes.c_int
    return lib


def check(x: torch.Tensor, *params: torch.Tensor) -> int:
    """Raise on what the kernels do not take, for x and the float32
    ``params`` (g, b) (metadata only: nothing runs); returns D."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1:
        raise ValueError("layer_norm needs x of at least one dimension")
    D = x.shape[-1]
    for t in params:
        if t.device != x.device:
            raise ValueError("x, g and b must lie on the same device")
        if t.dtype != torch.float32:
            raise TypeError(f"g and b must be float32, got {t.dtype}")
        if t.shape != (D,) or not t.is_contiguous():
            raise ValueError(f"g and b must be a contiguous [{D}], got "
                             f"{tuple(t.shape)}")
    V = 16 // x.element_size()
    if D < V or D % V or D > D_MAX[x.dtype]:
        raise ValueError(f"layer_norm takes D a multiple of {V} up to "
                         f"{D_MAX[x.dtype]} in {x.dtype}, got {D}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *params)):
        raise ValueError("x, g and b must start on a 16-byte boundary (the "
                         "kernels load 16 bytes at a time)")
    if x.numel() // D >= 1 << 31:
        raise ValueError(f"layer_norm takes fewer than 2**31 rows, got "
                         f"{x.numel() // D}")
    return D


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fwd_cuda(x, g, b, eps, keep):
    """y and, when ``keep``, the rows' (mu, rstd) [rows, 2] float32."""
    D = check(x, g, b)
    rows = x.numel() // D
    y = torch.empty_like(x)
    stats = (torch.empty((rows, 2), dtype=torch.float32, device=x.device)
             if keep else None)
    if rows:
        with torch.cuda.device(x.device):
            err = _lib().layer_norm_fwd(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if stats is None else stats.data_ptr(), rows, D, eps,
                _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layer_norm_fwd launch failed: cudaError "
                               f"{err}")
        profiling.count("layer_norm_fwd")
    return y, stats


def _bwd_cuda(x, dy, g, stats, affine):
    """(dx, dg or None, db or None) of the cotangent dy: g's and b's
    gradients when ``affine``."""
    D = check(x, g)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"the cotangent {tuple(dy.shape)} {dy.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("the cotangent must be contiguous and start on a "
                         "16-byte boundary")
    rows = x.numel() // D
    dx = torch.empty_like(x)
    dg = db = part = None
    if affine:  # the kernels write every column of both unless rows = 0
        new = torch.empty if rows else torch.zeros
        dg, db = (new((D,), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    if rows:
        G = 0
        if affine:
            G = min(-(-rows // ROWS_A_BLOCK), BLOCKS_PER_SM * _sms(x.device))
            part = torch.empty((G, 2, D), dtype=torch.float32,
                               device=x.device)
        with torch.cuda.device(x.device):
            err = _lib().layer_norm_bwd(
                x.data_ptr(), dy.data_ptr(), g.data_ptr(), stats.data_ptr(),
                dx.data_ptr(), *(None if t is None else t.data_ptr()
                                 for t in (part, dg, db)), rows, D, G,
                _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layer_norm_bwd launch failed: cudaError "
                               f"{err}")
        profiling.count("layer_norm_bwd")
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    """The forward kernel (keeping mu and rstd), the backward kernel."""

    @staticmethod
    def forward(ctx, x, g, b, eps, keep):
        y, stats = _fwd_cuda(x, g, b, eps, keep)
        if keep:
            ctx.save_for_backward(x, g, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, stats = ctx.saved_tensors
        need_x, need_g, need_b = ctx.needs_input_grad[:3]
        dx, dg, db = _bwd_cuda(x, dy.contiguous(), g, stats, need_g or need_b)
        return (dx if need_x else None, dg if need_g else None,
                db if need_b else None, None, None)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The layer norm of x [..., D] over its last axis with float32 g, b
    [D], in x's type: the kernels on CUDA (forward and backward, g's and
    b's gradients where autograd asks), ``layer_norm_plain`` and autograd
    on CPU. On CUDA it takes float32 or bfloat16 and raises beyond what
    ``check`` allows; a non-contiguous x is copied first."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b, eps)
    return _fused(x, g, b, eps)


def _fused(x, g, b, eps):
    """The Function on x (copied first if its rows do not lie one after
    the other), keeping mu and rstd only where autograd records."""
    keep = torch.is_grad_enabled() and (
        x.requires_grad or g.requires_grad or b.requires_grad)
    return _LayerNorm.apply(x.contiguous(), g, b, eps, keep)
