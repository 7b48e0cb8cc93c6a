"""Kernel A: fused Potts energy + input gradient (``csrc/potts_energy.cu``).

Replaces the Pallas TPU kernel ``ppde_tpu/ops/potts_pallas.py:
energy_and_grad``. For flattened one-hots xf [B, P], W [P, P] and h [P]
(P % 128 == 0; W and h float32 or bfloat16):

    grad = xf @ W + h                        [B, P] float32
    H    = sum(xf * (0.5 * (xf @ W) + h))    [B]    float32

The kernel runs on ``wgmma`` over bf16 planes of W whose sum is W: a bf16 W
is one plane; a float32 W is split once into three (``prepare``), and since
W_hi + W_mid + W_lo == W exactly and xf's 0/1 entries are exact in bf16,
every product is exact and the float32 result differs from a float32
``xf @ W`` only by the order of its float32 sums. h is taken in float32.

Bound on the H100: bytes in bf16 (GFP: W 47 MB read once and the float32
gradient written once, about 15 us at B = 128 and 23 us at B = 1024 at
3.35 TB/s); the float32 path's three products (0.15 ms at B = 1024 at the
bf16 tensor-core peak) bound it by operations from a few hundred rows on.
The kernel is a GEMM on 128 x 128 tiles whose operands reach shared memory
through a ring of cp.async stages, the planes of each depth one after
another (a row of xf with a single 1 at k gives W[k] + h bit for bit), and
whose epilogue writes the gradient tile and one partial energy per row; at
small B it splits K, between depths, so that every SM has a block, and a
second kernel adds the splits and the partial energies in a fixed order (no
atomics; see the .cu source).
The W tile is read MN-major, as it lies in memory, so W need not be
symmetric.

A call may take a column block of the couplings instead, W[:, c0 : c0 + N]
with h[c0 : c0 + N] and ``col0=c0`` (N and c0 multiples of 128: the
tensor-parallel shard of ``parallel/mesh.shard_potts``): it returns the
block's share of H, sum_j xf[:, c0 + j] * (0.5 * (xf @ W)[:, c0 + j] +
h[c0 + j]) over the block's columns, and its gradient [B, N]. The shares of
all blocks sum to H; the whole call is the block (0, P).

``prepare(W, h)`` returns a ``Prepared`` that ``energy_and_grad`` takes in
place of W (``energy.protein_poe`` keeps one per energy); handing in W and h
prepares on every call. ``energy_and_grad`` runs the plain version for a
CPU tensor and the kernel for a CUDA tensor, in the span ``kernel.a``; the
counters ``potts_energy`` (kernel launches) and ``potts_energy_f32`` (those
on a float32 W) of ``profiling`` count them, also read as the module's
``launches`` and ``launches_f32``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.ops import _build

__getattr__ = profiling.counter_attributes(
    {"launches": "potts_energy", "launches_f32": "potts_energy_f32"})
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class Prepared:
    """Couplings split once for kernel A.

    ``W`` and ``h`` are what it was made from (the CPU path and the plain
    version use them; W may be a column block [P, N]); ``planes`` [n, P, N]
    bf16 sum to W (n = 1 for a bf16
    W, which is its own plane; n = 3 for a float32 W); ``h32`` is h in
    float32."""

    W: torch.Tensor
    h: torch.Tensor
    planes: torch.Tensor
    h32: torch.Tensor


def split_planes(W: torch.Tensor) -> torch.Tensor:
    """[P, P] float32 -> [3, P, P] bf16 (hi, mid, lo) with hi + mid + lo
    == W bit for bit for every W whose planes stay out of bf16's subnormal
    range (each rounding to nearest leaves a remainder the next plane holds;
    a remainder of zero takes W's sign, so that -0 stays -0)."""
    def remainder(a, b):
        r = a - b.float()
        return torch.where(r == 0, W * 0, r)

    hi = W.to(torch.bfloat16)
    rest = remainder(W, hi)
    mid = rest.to(torch.bfloat16)
    lo = remainder(rest, mid).to(torch.bfloat16)
    return torch.stack((hi, mid, lo))


def prepare(W: torch.Tensor, h: torch.Tensor) -> Prepared:
    """Split W (float32: three planes; bf16: W itself) and cast h to
    float32 once, for many calls of ``energy_and_grad``."""
    if W.dtype not in _DTYPES or h.dtype != W.dtype:
        raise TypeError(f"W and h must share float32 or bfloat16, got "
                        f"{W.dtype} and {h.dtype}")
    if W.dim() != 2 or h.shape != W.shape[1:] or W.shape[0] % 128 \
            or W.shape[1] % 128 or W.shape[1] > W.shape[0]:
        raise ValueError(f"need W [P, N], h [N] with P and N multiples of "
                         f"128 and N <= P; got {tuple(W.shape)}, "
                         f"{tuple(h.shape)}")
    if not (W.is_contiguous() and h.is_contiguous()):
        raise ValueError("W and h must be contiguous")
    planes = (W.reshape(1, *W.shape) if W.dtype == torch.bfloat16
              else split_planes(W))
    return Prepared(W, h, _aligned(planes), _aligned(h.float().contiguous()))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it if it does not start on a 16-byte boundary (a
    view at an odd offset): the kernel reads its operands 16 bytes at a
    time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def energy_and_grad_plain(W: torch.Tensor, h: torch.Tensor,
                          xf: torch.Tensor, col0: int = 0):
    """Plain PyTorch version: (H [B], grad [B, N]), float32 sums; W [P, N]
    the column block from ``col0`` (the whole couplings: N = P, col0 = 0)
    and H its share."""
    x = xf.to(W.dtype).float()
    Jx = x @ W.float()
    hf = h.float()
    xb = x[:, col0:col0 + W.shape[1]]
    return (xb * (0.5 * Jx + hf)).sum(-1), Jx + hf


def _lib():
    lib = _build.library("potts_energy")
    fn = lib.potts_energy_and_grad
    if fn.argtypes is None:  # declare once: ints would cut the pointers
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.potts_splits.argtypes = [ctypes.c_int] * 3
        lib.potts_splits.restype = ctypes.c_int
    return lib


def energy_and_grad(W, h, xf: torch.Tensor, col0: int = 0):
    """(H [B], grad [B, N]) for xf [B, P]: kernel A on CUDA, plain on CPU.

    W: the couplings [P, P] with h [P], or their column block [P, N] from
    ``col0`` with h's block [N] (then H is the block's share), or the
    ``Prepared`` that ``prepare`` made of either (then h is not read and may
    be None). xf holds one-hots, as the TPU kernel's contract says: the
    kernel reads it in bf16, which holds 0 and 1 exactly (other values would
    be rounded)."""
    prep = W if isinstance(W, Prepared) else None
    if xf.device.type == "cpu":
        return (energy_and_grad_plain(prep.W, prep.h, xf, col0) if prep
                else energy_and_grad_plain(W, h, xf, col0))
    if prep is None:
        prep = prepare(W, h)
    B, P = xf.shape
    planes = prep.planes
    N = planes.shape[-1]
    if planes.device != xf.device:
        raise ValueError("xf, W and h must lie on the same device")
    if planes.shape[-2] != P or col0 % 128 or col0 < 0 or col0 + N > P:
        raise ValueError(f"xf [B, {P}] does not fit W "
                         f"{tuple(prep.W.shape)} at column {col0}")
    with profiling.span("kernel.a"):
        lib = _lib()
        x = _aligned(xf.to(torch.bfloat16).contiguous())
        grad = torch.empty((B, N), dtype=torch.float32, device=xf.device)
        splits = lib.potts_splits(B, P, N)
        partial = torch.empty((B, splits * (N // 128)),
                              dtype=torch.float32, device=xf.device)
        gpart = (torch.empty((splits, B, N), dtype=torch.float32,
                             device=xf.device) if splits > 1 else grad)
        H = torch.empty((B,), dtype=torch.float32, device=xf.device)
        with torch.cuda.device(xf.device):
            err = lib.potts_energy_and_grad(
                x.data_ptr(), planes.data_ptr(), prep.h32.data_ptr(),
                grad.data_ptr(), gpart.data_ptr(), partial.data_ptr(),
                H.data_ptr(), B, P, N, col0, planes.shape[0], splits,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel A (potts_energy) launch failed: "
                               f"cudaError {err}")
        profiling.count("potts_energy")
        profiling.count("potts_energy_f32",
                        int(prep.W.dtype == torch.float32))
    return H, grad
