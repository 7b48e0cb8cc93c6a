"""Kernel A: fused Potts energy + input gradient (``csrc/potts_energy.cu``).

Replaces the Pallas TPU kernel ``ppde_tpu/ops/potts_pallas.py:
energy_and_grad``. For flattened one-hots xf [B, P], W [P, P] and h [P]
(P % 128 == 0; W and h float32 or bfloat16, xf cast to W's type):

    grad = xf @ W + h                        [B, P] float32
    H    = sum(xf * (0.5 * (xf @ W) + h))    [B]    float32

Bound on the H100: the bytes of W at small B (GFP bf16: 47 MB, about 14 us
at 3.35 TB/s), the 2*B*P*P operations at large B. The kernel is a GEMM whose
epilogue writes the gradient tile and one partial energy per row; a second
kernel adds the partials in a fixed order (no atomics; see the .cu source).

``energy_and_grad`` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch.ops import _build

launches = 0  # kernel launches made by energy_and_grad
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def energy_and_grad_plain(W: torch.Tensor, h: torch.Tensor,
                          xf: torch.Tensor):
    """Plain PyTorch version: (H [B], grad [B, P]), float32 sums."""
    x = xf.to(W.dtype).float()
    Jx = x @ W.float()
    hf = h.float()
    return (x * (0.5 * Jx + hf)).sum(-1), Jx + hf


def _lib():
    lib = _build.library("potts_energy")
    fn = lib.potts_energy_and_grad
    if fn.argtypes is None:  # declare once: ints would cut the pointers
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.potts_tile_n.argtypes = []
        lib.potts_tile_n.restype = ctypes.c_int
    return lib


def energy_and_grad(W: torch.Tensor, h: torch.Tensor, xf: torch.Tensor):
    """(H [B], grad [B, P]) for xf [B, P]: kernel A on CUDA, plain on CPU."""
    if xf.device.type == "cpu":
        return energy_and_grad_plain(W, h, xf)
    global launches
    B, P = xf.shape
    if W.device != xf.device or h.device != xf.device:
        raise ValueError("xf, W and h must lie on the same device")
    if W.dtype not in _DTYPES or h.dtype != W.dtype:
        raise TypeError(f"W and h must share float32 or bfloat16, got "
                        f"{W.dtype} and {h.dtype}")
    if W.shape != (P, P) or h.shape != (P,) or P % 128:
        raise ValueError(f"need W [P,P], h [P] with P % 128 == 0; got "
                         f"{tuple(W.shape)}, {tuple(h.shape)}")
    if not (W.is_contiguous() and h.is_contiguous()):
        raise ValueError("W and h must be contiguous")
    lib = _lib()
    x = xf.to(W.dtype).contiguous()
    grad = torch.empty((B, P), dtype=torch.float32, device=xf.device)
    partial = torch.empty((B, P // lib.potts_tile_n()), dtype=torch.float32,
                          device=xf.device)
    H = torch.empty((B,), dtype=torch.float32, device=xf.device)
    with torch.cuda.device(xf.device):
        err = lib.potts_energy_and_grad(
            x.data_ptr(), W.data_ptr(), h.data_ptr(), grad.data_ptr(),
            partial.data_ptr(), H.data_ptr(), B, P, _DTYPES[W.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel A (potts_energy) launch failed: "
                           f"cudaError {err}")
    launches += 1
    return H, grad
