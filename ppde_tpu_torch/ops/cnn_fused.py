"""Kernel B: fused OnehotCNN-ensemble fitness + input gradient
(``csrc/cnn_ensemble.cu``).

Replaces the Pallas TPU kernel ``ppde_tpu/ops/cnn_pallas.py:
ensemble_fit_and_patch_grad`` (wrapper ``ensemble_apply_and_grad``, with the
im2col/col2im it does in XLA; the member-grid twin
``ensemble_fit_and_patch_grad_m`` has the same contract). It computes, for
one-hot x [B, L, V] and a stacked ensemble of M members,

    fit = mean_m dec(max_T relu(emb(relu(conv1d(x)))))        [B]
    dx  = d sum(fit) / dx                                      [B, L, V]

Bound on the H100: the operations of the three products (forward alone
2*B*T*M*(K*V*C + C*C2), GFP B=1024: about 0.2 TFLOP); the bytes are small.
The TPU kernel keeps a batch tile's activations on chip; at GFP width they
outgrow a block's shared memory in float32. One block per (sample, member)
takes the max-pool's maxima and routed rows first, then gathers the input
gradient from the routed rows; bf16 runs on the tensor cores with the
sample's H1 kept in shared memory as bf16, float32 on FMAs over row tiles
(see the .cu source).

The plain version is ``models.cnn.ensemble_apply_and_grad_plain``.
``ensemble_apply_and_grad`` runs it for a CPU tensor and the kernel for a
CUDA tensor; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ppde_tpu_torch.models.cnn import ensemble_apply_and_grad_plain
from ppde_tpu_torch.ops import _build

__all__ = ["ensemble_apply_and_grad", "ensemble_apply_and_grad_plain"]

launches = 0  # kernel launches made by ensemble_apply_and_grad
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("cnn_ensemble")
    fn = lib.cnn_ensemble_fit_and_grad
    if fn.argtypes is None:  # declare once: ints would cut the pointers
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cnn_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.cnn_smem_bytes.restype = ctypes.c_long
        for name in ("cnn_max_kv", "cnn_max_c", "cnn_max_t"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
    return lib


def ensemble_apply_and_grad(stacked, x: torch.Tensor, compute_dtype=None,
                            pool_bwd: str = "split"):
    """(fitness [B], d sum(fitness) / dx [B, L, V]), both float32.

    stacked: the ensemble layout of ``models.cnn.init_ensemble``
    (encoder.w [M,K,V,C], embed.w [M,C,2C], decoder.w [M,2C,1], ...).
    compute_dtype: None (float32) or torch.bfloat16.
    """
    if x.device.type == "cpu":
        return ensemble_apply_and_grad_plain(stacked, x, compute_dtype,
                                             pool_bwd)
    global launches
    if pool_bwd not in ("split", "first"):
        raise ValueError(f"pool_bwd must be 'split' or 'first': {pool_bwd}")
    cdt = compute_dtype or torch.float32
    if cdt not in _DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16: {cdt}")
    enc, emb, dec = stacked["encoder"], stacked["embed"], stacked["decoder"]
    M, K, V, C = enc["w"].shape
    C2 = emb["w"].shape[-1]
    B, L, Vx = x.shape
    if Vx != V or L < K:
        raise ValueError(f"x {tuple(x.shape)} does not fit encoder "
                         f"{tuple(enc['w'].shape)}")
    if any(t.device != x.device for t in (enc["w"], emb["w"], dec["w"])):
        raise ValueError("x and the ensemble must lie on the same device")
    lib = _lib()
    if (K * V > lib.cnn_max_kv() or C > lib.cnn_max_c()
            or L - K + 1 > lib.cnn_max_t() or V % 2):
        raise ValueError(
            f"kernel B takes K*V <= {lib.cnn_max_kv()}, C <= "
            f"{lib.cnn_max_c()}, L-K+1 <= {lib.cnn_max_t()} and an even V; "
            f"got K*V={K * V}, C={C}, L-K+1={L - K + 1}, V={V}")
    smem = lib.cnn_smem_bytes(L, V, K, C, C2, _DTYPES[cdt])
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel B needs {smem} bytes of shared memory "
                         f"(limit {SMEM_LIMIT}) at L={L}, C={C}")
    f32 = torch.float32
    xc = x.to(cdt).contiguous()
    encw = enc["w"].reshape(M, K * V, C).to(cdt).contiguous()
    encb = enc["b"].to(f32).reshape(M, C).contiguous()
    embw = emb["w"].to(cdt).contiguous()
    embwT = embw.transpose(1, 2).contiguous()  # rows of the backward gather
    embb = emb["b"].to(f32).reshape(M, C2).contiguous()
    decw = dec["w"].to(cdt).reshape(M, C2).contiguous()
    decb = dec["b"].to(f32).reshape(M).contiguous()
    dev = x.device
    pred = torch.empty((M, B), dtype=f32, device=dev)
    dxm = torch.empty((M, B, L * V), dtype=f32, device=dev)
    fit = torch.empty((B,), dtype=f32, device=dev)
    dx = torch.empty((B, L, V), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cnn_ensemble_fit_and_grad(
            xc.data_ptr(), encw.data_ptr(), encb.data_ptr(), embw.data_ptr(),
            embwT.data_ptr(), embb.data_ptr(), decw.data_ptr(),
            decb.data_ptr(),
            pred.data_ptr(), dxm.data_ptr(), fit.data_ptr(), dx.data_ptr(),
            B, L, V, K, C, C2, M, int(pool_bwd == "first"), _DTYPES[cdt],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kernel B (cnn_ensemble) launch failed: "
                           f"cudaError {err}")
    launches += 1
    return fit, dx
