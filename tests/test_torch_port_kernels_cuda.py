"""Kernels A, B, C and C', the qkv / rotary kernels, kernels T and T'
(the MSA Transformer's tied row attention) and the layer-norm kernels
against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch.cuda.is_available() is False
(CUDA kernels have no CPU or interpret mode). On a machine with a GPU:
``python -m pytest --noconftest tests/test_torch_port_kernels_cuda.py``
(``--noconftest``: the repo's conftest imports JAX, which that machine
lacks). The cases are chip_smoke.py's at small sizes.
"""
import contextlib
import io
import json
import math
import re

import numpy as np
import pytest
import torch

from ppde_tpu_torch.models import cnn, esm2
from ppde_tpu_torch.ops import (attention_fused, cnn_fused,
                                layer_norm_fused, potts_fused, rotary_fused,
                                row_attention_fused)

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _onehot(rng, B, L, dev):
    toks = torch.from_numpy(rng.integers(0, 20, (B, L)))
    return torch.nn.functional.one_hot(toks, 20).float().to(dev)


def _potts(rng, L, dtype, dev):
    P = -(-L * 20 // 128) * 128
    W = rng.standard_normal((P, P)).astype(np.float32) * 0.05
    W = 0.5 * (W + W.T)
    W[L * 20:] = 0.0
    W[:, L * 20:] = 0.0
    h = np.zeros(P, np.float32)
    h[:L * 20] = rng.normal(0, 0.5, L * 20)
    return (torch.from_numpy(W).to(dev, dtype),
            torch.from_numpy(h).to(dev, dtype), P)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B", [8, 64, 37])
def test_potts_kernel_matches_plain(dev, dtype, B):
    rng = np.random.default_rng(B)
    L = 30
    W, h, P = _potts(rng, L, dtype, dev)
    xf = torch.nn.functional.pad(_onehot(rng, B, L, dev).reshape(B, -1),
                                 (0, P - L * 20))
    n0 = potts_fused.launches
    H, g = potts_fused.energy_and_grad(W, h, xf)
    assert potts_fused.launches == n0 + 1
    H0, g0 = potts_fused.energy_and_grad_plain(W, h, xf)
    # float32 sums in another order: products of one-hots with W are exact
    torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(H, H0, rtol=1e-5, atol=1e-3)
    # no atomics: the energy repeats bit for bit
    H2, _ = potts_fused.energy_and_grad(W, h, xf)
    assert torch.equal(H, H2)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("B", [1, 37, 64, 130, 1024])
@pytest.mark.parametrize("P", [128, 256, 640, 4864])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_potts_kernel_at_tile_edges(dev, dtype, P, B, symmetric):
    """Kernel A at ragged B (one row, a part of a 128-row tile, one over a
    tile), at one, two, five and 38 column tiles (which the kernel splits
    over K), for the symmetric couplings and for a W that is not (the kernel
    reads the W tile as it lies in memory and must give xf @ W, not
    xf @ W.T); from a Prepared (float32: three bf16 planes that sum to W)
    and from W and h (prepared on the spot): the same bits, and every
    output repeats bit for bit."""
    rng = np.random.default_rng(P + B + (dtype == F32))
    L = P // 20
    W, h, P_ = _potts(rng, L, dtype, dev)
    assert P_ == P and torch.equal(W, W.T)
    if not symmetric:
        W = torch.triu(W).contiguous()
        assert not torch.equal(W, W.T)
    xf = torch.nn.functional.pad(_onehot(rng, B, L, dev).reshape(B, -1),
                                 (0, P - L * 20))
    prep = potts_fused.prepare(W, h)
    if dtype == F32:
        assert prep.planes.shape == (3, P, P)
        assert torch.equal(prep.planes.float().sum(0), W)
    n0, f0 = potts_fused.launches, potts_fused.launches_f32
    H, g = potts_fused.energy_and_grad(prep, None, xf.to(BF16))
    assert (potts_fused.launches, potts_fused.launches_f32) == (
        n0 + 1, f0 + (dtype == F32))
    H0, g0 = potts_fused.energy_and_grad_plain(W, h, xf)
    torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(H, H0, rtol=1e-5, atol=1e-3)
    H1, g1 = potts_fused.energy_and_grad(W, h, xf)
    assert torch.equal(H, H1) and torch.equal(g, g1)
    H2, g2 = potts_fused.energy_and_grad(prep, None, xf)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def _hand_picked_w():
    """A 128 x 128 float32 W of +0, -0, large and tiny normal values, values
    with all 24 significand bits set, and random significands of random
    exponents (every plane nonzero, the lo plane as large as it gets
    against the sum)."""
    rng = np.random.default_rng(9)
    vals = np.array([0.0, -0.0, 1e38, -3e37, 2.0 ** -100,
                     -(2.0 ** -90) * 1.5,
                     np.nextafter(np.float32(1.0), np.float32(2.0)),
                     np.float32(1.0) - np.float32(2 ** -24),
                     16777215.0, -0.1, 1 / 3, np.pi], np.float32)
    all_bits = ((np.arange(40, 240, dtype=np.uint32) << 23) | 0x7FFFFF)
    # random significands with a bit set in the ranges of both the mid and
    # the lo plane
    mant = rng.integers(0, 1 << 23, 128 * 128, dtype=np.uint32) | 0x8080
    expo = rng.integers(60, 190, 128 * 128, dtype=np.uint32)
    sign = rng.integers(0, 2, 128 * 128, dtype=np.uint32) << 31
    w = (sign | expo << 23 | mant).view(np.float32).copy()
    w[:len(vals)] = vals
    w[len(vals):len(vals) + len(all_bits)] = all_bits.view(np.float32)
    return torch.from_numpy(w.reshape(128, 128))


@pytest.mark.parametrize("which", ["seeded-4864", "seeded-256",
                                   "hand-picked"])
def test_potts_f32_one_1_rows_give_w_bit_for_bit(dev, which):
    """Rows of xf that each hold a single 1, at k: the plain float32 result
    is exactly W[k] + h, and the kernel's must be too, bit for bit. This
    holds only if every plane, lo included, reaches the sums without loss
    (a lo plane skipped or read as zeros moves grad by ~2^-18 |W|, well
    inside the tolerance of the random one-hot tests)."""
    if which == "hand-picked":
        W = _hand_picked_w().to(dev)
        h = torch.linspace(-1.0, 1.0, 128, device=dev)
    else:
        P = int(which.split("-")[1])
        W, h, _ = _potts(np.random.default_rng(P), P // 20, F32, dev)
        W = torch.triu(W).contiguous()
    P = W.shape[0]
    prep = potts_fused.prepare(W, h)
    assert torch.equal(prep.planes.float().sum(0), W)
    assert bool((prep.planes[2] != 0).any())   # the lo plane is in use
    eye = torch.eye(P, dtype=BF16, device=dev)
    rows = torch.randperm(P, generator=torch.Generator().manual_seed(P))
    for xf in (eye, eye[rows[:37].to(dev)]):   # split over K, and not
        H, g = potts_fused.energy_and_grad(prep, None, xf)
        k = xf.float().argmax(-1)
        assert torch.equal(g, W[k] + h)
        H0, g0 = potts_fused.energy_and_grad_plain(W, h, xf)
        assert torch.equal(g, g0) and torch.equal(H, H0)


def test_potts_kernel_rejects_bad_input(dev):
    W = torch.zeros((100, 100), device=dev)
    with pytest.raises(ValueError):
        potts_fused.energy_and_grad(W, torch.zeros(100, device=dev),
                                    torch.zeros((4, 100), device=dev))
    W = torch.zeros((128, 128), device=dev)
    with pytest.raises(TypeError):   # h of another type than W
        potts_fused.energy_and_grad(W, torch.zeros(128, device=dev,
                                                   dtype=BF16),
                                    torch.zeros((4, 128), device=dev))
    prep = potts_fused.prepare(W, torch.zeros(128, device=dev))
    with pytest.raises(ValueError):  # xf of another width
        potts_fused.energy_and_grad(prep, None,
                                    torch.zeros((4, 256), device=dev))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_potts_kernel_takes_views_at_odd_offsets(dev, dtype):
    """W, h and xf that do not start on a 16-byte boundary (views at an odd
    offset; the kernel reads 16 bytes at a time) are copied, not read
    misaligned: the same bits as from aligned tensors."""
    rng = np.random.default_rng(2)
    W, h, P = _potts(rng, 30, dtype, dev)
    xf = torch.nn.functional.pad(_onehot(rng, 5, 30, dev).reshape(5, -1),
                                 (0, P - 600)).to(BF16)
    H0, g0 = potts_fused.energy_and_grad(W, h, xf)

    def odd(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 and v.is_contiguous()
        return v

    H, g = potts_fused.energy_and_grad(odd(W), odd(h), odd(xf))
    assert torch.equal(H, H0) and torch.equal(g, g0)


def _tie_input(B, L, dev):
    """Sequences of period 5: every window repeats, so the max-pool has
    exact ties in every channel."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 20, (B, 5))
    toks = torch.from_numpy(np.tile(base, (1, -(-L // 5)))[:, :L])
    return torch.nn.functional.one_hot(toks, 20).float().to(dev)


def _check_cnn(fit, dx, fit0, dx0, dtype):
    """fit: close everywhere. dx: close except where float32 summation order
    flips which row holds a channel's max (a near-tie: it moves one
    channel's gradient between rows); such flips are rare, so at most 0.1%
    of the entries may differ and the directions must agree."""
    if dtype == F32:
        f_tol, d_atol, d_rtol, cos_min = (1e-4, 1e-5), 1e-6, 1e-4, 0.9999
    else:  # bf16 activations: rounding straddles add one-ulp differences
        f_tol, d_atol, d_rtol, cos_min = (1e-2, 1e-3), 1e-5, 2e-2, 0.999
    torch.testing.assert_close(fit, fit0, rtol=f_tol[0], atol=f_tol[1])
    bad = ((dx - dx0).abs() > d_atol + d_rtol * dx0.abs()).float().mean()
    assert bad <= 1e-3, float(bad)
    cos = (dx * dx0).sum() / (dx.norm() * dx0.norm())
    assert cos >= cos_min, float(cos)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("B", [8, 37])
@pytest.mark.parametrize("ties", [False, True])
def test_cnn_kernel_matches_plain(dev, dtype, pool, B, ties):
    L = 40
    g = torch.Generator(device=dev).manual_seed(0)
    ens = cnn.init_ensemble(g, 3, input_size=24)
    x = (_tie_input(B, L, dev) if ties
         else _onehot(np.random.default_rng(B), B, L, dev))
    n0 = cnn_fused.launches
    fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, dtype, pool)
    assert cnn_fused.launches == n0 + 1
    assert fit.shape == (B,) and dx.shape == x.shape
    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, dtype, pool)
    _check_cnn(fit, dx, fit0, dx0, dtype)
    if ties:  # the tie input makes the two modes differ
        _, dx_other = cnn_fused.ensemble_apply_and_grad(
            ens, x, dtype, "first" if pool == "split" else "split")
        assert not torch.allclose(dx, dx_other)
    fit2, dx2 = cnn_fused.ensemble_apply_and_grad(ens, x, dtype, pool)
    assert torch.equal(fit, fit2) and torch.equal(dx, dx2)  # deterministic


def test_cnn_kernel_at_gfp_width(dev):
    """One call at the main path's widths (L=237, C=237, 2C=474, M=3)."""
    g = torch.Generator(device=dev).manual_seed(1)
    ens = cnn.init_ensemble(g, 3, input_size=237)
    x = _onehot(np.random.default_rng(3), 16, 237, dev)
    for dtype in (F32, BF16):
        fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, dtype)
        fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, dtype)
        _check_cnn(fit, dx, fit0, dx0, dtype)


@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("C,L,B", [
    (24, 40, 1), (37, 40, 5),   # C not a multiple of 16
    (37, 5, 5),                 # L = K: one row per sample
    (24, 40, 128),
    (24, 40, 300),              # more samples than persistent blocks
    (37, 133, 4),               # T = 129: float32's second row block of one
    (237, 237, 5),              # the main path's widths
    (256, 260, 3),              # T = 256, C = 256, 2C = 512: the limits
])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_cnn_kernel_at_tile_edges(dev, dtype, C, L, B, pool, ties):
    """Kernel B at the edges of its tiling (float32: row blocks of 128,
    column chunks of 128, C padded to 16), from prepared weights and from
    the stacked layout: equal bits, and both repeat themselves."""
    g = torch.Generator(device=dev).manual_seed(C)
    ens = cnn.init_ensemble(g, 3, input_size=C)
    x = (_tie_input(B, L, dev) if ties
         else _onehot(np.random.default_rng(B + L), B, L, dev))
    prep = cnn_fused.prepare_ensemble(ens, dtype)
    n0, f0 = cnn_fused.launches, cnn_fused.launches_f32
    fit, dx = cnn_fused.ensemble_apply_and_grad(prep, x, None, pool)
    assert (cnn_fused.launches, cnn_fused.launches_f32) == (
        n0 + 1, f0 + (dtype == F32))
    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, dtype, pool)
    _check_cnn(fit, dx, fit0, dx0, dtype)
    fit2, dx2 = cnn_fused.ensemble_apply_and_grad(ens, x, dtype, pool)
    assert torch.equal(fit, fit2) and torch.equal(dx, dx2)
    if ties and L > 9:  # the tie input makes the two modes differ
        _, dx_other = cnn_fused.ensemble_apply_and_grad(
            prep, x, None, "first" if pool == "split" else "split")
        assert not torch.allclose(dx, dx_other)


def test_cnn_bf16_kernel_takes_relaxed_inputs(dev):
    """Inputs that are not one-hot (several nonzero letters, or none, at a
    position) go through the kernel's general conv path."""
    g = torch.Generator(device=dev).manual_seed(3)
    ens = cnn.init_ensemble(g, 3, input_size=24)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((6, 40, 20)).astype(np.float32))
    x = (x * (x > 0.7)).to(dev)       # sparse rows, some of them empty
    fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, BF16)
    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, BF16)
    _check_cnn(fit, dx, fit0, dx0, BF16)


@pytest.mark.parametrize("L", [40, 237])
def test_cnn_f32_kernel_takes_relaxed_inputs(dev, L):
    """Inputs that are not one-hot (several nonzero letters, or none, at a
    position) go through the float32 kernel's general conv path."""
    g = torch.Generator(device=dev).manual_seed(4)
    ens = cnn.init_ensemble(g, 3, input_size=24 if L == 40 else 237)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((6, L, 20)).astype(np.float32))
    x = (x * (x > 0.7)).to(dev)       # sparse rows, some of them empty
    x[0, 3] = 0.0
    x[0, 3, 5] = 0.5                  # one letter, not of value 1
    for pool in ("split", "first"):
        fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, F32, pool)
        fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, F32,
                                                            pool)
        _check_cnn(fit, dx, fit0, dx0, F32)


def test_cnn_f32_kernel_rejects_what_it_does_not_take(dev):
    """Every length and channel count has a kernel now; a patch deeper than
    the kernels' K*V of 128 still raises."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = _onehot(np.random.default_rng(0), 2, 40, dev)
    deep = cnn.init_ensemble(g, 2, input_size=24, kernel_size=7)  # K*V 140
    with pytest.raises(ValueError):
        cnn_fused.ensemble_apply_and_grad(deep, x, F32)


def test_cnn_kernel_rejects_bad_input(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    ens = cnn.init_ensemble(g, 2, input_size=24)
    prep = cnn_fused.prepare_ensemble(ens, BF16)
    x = _onehot(np.random.default_rng(0), 2, 300, dev)
    with pytest.raises(TypeError):
        cnn_fused.ensemble_apply_and_grad(prep, x[:, :40], F32)


@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("L,C,B", [
    (261, 261, 3), (400, 400, 3), (1022, 1022, 2),  # the reference width
    (300, 24, 5),     # T > 256 alone
    (40, 300, 4),     # C > 256 alone
    (9, 600, 3),      # a sequence of 5 rows, C over one depth chunk of 512
    (1100, 1100, 1),  # C over the 1,024 channels of H1 held at once
    # the edges of the tiling: row tiles of 128 (T = L - 4: 255, 256, 128,
    # 129), column tiles (float32 128; bf16 256 or 200, whichever pads 2C
    # less: 2C = 254, 256, 258 and 398, 400, 402), depth chunks (bf16 64,
    # float32 16: C = 63, 64, 65), one sample
    (259, 259, 2), (260, 260, 2), (132, 300, 2), (133, 300, 2),
    (300, 127, 2), (300, 128, 2), (300, 129, 2),
    (300, 199, 2), (300, 200, 2), (300, 201, 2),
    (300, 63, 2), (300, 64, 2), (300, 65, 2),
    (400, 400, 1),
])
def test_cnn_wide_kernel_matches_plain(dev, dtype, L, C, B, pool, ties):
    """The wide kernel (T > 256, C > 256 or 2C > 512) against its plain
    version at the reference width C = L and beside it, ties included:
    launched once, repeatable, and split and first differ on ties."""
    g = torch.Generator(device=dev).manual_seed(L + C)
    ens = cnn.init_ensemble(g, 3, input_size=C)
    x = (_tie_input(B, L, dev) if ties
         else _onehot(np.random.default_rng(B + L), B, L, dev))
    prep = cnn_fused.prepare_ensemble(ens, dtype)
    n0, w0 = cnn_fused.launches, cnn_fused.launches_wide
    fit, dx = cnn_fused.ensemble_apply_and_grad(prep, x, None, pool)
    assert (cnn_fused.launches, cnn_fused.launches_wide) == (n0 + 1, w0 + 1)
    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, dtype, pool)
    _check_cnn(fit, dx, fit0, dx0, dtype)
    fit2, dx2 = cnn_fused.ensemble_apply_and_grad(ens, x, dtype, pool)
    assert torch.equal(fit, fit2) and torch.equal(dx, dx2)
    if ties and L > 9:
        _, dx_other = cnn_fused.ensemble_apply_and_grad(
            prep, x, None, "first" if pool == "split" else "split")
        assert not torch.allclose(dx, dx_other)


@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_cnn_wide_kernel_on_a_member_block(dev, dtype, pool):
    """Two of four members (the block an ep rank holds) at L = 400: the
    wide kernel against its plain version on those members."""
    g = torch.Generator(device=dev).manual_seed(400)
    ens = cnn.init_ensemble(g, 4, input_size=400)

    def block(tree):
        return {k: block(v) if isinstance(v, dict) else v[:2].contiguous()
                for k, v in tree.items()}
    part = block(ens)
    x = _onehot(np.random.default_rng(11), 3, 400, dev)
    w0 = cnn_fused.launches_wide
    fit, dx = cnn_fused.ensemble_apply_and_grad(part, x, dtype, pool)
    assert cnn_fused.launches_wide == w0 + 1
    fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(part, x, dtype, pool)
    _check_cnn(fit, dx, fit0, dx0, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_cnn_wide_kernel_takes_relaxed_inputs(dev, dtype):
    """Inputs that are not one-hot go through the wide kernel's general
    conv, in the forward and in the backward's relu mask."""
    g = torch.Generator(device=dev).manual_seed(8)
    ens = cnn.init_ensemble(g, 3, input_size=300)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((3, 300, 20)).astype(np.float32))
    x = (x * (x > 0.7)).to(dev)
    for pool in ("split", "first"):
        fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x, dtype, pool)
        fit0, dx0 = cnn_fused.ensemble_apply_and_grad_plain(ens, x, dtype,
                                                            pool)
        _check_cnn(fit, dx, fit0, dx0, dtype)


def _qkv(Z, T, hd, dtype, dev, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (rng.standard_normal((Z, T, hd)) * 0.5).astype(np.float32)).to(
            dev, dtype) for _ in range(n)]


def _attn_tol(dtype):
    # float32: sums in another order; bf16: one rounding of w and ds (the
    # JAX package's own bound in tests/test_attention_pallas.py)
    return (dict(rtol=1e-4, atol=1e-5) if dtype == F32
            else dict(rtol=3e-2, atol=3e-2))


ATTN_SHAPES = [(4, 16, 8), (7, 33, 16), (6, 237, 24), (8, 64, 32),
               (3, 130, 64), (2, 1, 24), (2, 512, 64), (5, 65, 48)] + [
    # the edges of the tilings: 16-column groups and 64-row strips of the
    # bf16 register kernels (T <= 256), the switch to the key-tiled kernels
    # above 256 (float32: all T), their 64-row tiles; hd an odd multiple of
    # 8 (8, 24, 40:
    # a last k8 step, rows unpadded in shared memory) and a multiple of 16
    # (32, 64: rows padded by 8)
    (3, T, hd) for T in (1, 15, 16, 17, 63, 64, 65, 237, 255, 256, 257, 512)
    for hd in (8, 24, 32, 40, 64)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("Z,T,hd", ATTN_SHAPES)
def test_attention_fwd_kernel_matches_plain(dev, dtype, Z, T, hd):
    q, k, v = _qkv(Z, T, hd, dtype, dev, seed=T)
    n0 = attention_fused.launches_fwd
    o = attention_fused.flash_attention(q, k, v)
    assert attention_fused.launches_fwd == n0 + 1
    torch.cuda.synchronize()
    o0 = attention_fused.attention_plain(q, k, v)
    torch.testing.assert_close(o.float(), o0.float(), **_attn_tol(dtype))
    assert torch.equal(o, attention_fused.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("Z,T,hd", ATTN_SHAPES)
def test_attention_bwd_kernel_matches_plain(dev, dtype, Z, T, hd):
    q, k, v, dout = _qkv(Z, T, hd, dtype, dev, seed=T + 1, n=4)
    n0 = attention_fused.launches_bwd
    got = attention_fused.flash_attention_bwd(q, k, v, dout)
    assert attention_fused.launches_bwd == n0 + 1
    torch.cuda.synchronize()
    want = attention_fused.attention_bwd_plain(q, k, v, dout)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.float(), b.float(), msg=lambda m: (
            f"{name}: {m}"), **_attn_tol(dtype))
    again = attention_fused.flash_attention_bwd(q, k, v, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("T", [64, 237, 512, 1024])
def test_attention_kernels_wide_score_range(dev, dtype, T):
    """Scores spread over about +-150: exp underflows to 0 for most columns
    and overflows unless the row max is subtracted; the kernels must still
    match the plain versions."""
    Z, hd = 4, 24
    q, k, v, dout = _qkv(Z, T, hd, dtype, dev, seed=T + 7, n=4)
    q, k = (q.float() * 6.0).to(dtype), (k.float() * 6.0).to(dtype)
    s = torch.einsum("zqd,zkd->zqk", q.float(), k.float())
    assert s.abs().max() > 100.0
    o = attention_fused.flash_attention(q, k, v)
    got = attention_fused.flash_attention_bwd(q, k, v, dout)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(
        o.float(), attention_fused.attention_plain(q, k, v).float(),
        **_attn_tol(dtype))
    want = attention_fused.attention_bwd_plain(q, k, v, dout)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), b.float(), msg=lambda m: (
            f"{name}: {m}"), **_attn_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hd", [24, 32, 64])
@pytest.mark.parametrize("T", [257, 513, 601, 1024])
def test_attention_kernels_at_long_lengths(dev, dtype, T, hd):
    """The key-tiled kernels past the old limit of T = 512, up to ESM2's
    trained context (T = 1024): forward and backward against the plain
    versions, repeatable bit for bit, launched once each."""
    Z = 3
    q, k, v, dout = _qkv(Z, T, hd, dtype, dev, seed=T * hd, n=4)
    n0 = (attention_fused.launches_fwd_kt, attention_fused.launches_bwd_kt)
    o = attention_fused.flash_attention(q, k, v)
    got = attention_fused.flash_attention_bwd(q, k, v, dout)
    assert (attention_fused.launches_fwd_kt,
            attention_fused.launches_bwd_kt) == (n0[0] + 1, n0[1] + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        o.float(), attention_fused.attention_plain(q, k, v).float(),
        **_attn_tol(dtype))
    want = attention_fused.attention_bwd_plain(q, k, v, dout)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.float(), b.float(), msg=lambda m: (
            f"{name}: {m}"), **_attn_tol(dtype))
    assert torch.equal(o, attention_fused.flash_attention(q, k, v))
    again = attention_fused.flash_attention_bwd(q, k, v, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("Z,T,hd", [(320, 237, 24), (40, 256, 64),
                                    (20, 512, 64), (20, 1024, 24)])
def test_attention_bwd_kernel_repeats_bit_for_bit(dev, Z, T, hd):
    """Kernel C' uses no atomics: three runs on the same inputs, at the
    chunk-16 call of the transformer path and beside it, give equal bits."""
    q, k, v, dout = _qkv(Z, T, hd, BF16, dev, seed=3, n=4)
    runs = [attention_fused.flash_attention_bwd(q, k, v, dout)
            for _ in range(3)]
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_attention_function_matches_autograd_of_plain(dev, dtype):
    """The autograd.Function (kernel C forward, C' backward) against
    autograd through attention_plain, as torch.autograd.gradcheck would
    hold it (float64 is not a type the kernels take)."""
    Z, T, hd = 4, 33, 16
    q, k, v, wgt = _qkv(Z, T, hd, dtype, dev, seed=5, n=4)

    def grads(fn):
        qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        loss = (fn(*qs).float() * wgt.float()).sum()
        return torch.autograd.grad(loss, qs)

    n0 = attention_fused.launches_bwd
    got = grads(attention_fused.flash_attention)
    assert attention_fused.launches_bwd == n0 + 1
    want = grads(attention_fused.attention_plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **_attn_tol(dtype))


def test_attention_kernel_rejects_bad_input(dev):
    q, k, v = _qkv(2, 8, 8, F32, dev)
    with pytest.raises(TypeError):
        attention_fused.flash_attention(q, k.to(BF16), v)
    with pytest.raises(ValueError):
        attention_fused.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2))
    empty = torch.zeros((1, 0, 8), device=dev)
    with pytest.raises(ValueError):
        attention_fused.flash_attention(empty, empty, empty)
    wide = torch.zeros((1, 8, attention_fused.HD_MAX + 8), device=dev)
    with pytest.raises(ValueError):
        attention_fused.flash_attention(wide, wide, wide)


@pytest.mark.parametrize("dtype,tol", [
    (F32, dict(rtol=1e-4, atol=1e-4)),
    # bf16 weights: the card's matrix products and the kernels sum in
    # another order than the CPU's, one bf16 rounding per layer output
    (BF16, dict(rtol=5e-2, atol=5e-2)),
])
def test_esm2_tiny_on_card_matches_cpu(dev, dtype, tol):
    """A tiny ESM2 (2 layers, dim 32, 4 heads): pseudo-log-likelihood and
    its input gradient on the card (kernels C, C') against the CPU."""
    esm2.CONFIGS["tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
    params = esm2.init(torch.Generator().manual_seed(0), "tiny", dtype=dtype,
                       scale=0.2)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, 24, (3, 21)))
    x = torch.nn.functional.one_hot(toks, esm2.ESM_VOCAB).float()

    def pll_and_grad(p, xin):
        xg = xin.clone().requires_grad_(True)
        y = esm2.pseudo_log_likelihood(p, xg, heads=4)
        (g,) = torch.autograd.grad(y.sum(), xg)
        return y.detach(), g

    y0, g0 = pll_and_grad(params, x)
    n_f, n_b = attention_fused.launches_fwd, attention_fused.launches_bwd
    on_card = esm2._map_leaves(params, lambda _, a: a.to(dev))
    y1, g1 = pll_and_grad(on_card, x.to(dev))
    assert attention_fused.launches_fwd == n_f + 2
    assert attention_fused.launches_bwd == n_b + 2
    torch.testing.assert_close(y1.cpu(), y0, **tol)
    torch.testing.assert_close(g1.cpu(), g0, **tol)


# ---------------------------------------------------------------------------
# the q scale, rotary and head-major layout between the projections and C
# ---------------------------------------------------------------------------

def _projections(B, T, H, hd, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((B, T, H * hd), generator=g, device=dev) * 2.0).to(
        dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [20, 10])
@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("T", [1, 237, 400, 1022])
@pytest.mark.parametrize("hd", [24, 32, 64])
def test_qkv_rotary_kernels_equal_the_composition(dev, hd, T, B, H, dtype):
    """Transformer-S / -M / -L head widths, all heads and half of them (tp
    2), GFP's length and longer, one sequence and the 128-chain piece: the
    forward kernel's q', k', v and the backward kernel's gradients equal the
    plain composition's bit for bit, one launch each."""
    q, k, v = _projections(B, T, H, hd, dtype, dev, seed=T + hd + H)
    cos, sin = esm2._rotary_tables(T, hd, dtype, q.device)
    s = 1.0 / math.sqrt(hd)
    n0 = (rotary_fused.launches_fwd, rotary_fused.launches_bwd)
    got = rotary_fused.qkv_rotary(q, k, v, cos, sin, H, s)
    cot = [t.reshape(B, H, T, hd) for t in _projections(
        B, T, H, hd, dtype, dev, seed=B + T)]
    got_b = rotary_fused.qkv_rotary_bwd(*cot, cos, sin, s)
    assert (rotary_fused.launches_fwd, rotary_fused.launches_bwd) == (
        n0[0] + 1, n0[1] + 1)
    torch.cuda.synchronize()
    want = rotary_fused.qkv_rotary_plain(q, k, v, cos, sin, H, s)
    for a, b, name in zip(got, want, "qkv"):
        assert a.shape == (B, H, T, hd) and a.is_contiguous()
        assert torch.equal(a, b), name
    del got, want
    want_b = rotary_fused.qkv_rotary_bwd_plain(*cot, cos, sin, s)
    for a, b, name in zip(got_b, want_b, "qkv"):
        assert a.shape == (B, T, H * hd) and a.is_contiguous()
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [8, 24, 40, 48])
def test_qkv_rotary_function_is_autograd_of_the_composition(dev, dtype, hd):
    """The autograd.Function (forward kernel, backward kernel) against
    autograd through the plain composition, bit for bit, at the head widths
    whose halves are not whole 16-byte vectors in bf16 (8, 24, 40) and one
    that is (48)."""
    B, T, H = 3, 37, 4
    ins = _projections(B, T, H, hd, dtype, dev, seed=hd)
    cos, sin = esm2._rotary_tables(T, hd, dtype, ins[0].device)
    cot = [t.reshape(B, H, T, hd)
           for t in _projections(B, T, H, hd, dtype, dev, seed=hd + 1)]

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*xs, cos, sin, H, 1.0 / math.sqrt(hd))
        return out, torch.autograd.grad(out, xs, cot)

    n0 = rotary_fused.launches_bwd
    out, got = grads(rotary_fused.qkv_rotary)
    assert rotary_fused.launches_bwd == n0 + 1
    out0, want = grads(rotary_fused.qkv_rotary_plain)
    for a, b in zip((*out, *got), (*out0, *want)):
        assert torch.equal(a, b)


def _plain_glue(monkeypatch):
    """ESM2's attention with the plain composition in place of the
    kernels, as it ran before them."""
    monkeypatch.setattr(rotary_fused, "qkv_rotary",
                        rotary_fused.qkv_rotary_plain)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,dim", [("S", 480), ("M", 640), ("L", 1280)])
def test_esm2_layer_input_gradient_equals_the_composition(
        dev, monkeypatch, name, dim, dtype, remat):
    """One whole ESM2 layer at transformer-S / -M / -L widths, 16 sequences
    of GFP's length: the pseudo-log-likelihood and its gradient to the
    one-hot input through the kernels equal those through the composition
    bit for bit (under remat too, which recomputes the forward)."""
    monkeypatch.setitem(esm2.CONFIGS, "one", dict(layers=1, dim=dim,
                                                  heads=20, ffn=4 * dim))
    params = esm2.init(torch.Generator(device=dev).manual_seed(dim), "one",
                       dtype=dtype, scale=0.05)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(4, 24, (16, 237), generator=g, device=dev)
    x = torch.nn.functional.one_hot(toks, esm2.ESM_VOCAB).float()

    def pll_and_grad():
        xg = x.clone().requires_grad_(True)
        y = esm2.pseudo_log_likelihood(params, xg, 20, remat=remat)
        (gx,) = torch.autograd.grad(y.sum(), xg)
        return y, gx

    n0 = (rotary_fused.launches_fwd, rotary_fused.launches_bwd)
    y1, g1 = pll_and_grad()
    assert (rotary_fused.launches_fwd, rotary_fused.launches_bwd) == (
        n0[0] + 1 + remat, n0[1] + 1)
    _plain_glue(monkeypatch)
    y0, g0 = pll_and_grad()
    assert (rotary_fused.launches_fwd, rotary_fused.launches_bwd) == (
        n0[0] + 1 + remat, n0[1] + 1)
    assert torch.equal(y1, y0)
    assert torch.equal(g1, g0)


def test_esm_cell_energy_and_gradient_equal_the_composition(dev,
                                                            monkeypatch):
    """The benchmark's ESM cell at its sizes: potts + CNN + ESM2-150M in
    bf16 (30 layers, one piece) at GFP, 128 chains of the wild type with
    random mutations: energy, fitness and gradient through the kernels equal
    those through the composition bit for bit; the kernels run once a layer
    each way."""
    from ppde_tpu_torch import codec, energy
    from ppde_tpu_torch.models import potts

    wt = (
        "SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTLSYGV"
        "QCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGN"
        "ILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLS"
        "TQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK")
    L = len(wt)
    tr = esm2.load_expert("transformer-M", wt, allow_random=True, dtype=BF16,
                          device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(0), 3,
                            input_size=L)
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt])).to(dev)
    en = energy.protein_poe(potts.synthetic(wt, seed=0, device=dev), ens,
                            1.0, wt_oh, transformer=tr)
    rng = np.random.default_rng(2)
    x = wt_oh.repeat(128, 1, 1)
    for i in range(128):
        pos = rng.choice(L, 4, replace=False)
        x[i, pos] = torch.eye(20, device=dev)[rng.integers(0, 20, 4)]

    def call():
        with torch.no_grad():
            return en.energy_and_grad(en.params, x)

    n0 = (rotary_fused.launches_fwd, rotary_fused.launches_bwd)
    m0 = (layer_norm_fused.launches_fwd, layer_norm_fused.launches_bwd)
    got = call()
    assert (rotary_fused.launches_fwd, rotary_fused.launches_bwd) == (
        n0[0] + 30, n0[1] + 30)
    # the norms: two a layer and the head's two, each way
    assert (layer_norm_fused.launches_fwd, layer_norm_fused.launches_bwd) \
        == (m0[0] + 2 * 30 + 2, m0[1] + 2 * 30 + 2)
    _plain_glue(monkeypatch)
    want = call()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_qkv_rotary_rejects_bad_input(dev):
    B, T, H, hd = 2, 9, 4, 8
    q, k, v = _projections(B, T, H, hd, F32, dev, seed=0)
    cos, sin = esm2._rotary_tables(T, hd, F32, q.device)
    s = 1.0 / math.sqrt(hd)
    with pytest.raises(ValueError):  # tables on another device
        rotary_fused.qkv_rotary(q, k, v, cos.cpu(), sin.cpu(), H, s)
    with pytest.raises(TypeError):  # float16
        rotary_fused.qkv_rotary(q.half(), k.half(), v.half(), cos.half(),
                                sin.half(), H, s)
    with pytest.raises(TypeError):  # mixed types
        rotary_fused.qkv_rotary(q, k.to(BF16), v, cos, sin, H, s)
    with pytest.raises(ValueError):  # not contiguous
        rotary_fused.qkv_rotary(*(t.transpose(0, 1).contiguous().transpose(
            0, 1) for t in (q, k, v)), cos, sin, H, s)
    for n in (12, 72):  # hd not a multiple of 8, or above 64
        qn, kn, vn = _projections(B, T, 1, n, F32, dev, seed=n)
        cn, sn = esm2._rotary_tables(T, n, F32, q.device)
        with pytest.raises(ValueError):
            rotary_fused.qkv_rotary(qn, kn, vn, cn, sn, 1, s)
    with pytest.raises(ValueError):  # heads that do not divide the width
        rotary_fused.qkv_rotary(q, k, v, cos, sin, 3, s)
    with pytest.raises(ValueError):  # cotangents of another width
        rotary_fused.qkv_rotary_bwd(*(t.reshape(B, H, T, hd)[..., :4]
                                      .contiguous() for t in (q, k, v)),
                                    cos, sin, s)


# ---------------------------------------------------------------------------
# training: kernels C and C' at finetune_esm's shapes, one trainer step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("Z,T,hd", [(640, 237, 24), (640, 237, 64),
                                    (640, 238, 24), (640, 238, 64)])
def test_attention_kernels_at_finetune_shapes(dev, dtype, Z, T, hd):
    """A batch of 32 sequences of GFP length (T = 237; 238 with one more
    token) at transformer-S (hd 24) and -L (hd 64)."""
    q, k, v, dout = _qkv(Z, T, hd, dtype, dev, seed=Z + T + hd, n=4)
    o = attention_fused.flash_attention(q, k, v)
    got = attention_fused.flash_attention_bwd(q, k, v, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        o.float(), attention_fused.attention_plain(q, k, v).float(),
        **_attn_tol(dtype))
    for a, b in zip(got, attention_fused.attention_bwd_plain(q, k, v,
                                                             dout)):
        torch.testing.assert_close(a.float(), b.float(), **_attn_tol(dtype))


def test_esm_mlm_step_on_card_matches_cpu(dev):
    """One bf16 masked-LM loss and its weight gradient of a tiny ESM2 on
    the card (kernels C, C') against the CPU's plain path, within the
    bf16 bound of test_esm2_tiny_on_card_matches_cpu (of each leaf's
    largest gradient); then two trainer steps on the card from the same
    draws: C and C' once a layer a step, losses within the same bound."""
    from ppde_tpu_torch import training

    esm2.CONFIGS["tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
    params = esm2.init(torch.Generator().manual_seed(0), "tiny",
                       dtype=F32, scale=0.2)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(4, 24, (4, 21)))
    is_sel = torch.from_numpy(rng.random((4, 21)) < 0.3)
    corrupt = torch.where(is_sel, esm2.MASK_IDX, tok)

    def loss_and_grads(p, device):
        p = esm2._map_leaves(p, lambda _, a: a.to(device).requires_grad_())
        loss = training.esm_mlm_loss(p, tok.to(device), corrupt.to(device),
                                     is_sel.to(device), 4, BF16)
        return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(
            loss, esm2._flatten(p))]

    l0, g0 = loss_and_grads(params, "cpu")
    n_f, n_b = attention_fused.launches_fwd, attention_fused.launches_bwd
    l1, g1 = loss_and_grads(params, dev)
    assert attention_fused.launches_fwd == n_f + 2
    assert attention_fused.launches_bwd == n_b + 2
    torch.testing.assert_close(l1, l0, rtol=5e-2, atol=5e-2)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=5e-2,
                                   atol=5e-2 * float(b.abs().max()))

    class Fixed:
        """The same batch each step on ``device``: rows 0-3, the selected
        positions all <mask>."""

        def __init__(self, device):
            self.device, self.first = device, False

        def rows(self, weights, n):
            return torch.arange(n, device=self.device)

        def uniform(self, shape):  # selection, then the 80/10/10 draw
            self.first = not self.first
            u = (~is_sel).float() if self.first else torch.zeros(shape)
            return u.to(self.device)

        def randint(self, high, shape):
            return torch.zeros(shape, dtype=torch.long, device=self.device)

    losses = {}
    for device in ("cpu", dev):
        n_f, n_b = attention_fused.launches_fwd, attention_fused.launches_bwd
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            training.train_esm_mlm(tok.numpy(), name="tiny", params=params,
                                   n_iters=2, batch_size=4, lr=1e-3,
                                   warmup=1, log_every=1, chunk=1,
                                   device=device, draws=Fixed(device))
        losses[str(device)] = torch.tensor([float(v) for v in re.findall(
            r"ce (\S+)", buf.getvalue())])
        assert len(losses[str(device)]) == 2
        if device is dev:
            assert attention_fused.launches_fwd == n_f + 4
            assert attention_fused.launches_bwd == n_b + 4
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("weighted", [False, True])
def test_esm_mlm_steps_do_not_sync(dev, weighted, monkeypatch):
    """Quiet trainer steps after the first queue on the device with no
    host sync (the loss goes to the host only where it is printed), rows
    drawn uniformly and by sequence weights."""
    from ppde_tpu_torch import training

    esm2.CONFIGS["tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 24, (16, 21))
    w = rng.uniform(0.1, 1.0, 16) if weighted else None
    step = training.Adam.step

    def strict(self, grads):  # from the end of the first step on
        step(self, grads)
        torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(training.Adam, "step", strict)
    try:
        training.train_esm_mlm(toks, name="tiny", n_iters=3, batch_size=4,
                               quiet=True, device=dev, seq_weights=w)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# the directed-evolution run on the card
# ---------------------------------------------------------------------------

CLI_WT = "MKTAYIAKQRQISFVKSHFSRQLEERLGLI"  # 30 residues


@pytest.fixture(scope="module")
def protein_root(tmp_path_factory):
    from ppde_tpu_torch.scripts import seeded_protein

    root = str(tmp_path_factory.mktemp("weights"))
    seeded_protein.write_protein_dir(root, "P", CLI_WT, seed=0)
    return root


@pytest.mark.parametrize("sampler,extra", [
    ("PPDE", ()), ("PPDE", ("--compute_dtype", "bf16")),
    ("PPDE-PT", ("--compute_dtype", "bf16", "--pt_levels", "4"))])
def test_cli_launches_a_and_b_on_every_step(dev, protein_root, tmp_path,
                                            sampler, extra):
    """A tiny CLI run on the card: one launch of kernel A and one of kernel
    B per step (and one for the initial state); the wild-type energy line,
    the oracle and the artifacts need no kernel."""
    from ppde_tpu_torch.scripts import directed_evolution as de

    steps = 6
    args = de.build_parser().parse_args([
        "--protein_weights", protein_root, "--protein", "P",
        "--results_path", str(tmp_path), "--n_iters", str(steps),
        "--n_chains", "8", "--log_every", "3", "--nmut_threshold", "4",
        "--energy_lamda", "3", "--disable_MSA_transformer_scoring",
        "--sampler", sampler, *extra])
    assert args.device == "cuda"
    a0, b0 = potts_fused.launches, cnn_fused.launches
    run_dir = de.main(args)
    assert potts_fused.launches - a0 == steps + 1
    assert cnn_fused.launches - b0 == steps + 1
    e = np.load(run_dir / "energy_scores.npy")
    assert e.shape == (8,) and np.isfinite(e).all()


def _sampler_setup(dev, protein_root):
    import types

    from ppde_tpu_torch import runtime

    args = types.SimpleNamespace(
        protein_weights=protein_root, protein="P",
        energy_function="product_of_experts", unsupervised_expert="potts",
        energy_lamda=3.0, n_chains=8, compute_dtype="bf16")
    en, _, pp, _ = runtime.build_protein_energy(args, dev)
    pop = runtime.make_initial_protein_population(
        f"{protein_root}/P", 8, dev)
    return en, pop, pp


def _no_sync(fn, n=4):
    """Call fn n times with PyTorch's sync debugging set to raise on any
    operation that waits for the device (.item(), a copy to the host,
    nonzero, ...)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_sa_and_pt_steps_do_not_sync(dev, protein_root):
    """Steps of SA (device generator: Poisson, Gumbel, randint, uniform)
    and of PPDE-PT queue on the card with no host synchronisation."""
    from ppde_tpu_torch import utils
    from ppde_tpu_torch.samplers import base
    from ppde_tpu_torch.samplers.protein import pt, sa

    en, pop, pp = _sampler_setup(dev, protein_root)
    n, L, V = pop.shape
    draws = base.Draws(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        e0, f0 = en.energy(en.params, pop)
        mu = 1.5 * draws.uniform(n) + 1.0
        ctx = {"energy": en.params, "wt": pop[0], "init_x": pop, "mu": mu}
        sa_step = sa.make_step(en, sa.SAConfig(temp=1.0, nmut_threshold=4),
                               pp.min_pos, pp.max_pos, n)
        state = [(pop, e0, f0, 0, (e0, f0, pop))]

        def one_sa():
            state[0], _ = sa_step(ctx, state[0], draws)

        _no_sync(one_sa)
        assert state[0][3] == 4

        cfg = pt.PTConfig(nmut_threshold=4, n_levels=4)
        window_ok = utils.position_window_mask(L, V, pp.min_pos, pp.max_pos,
                                               dev)
        e0, f0, g0 = en.energy_and_grad(en.params, pop)
        pctx = {"energy": en.params, "wt": pop[0], "init_x": pop,
                "beta": torch.from_numpy(pt.ladder(n, cfg)).to(dev),
                "wt_e": e0[0], "wt_fit": f0[0], "wt_grad": g0[0]}
        pt_step = pt.make_pt_step(en, cfg, window_ok, n, L, V)
        pstate = [((pop, (e0, f0, g0), (e0, f0, pop)), 0)]

        def one_pt():
            pstate[0], _ = pt_step(pctx, pstate[0], draws)

        _no_sync(one_pt)
        assert pstate[0][1] == 4


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_ppde_resume_is_bit_exact_on_card(dev, protein_root, tmp_path, cdt):
    """The protein PPDE path on the card (kernels A and B), cut after 4 of
    8 steps with --checkpoint_dir and resumed: the uncut run's artifacts
    bit for bit, A and B launched in both halves."""
    from ppde_tpu_torch.scripts import directed_evolution as de

    def run(results, steps, *ck):
        args = de.build_parser().parse_args([
            "--protein_weights", protein_root, "--protein", "P",
            "--results_path", str(tmp_path / results), "--n_iters",
            str(steps), "--n_chains", "8", "--log_every", "2",
            "--nmut_threshold", "4", "--energy_lamda", "3",
            "--disable_MSA_transformer_scoring", "--compute_dtype", cdt,
            *ck])
        a0, b0 = potts_fused.launches, cnn_fused.launches
        run_dir = de.main(args)
        assert potts_fused.launches > a0 and cnn_fused.launches > b0
        return run_dir
    ref = run("ref", 8)
    ck = ("--checkpoint_dir", str(tmp_path / "ck"))
    run("cut", 4, *ck)
    got = run("resumed", 8, *ck)
    for f in ("population.npy", "energy_scores.npy", "pred_fitness_scores.npy",
              "oracle_fitness_scores.npy", "energy_history.npy",
              "fitness_history.npy"):
        np.testing.assert_array_equal(np.load(got / f), np.load(ref / f),
                                      err_msg=f)


@pytest.mark.parametrize("B", [37, 128, 1024])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_potts_column_blocks_match_plain(dev, dtype, tp, B):
    """Kernel A on every column block of the couplings (GFP's P = 4864,
    re-padded to a multiple of 128 tp: 4864 for tp = 2, 5120 for tp = 4),
    each against the plain block function; the blocks assembled (gradients
    side by side, energy shares summed in order) against the whole call;
    rows with a single 1 give the block's W[k] + h bit for bit; the block
    (0, P) through ``col0`` is the whole call, bit for bit."""
    from ppde_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(tp * 1000 + B)
    L = 243  # 243 * 20 = 4860 -> P = 4864
    W, h, P = _potts(rng, L, dtype, dev)
    xf = torch.nn.functional.pad(_onehot(rng, B, L, dev).reshape(B, -1),
                                 (0, P - L * 20)).to(BF16)
    H, g = potts_fused.energy_and_grad(W, h, xf)
    H1, g1 = potts_fused.energy_and_grad(W, h, xf, col0=0)
    assert torch.equal(H, H1) and torch.equal(g, g1)
    shares, grads = [], []
    for r in range(tp):
        Wb, hb, c0 = pmesh.potts_column_block(W, h, tp, r)
        Pp, N = Wb.shape
        assert Pp % (128 * tp) == 0 and N * tp == Pp and c0 == r * N
        xfp = torch.nn.functional.pad(xf, (0, Pp - P))
        n0 = potts_fused.launches
        Hs, gb = potts_fused.energy_and_grad(Wb, hb, xfp, c0)
        assert potts_fused.launches == n0 + 1 and gb.shape == (B, N)
        Hs0, gb0 = potts_fused.energy_and_grad_plain(Wb, hb, xfp.to(dtype),
                                                     c0)
        torch.testing.assert_close(gb, gb0, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(Hs, Hs0, rtol=1e-5, atol=1e-3)
        shares.append(Hs)
        grads.append(gb)
        if dtype == F32 and B == 128:
            k = torch.from_numpy(rng.choice(Pp, 128, replace=False)).to(dev)
            rows = torch.nn.functional.one_hot(k, Pp).to(BF16)
            _, ge = potts_fused.energy_and_grad(Wb, hb, rows, c0)
            assert torch.equal(ge, Wb[k] + hb)
    Hsum = shares[0]
    for s in shares[1:]:
        Hsum = Hsum + s
    torch.testing.assert_close(torch.cat(grads, 1)[:, :P], g, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(Hsum, H, rtol=1e-5, atol=1e-3)


def test_potts_block_rejects_what_it_does_not_take(dev):
    W = torch.zeros((256, 256), device=dev)
    prep = potts_fused.prepare(W[:, :128].contiguous(),
                               torch.zeros(128, device=dev))
    xf = torch.zeros((4, 256), device=dev, dtype=BF16)
    for col0 in (64, 256, -128):  # not a tile's start, or past the end
        with pytest.raises(ValueError):
            potts_fused.energy_and_grad(prep, None, xf, col0)
    with pytest.raises(ValueError):  # more columns than rows
        potts_fused.prepare(torch.zeros((128, 256), device=dev),
                            torch.zeros(256, device=dev))


# ---------------------------------------------------------------------------
# the kernel wrappers' spans in a traced energy call
# ---------------------------------------------------------------------------

# the kernels each wrapper launches (csrc/*.cu), by name fragment, under the
# span that holds the launch
WRAPPER_KERNELS = {
    "kernel.a": ("potts_grad_kernel_wgmma", "potts_finish"),
    "kernel.b": ("fit_grad_kernel", "cnn_member_reduce", "tokens_kernel",
                 "wide::fwd_", "wide::bwd_"),
    "kernel.c": ("attn_fwd_",),
    "kernel.c_bwd": ("attn_bwd_",),
    "esm2.rotary": ("qkv_rotary_fwd",),
    "esm2.bwd.rotary": ("qkv_rotary_bwd",),
}


@pytest.mark.parametrize("L", [237, 400, 1022])
def test_traced_energy_books_every_kernel_under_its_span(dev, tmp_path, L):
    """potts + CNN (C = L, float32: ``simt`` at 237, ``wide`` past 256) +
    a tiny bf16 ESM2 (C, C' ``rs`` at 237, ``kt`` past 256), 8 chains:
    every kernel of A, B, C and C' in the traced call was launched inside
    its wrapper's span, and the qkv / rotary kernels inside ``esm2.rotary``
    and ``esm2.bwd.rotary`` (no launch call lost), the trace holds each
    one's launches, and the untraced call launched the same kernels and
    gave the same bits."""
    from ppde_tpu_torch import codec, energy, profiling
    from ppde_tpu_torch.models import potts

    rng = np.random.default_rng(L)
    wt = "".join(np.array(list(codec.ALPHABET))[rng.integers(0, 20, L)])
    esm2.CONFIGS["tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
    tr = esm2.load_expert("tiny", wt, allow_random=True, dtype=BF16,
                          device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(L), 3,
                            input_size=L)
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt])).to(dev)
    en = energy.protein_poe(potts.synthetic(wt, seed=L, device=dev), ens,
                            2.0, wt_oh, transformer=tr)
    x = _onehot(rng, 8, L, dev)

    def call():
        before = profiling.counters()
        with torch.no_grad():
            out = en.energy_and_grad(en.params, x)
        torch.cuda.synchronize()
        after = profiling.counters()
        return out, {k: after[k] - before[k] for k in after}

    call()  # first launches, prepared weights
    off, n_off = call()
    with profiling.trace(str(tmp_path)):
        on, n_on = call()
    assert n_on == n_off
    assert n_off["potts_energy"] == n_off["cnn_ensemble"] == 1
    assert n_off["cnn_ensemble_wide"] == int(L > 256)
    assert n_off["flash_attention_fwd"] == n_off["flash_attention_bwd"] == 2
    assert n_off["qkv_rotary_fwd"] == n_off["qkv_rotary_bwd"] == 2
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    spans = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == name] for name in WRAPPER_KERNELS}
    found = dict.fromkeys(WRAPPER_KERNELS, 0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        span = next((s for s, frags in WRAPPER_KERNELS.items()
                     if any(f in e["name"] for f in frags)), None)
        if span is None:
            continue
        t = launch.get(e["args"]["correlation"])
        assert t is not None, f"the trace lost the launch of {e['name']}"
        assert any(a <= t <= b for a, b in spans[span]), (span, e["name"])
        found[span] += 1
    assert all(n > 0 for n in found.values()), found
    by_span = profiling.device_by_span(str(tmp_path))
    assert by_span["unmatched"] == 0
    for span, n in found.items():
        assert by_span[span]["kernels"] >= n


# ---------------------------------------------------------------------------
# kernels T and T' (tied row attention) and the MSA Transformer expert
# ---------------------------------------------------------------------------

def _rows(shape, dtype, dev, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (rng.standard_normal(shape) * 0.5).astype(np.float32)).to(dev, dtype)
        for _ in range(n)]


def _row_tol(dtype, ref):
    # float32: sums over R hd and over the columns in another order; bf16:
    # one rounding of w and ds, and the products' bf16 outputs, against
    # the largest output (the sums run over C columns of weights ~1 / C)
    big = float(ref.float().abs().max())
    return (dict(rtol=1e-4, atol=1e-5 * max(big, 1.0)) if dtype == F32
            else dict(rtol=3e-2, atol=2e-2 * max(big, 1e-3)))


# (N, R, C, H, hd): the msa-1b cell's layer at 2 chains (the register
# kernels at C = 238), strips and groups cut by odd C, the SIMT kernels
# (hd 24, C past 256, and every float32 call)
ROW_SHAPES = [(2, 32, 238, 12, 64), (3, 5, 37, 3, 16), (1, 3, 65, 2, 32),
              (2, 2, 256, 1, 48), (2, 3, 9, 2, 24), (1, 2, 300, 2, 32)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ROW_SHAPES, ids=str)
def test_row_attention_kernels_match_plain(dev, dtype, shape):
    q, k, v, dout = _rows(shape, dtype, dev, seed=shape[2], n=4)
    scale = 1.0 / (math.sqrt(shape[4]) * math.sqrt(shape[1]))
    n0 = (row_attention_fused.launches_fwd, row_attention_fused.launches_bwd)
    o = row_attention_fused.tied_row_attention(q, k, v, scale)
    got = row_attention_fused.tied_row_attention_bwd(q, k, v, dout, scale)
    assert (row_attention_fused.launches_fwd,
            row_attention_fused.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    torch.cuda.synchronize()
    o0 = row_attention_fused.tied_row_attention_plain(q, k, v, scale)
    torch.testing.assert_close(o.float(), o0.float(), **_row_tol(dtype, o0))
    want = row_attention_fused.tied_row_attention_bwd_plain(q, k, v, dout,
                                                            scale)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.float(), b.float(), msg=lambda m: (
            f"{name}: {m}"), **_row_tol(dtype, b))
    # no atomics: both directions repeat bit for bit
    assert torch.equal(o, row_attention_fused.tied_row_attention(q, k, v,
                                                                 scale))
    again = row_attention_fused.tied_row_attention_bwd(q, k, v, dout, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_row_attention_function_is_autograd_of_plain(dev, dtype):
    """The autograd Function's gradients are T''s, and close to autograd's
    through the plain version."""
    shape = (2, 4, 40, 2, 32)
    q, k, v, dout = _rows(shape, dtype, dev, seed=7, n=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = row_attention_fused.tied_row_attention(*leaves, 0.2)
    grads = torch.autograd.grad(o, leaves, dout)
    bwd = row_attention_fused.tied_row_attention_bwd(q, k, v, dout, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd))
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o0 = row_attention_fused.tied_row_attention_plain(*plain, 0.2)
    for a, b in zip(grads, torch.autograd.grad(o0, plain, dout)):
        torch.testing.assert_close(a.float(), b.float(), **_row_tol(dtype, b))


def test_row_attention_rejects_bad_input(dev):
    q = torch.zeros((1, 2, 8, 2, 16), device=dev, dtype=BF16)
    f = row_attention_fused.tied_row_attention
    with pytest.raises(ValueError):  # not contiguous
        f(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), 1.0)
    with pytest.raises(TypeError):  # mixed types
        f(q, q.float(), q, 1.0)
    with pytest.raises(ValueError):  # hd past 64
        z = torch.zeros((1, 2, 8, 1, 72), device=dev, dtype=BF16)
        f(z, z, z, 1.0)
    with pytest.raises(ValueError):  # C past 2,048
        z = torch.zeros((1, 2, 2049, 1, 16), device=dev, dtype=BF16)
        f(z, z, z, 1.0)
    with pytest.raises(ValueError, match="scratch"):  # 9.4 GiB of scores
        z = torch.zeros((1, 2, 2048, 600, 8), device=dev, dtype=F32)
        f(z, z, z, 1.0)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_attention_kernels_at_the_msa_column_shape(dev, dtype):
    """Kernels C and C' where the msa-1b cell's column attention runs them:
    Z = 2 chains x 238 columns x 12 heads, T = 32 rows, hd 64."""
    q, k, v, dout = _qkv(2 * 238 * 12, 32, 64, dtype, dev, seed=32, n=4)
    o = attention_fused.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), attention_fused.attention_plain(
        q, k, v).float(), **_attn_tol(dtype))
    got = attention_fused.flash_attention_bwd(q, k, v, dout)
    want = attention_fused.attention_bwd_plain(q, k, v, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **_attn_tol(dtype))


def _msa_energy(dev, name, L, rows, n_chains, dtype=BF16, chunk=None,
                remat=False):
    from ppde_tpu_torch import codec, energy
    from ppde_tpu_torch.models import msa_transformer as msat

    rng = np.random.default_rng(L)
    letters = np.array(list(codec.ALPHABET))
    wt = "".join(letters[rng.integers(0, 20, L)])
    ctx = ["".join(letters[rng.integers(0, 20, L)]) for _ in range(rows - 1)]
    tr = msat.load_expert(name, wt, ctx, allow_random=True, dtype=dtype,
                          remat=remat, device=dev)
    ens = cnn.init_ensemble(torch.Generator(device=dev).manual_seed(L), 3,
                            input_size=L)
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt])).to(dev)
    en = energy.protein_poe(None, ens, 1.0, wt_oh, transformer=tr,
                            chunk_size=chunk)
    return en, _onehot(rng, n_chains, L, dev)


@pytest.mark.parametrize("chunk", [None, 2])
def test_msa_expert_counts_its_kernels_per_layer(dev, chunk):
    """One energy call of an msa-S expert (4 layers, hd 32) over 5 chains:
    kernels T, T', C and C' once a layer and a piece each way."""
    from ppde_tpu_torch import profiling

    en, x = _msa_energy(dev, "msa-S", 30, 4, 5, chunk=chunk)
    before = profiling.counters()
    with torch.no_grad():
        e, _, g = en.energy_and_grad(en.params, x)
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in profiling.counters().items()}
    want = 4 * (1 if chunk is None else 3)
    assert n["row_attention_fwd"] == n["row_attention_bwd"] == want
    assert n["flash_attention_fwd"] == n["flash_attention_bwd"] == want
    # the norms: three a layer, row 0's embedding norm, the head's two
    assert n["layer_norm_fwd"] == n["layer_norm_bwd"] == (3 * 4 + 3) * (
        want // 4)
    assert torch.isfinite(e).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_msa_expert_on_the_card_equals_its_plain_composition(
        dev, monkeypatch, dtype, remat):
    """The msa-S expert's energy and gradient with kernels T, T', C, C'
    against the same energy with their plain versions monkeypatched in,
    on the card (float32: the sums' order; bf16: the kernels' roundings
    of w and ds against the largest value)."""
    en, x = _msa_energy(dev, "msa-S", 40, 6, 3, dtype=dtype, remat=remat)
    with torch.no_grad():
        e, _, g = en.energy_and_grad(en.params, x)
    monkeypatch.setattr(row_attention_fused, "tied_row_attention",
                        row_attention_fused.tied_row_attention_plain)
    monkeypatch.setattr(attention_fused, "flash_attention",
                        attention_fused.attention_plain)
    with torch.no_grad():
        e0, _, g0 = en.energy_and_grad(en.params, x)
    tol = 1e-4 if dtype == F32 else 3e-2
    assert float((e - e0).abs().max()) <= tol * max(
        1.0, float(e0.abs().max()))
    assert float((g - g0).norm() / g0.norm()) <= tol


# ---------------------------------------------------------------------------
# the layer-norm kernels
# ---------------------------------------------------------------------------

# [..., D]: the ESM2-150M cell's norm (128 chains of GFP's 237 positions),
# the 35M cell's (512 chains), a piece of the msa-1b cell's stream (26
# chains, 32 rows, 238 columns), transformer-L's width, rows that are not
# a multiple of a block's 8, ESM2-tiny's width
LN_SHAPES = [(128, 237, 640), (512, 237, 480), (26, 32, 238, 768),
             (128, 237, 1280), (1001, 640), (3, 5, 32)]


def _ln_inputs(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    D = shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2.0
         + torch.randn(shape[:-1] + (1,), generator=g, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    return (x, dy, 1.0 + 0.3 * torch.randn(D, generator=g, device=dev),
            0.2 * torch.randn(D, generator=g, device=dev))


def _ln_close(got, want, dtype, scale=1.0):
    """The kernels sum in float32 in another order than F.layer_norm and
    its backward, then round once to x's type as the composition does: in
    bf16 at most a unit in the last place (2**-7 of the larger value), in
    float32 a few float32 roundings; an absolute floor of 1e-5 of the
    output's scale where the two land on either side of 0."""
    rtol = 2.0 ** -7 if dtype == BF16 else 1e-5
    a, b = got.float(), want.float()
    err = (a - b).abs()
    assert bool((err <= rtol * a.abs().maximum(b.abs())
                 + 1e-5 * scale).all()), float(err.max())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_kernels_match_the_composition(dev, shape, dtype):
    """y, dx, and g's and b's gradients (asked for, and not) against the
    plain composition and autograd through it; one launch each way a
    call."""
    x, dy, g, b = _ln_inputs(shape, dtype, dev, seed=sum(shape))
    xs = [t.clone().requires_grad_(True) for t in (x, g, b)]
    n0 = (layer_norm_fused.launches_fwd, layer_norm_fused.launches_bwd)
    y = layer_norm_fused.layer_norm(*xs)
    got = torch.autograd.grad(y, xs, dy)
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(layer_norm_fused.layer_norm(xg, g, b), xg,
                                dy)
    assert (layer_norm_fused.launches_fwd, layer_norm_fused.launches_bwd) \
        == (n0[0] + 2, n0[1] + 2)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == shape and y.is_contiguous()
    assert torch.equal(gx, got[0])  # dx alone or beside dg, db: one kernel
    xs0 = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y0 = layer_norm_fused.layer_norm_plain(*xs0)
    want = torch.autograd.grad(y0, xs0, dy)
    _ln_close(y, y0, dtype)
    _ln_close(got[0], want[0], dtype, float(want[0].float().abs().max()))
    for a, w in zip(got[1:], want[1:]):  # float32 sums over every row
        assert a.dtype == F32
        torch.testing.assert_close(a, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_layer_norm_kernels_repeat_bit_for_bit(dev, dtype):
    """The same inputs give the same bits, g's and b's gradients too (their
    partial sums are added in a fixed order)."""
    x, dy, g, b = _ln_inputs((4000, 640), dtype, dev, seed=1)

    def run():
        xs = [t.clone().requires_grad_(True) for t in (x, g, b)]
        y = layer_norm_fused.layer_norm(*xs)
        return (y, *torch.autograd.grad(y, xs, dy))

    for a, c in zip(run(), run()):
        assert torch.equal(a, c)


def test_layer_norm_takes_the_heads_strided_view(dev):
    """msa-1b's head normalizes row 0 of its stream, ``h[:, 0, 1:]``, a view
    whose rows do not lie one after the other: the wrapper copies it, and
    the gradient reaches h at those positions only."""
    h, _, g, b = _ln_inputs((3, 4, 9, 768), BF16, dev, seed=2)
    h.requires_grad_(True)
    view = h[:, 0, 1:]
    assert not view.is_contiguous()
    y = layer_norm_fused.layer_norm(view, g, b)
    assert torch.equal(y, layer_norm_fused.layer_norm(
        view.detach().contiguous(), g, b))
    _ln_close(y, layer_norm_fused.layer_norm_plain(view.detach(), g, b),
              BF16)
    (gh,) = torch.autograd.grad(y.float().square().sum(), h)
    assert torch.count_nonzero(gh[:, 1:]) == 0
    assert torch.count_nonzero(gh[:, 0, 0]) == 0
    assert torch.count_nonzero(gh[:, 0, 1:]) > 0


def test_layer_norm_rejects_bad_input(dev):
    x, _, g, b = _ln_inputs((6, 64), BF16, dev, seed=3)
    with pytest.raises(TypeError):  # float16
        layer_norm_fused.layer_norm(x.half(), g, b)
    with pytest.raises(TypeError):  # g, b not float32
        layer_norm_fused.layer_norm(x, g.to(BF16), b.to(BF16))
    with pytest.raises(ValueError):  # g, b on another device
        layer_norm_fused.layer_norm(x, g.cpu(), b.cpu())
    with pytest.raises(ValueError):  # D not a whole number of 16 bytes
        layer_norm_fused.layer_norm(x[:, :12].contiguous(), g[:12], b[:12])
    with pytest.raises(ValueError):  # past the widest row
        layer_norm_fused.layer_norm(torch.zeros(2, 4104, dtype=BF16,
                                                device=dev),
                                    torch.ones(4104, device=dev),
                                    torch.zeros(4104, device=dev))
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        flat = torch.zeros(6 * 64 + 1, dtype=BF16, device=dev)
        layer_norm_fused.layer_norm(flat[1:].view(6, 64), g, b)


def test_traced_esm2_books_its_norms_where_the_norms_are_booked(dev,
                                                                tmp_path):
    """A tiny bf16 ESM2's energy term and its gradient under the profiler:
    every forward launch of the layer-norm kernel lies in ``esm2.norm`` or
    ``esm2.head``, every backward one in ``esm2.bwd.norm`` or
    ``esm2.bwd.head`` (the kernel opens no span of its own), 2 x layers + 2
    of each."""
    from ppde_tpu_torch import profiling

    esm2.CONFIGS["tiny"] = dict(layers=2, dim=32, heads=4, ffn=64)
    wt = "ACDEFGHIKLMNPQRSTVWY" * 2
    params, apply_fn = esm2.load_expert("tiny", wt, allow_random=True,
                                        dtype=BF16, device=dev)
    rng = np.random.default_rng(0)
    x = _onehot(rng, 4, len(wt), dev)
    # as energy.protein_poe's transformer term takes its gradient
    with profiling.trace(str(tmp_path)), profiling.grad_spans():
        xg = profiling.grad_span(x.requires_grad_(True), None)
        y = apply_fn(params, xg)
        with profiling.span("esm2.backward"):
            torch.autograd.grad(y.sum(), xg)
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    found = {"ln_fwd_kernel": [], "ln_bwd_kernel": []}
    for e in events:
        kind = next((k for k in found if k in e["name"]), None)
        if e.get("cat") != "kernel" or kind is None:
            continue
        t = launch[e["args"]["correlation"]]
        inner = min(((b - a, n) for n, a, b in spans if a <= t <= b),
                    default=(0, None))[1]
        found[kind].append(inner)
    assert sorted(set(found["ln_fwd_kernel"])) == ["esm2.head", "esm2.norm"]
    assert sorted(set(found["ln_bwd_kernel"])) == ["esm2.bwd.head",
                                                   "esm2.bwd.norm"]
    assert len(found["ln_fwd_kernel"]) == len(found["ln_bwd_kernel"]) == 6
