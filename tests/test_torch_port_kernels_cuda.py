"""Kernels A, B, C and C' against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch.cuda.is_available() is False
(CUDA kernels have no CPU or interpret mode). On a machine with a GPU:
``python -m pytest --noconftest tests/test_torch_port_kernels_cuda.py``
(``--noconftest``: the repo's conftest imports JAX, which that machine
lacks). The cases are chip_smoke.py's at small sizes.
"""
import numpy as np
import pytest
import torch

from ppde_tpu_torch.models import cnn, esm2
from ppde_tpu_torch.ops import attention_fused, cnn_fused, potts_fused

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


def test_potts_kernel_rejects_bad_input(dev):
    W = torch.zeros((100, 100), device=dev)
    with pytest.raises(ValueError):
        potts_fused.energy_and_grad(W, torch.zeros(100, device=dev),
                                    torch.zeros((4, 100), device=dev))


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
               (3, 130, 64), (2, 1, 24), (2, 512, 64), (5, 65, 48)]


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
    big = torch.zeros((1, attention_fused.T_MAX + 1, 8), device=dev)
    with pytest.raises(ValueError):
        attention_fused.flash_attention(big, big, big)
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
