"""Kernels A and B against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch.cuda.is_available() is False
(CUDA kernels have no CPU or interpret mode). On a machine with a GPU:
``python -m pytest --noconftest tests/test_torch_port_kernels_cuda.py``
(``--noconftest``: the repo's conftest imports JAX, which that machine
lacks). The cases are chip_smoke.py's at small sizes.
"""
import numpy as np
import pytest
import torch

from ppde_tpu_torch.models import cnn
from ppde_tpu_torch.ops import cnn_fused, potts_fused

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
