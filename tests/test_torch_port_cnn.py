"""ppde_tpu_torch.models.cnn and kernel B's plain version against
ppde_tpu (the VJP of cnn.ensemble_apply, and the Pallas kernels
ensemble_fit_and_patch_grad / _m in interpret mode).

Tolerances: float32 on the CPU, sums in another order than XLA's: fitness
at rtol 1e-5 / atol 1e-5, input gradients at atol 1e-5 (their entries are
~1e-2). bfloat16: the two packages round at different points (the JAX XLA
path adds biases in bf16, the port in f32 as the fused kernels do), so
those are held at the JAX package's own bf16 bounds (test_cnn_pallas.py:
fitness 3e-2, gradient cosine > 0.99)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec
from ppde_tpu.models import cnn as jcnn
from ppde_tpu.ops import cnn_pallas
from ppde_tpu_torch import convert
from ppde_tpu_torch.models import cnn
from ppde_tpu_torch.ops import cnn_fused

torch.set_num_threads(1)
L, V, M, C = 18, 20, 3, 16
F_TOL = dict(rtol=1e-5, atol=1e-5)
G_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def ens():
    j = jcnn.init_ensemble(jax.random.PRNGKey(0), M, input_size=C)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    return j, t


def _x(n, seed=1):
    return jcodec.ints_to_onehot(
        np.random.default_rng(seed).integers(0, V, (n, L)))


def _ties(n):
    """Period-5 sequences: every 5-mer window repeats, so every channel's
    max-pool ties exactly (split and first differ)."""
    base = np.random.default_rng(2).integers(0, V, (n, 5))
    return jcodec.ints_to_onehot(np.tile(base, (1, 4))[:, :L])


def _jax_fit_and_grad(j, x, pool):
    fit, vjp = jax.vjp(lambda v: jcnn.ensemble_apply(j, v, pool_bwd=pool),
                       jnp.asarray(x))
    (g,) = vjp(jnp.ones_like(fit))
    return np.asarray(fit), np.asarray(g)


def test_ensemble_apply_matches_jax(ens):
    j, t = ens
    x = _x(9)
    np.testing.assert_allclose(
        cnn.ensemble_apply(t, torch.from_numpy(x)).numpy(),
        np.asarray(jcnn.ensemble_apply(j, jnp.asarray(x))), **F_TOL)
    one_j = jax.tree.map(lambda a: a[1], j)
    one_t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, one_j),
                                            "cpu")
    np.testing.assert_allclose(
        cnn.apply(one_t, torch.from_numpy(x)).numpy(),
        np.asarray(jcnn.apply(one_j, jnp.asarray(x))), **F_TOL)


@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_fit_and_grad_matches_jax_vjp(ens, pool, ties):
    j, t = ens
    x = _ties(6) if ties else _x(6)
    fj, gj = _jax_fit_and_grad(j, x, pool)
    ft, gt = cnn_fused.ensemble_apply_and_grad(t, torch.from_numpy(x),
                                               pool_bwd=pool)
    np.testing.assert_allclose(ft.numpy(), fj, **F_TOL)
    np.testing.assert_allclose(gt.numpy(), gj, **G_TOL)


def test_tie_input_separates_pool_modes(ens):
    _, t = ens
    x = torch.from_numpy(_ties(4))
    _, g_split = cnn.ensemble_apply_and_grad_plain(t, x, pool_bwd="split")
    _, g_first = cnn.ensemble_apply_and_grad_plain(t, x, pool_bwd="first")
    assert not torch.allclose(g_split, g_first, atol=1e-6)


@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("member_grid", [False, True])
def test_plain_matches_pallas_interpret(ens, pool, member_grid):
    """Against the TPU kernels' own bodies (B: unrolled members, B': one
    member per grid step), float32, with a ragged batch (10 rows, tile 8)."""
    j, t = ens
    x = _x(10, seed=3)
    fk, gk = cnn_pallas.ensemble_apply_and_grad(
        j, jnp.asarray(x), compute_dtype=jnp.float32, batch_tile=8,
        interpret=True, member_grid=member_grid, pool_bwd=pool)
    ft, gt = cnn_fused.ensemble_apply_and_grad(t, torch.from_numpy(x),
                                               pool_bwd=pool)
    assert ft.shape == (10,) and gt.shape == x.shape
    np.testing.assert_allclose(ft.numpy(), np.asarray(fk), **F_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)


def test_bf16_close_to_jax(ens):
    j, t = ens
    x = _x(8, seed=4)
    fj = np.asarray(jcnn.ensemble_apply(j, jnp.asarray(x),
                                        compute_dtype=jnp.bfloat16))
    ft, gt = cnn.ensemble_apply_and_grad_plain(t, torch.from_numpy(x),
                                               compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=3e-2, atol=3e-2)
    _, gj = _jax_fit_and_grad(j, x, "split")
    a, b = gt.numpy().ravel(), gj.ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


def test_max_pool_first_tie_routing():
    h = torch.tensor([[1.0, 2.0], [3.0, 2.0], [3.0, 1.0]])[None]
    h.requires_grad_(True)
    cnn.max_pool_first(h).sum().backward()
    np.testing.assert_array_equal(h.grad[0].numpy(),
                                  [[0.0, 1.0], [1.0, 0.0], [0.0, 0.0]])
    h.grad = None
    torch.amax(h, dim=1).sum().backward()  # "split"
    np.testing.assert_array_equal(h.grad[0].numpy(),
                                  [[0.0, 0.5], [0.5, 0.5], [0.5, 0.0]])


def test_im2col_matches_jax():
    x = _x(3)
    np.testing.assert_array_equal(cnn.im2col(torch.from_numpy(x)).numpy(),
                                  np.asarray(cnn_pallas.im2col(x)))
