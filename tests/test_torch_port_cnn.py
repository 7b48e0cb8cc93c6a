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


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("pool", ["split", "first"])
def test_prepared_weights_give_the_stacked_result(ens, dtype, pool):
    """prepare_ensemble's tensors are the kernel's; the result through the
    plain version is the stacked layout's, bit for bit."""
    _, t = ens
    x = torch.from_numpy(_ties(5))
    prep = cnn_fused.prepare_ensemble(t, dtype)
    assert prep.dims == (M, 5, V, C, 2 * C)
    f0, g0 = cnn_fused.ensemble_apply_and_grad(t, x, dtype, pool)
    f1, g1 = cnn_fused.ensemble_apply_and_grad(prep, x, None, pool)
    f2, g2 = cnn_fused.ensemble_apply_and_grad(prep, x, dtype, pool)
    assert torch.equal(f0, f1) and torch.equal(g0, g1)
    assert torch.equal(f0, f2) and torch.equal(g0, g2)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError):
        cnn_fused.ensemble_apply_and_grad(prep, x, other, pool)


def _unswizzle(tiles):
    """Inverse of cnn_fused.swizzle_tiles (the XOR is its own inverse):
    [..., 4, N, 64] -> [..., N, 256]."""
    *lead, nt, N, tk = tiles.shape
    t = tiles.reshape(*lead, nt, N, 8, 8)
    idx = torch.arange(8)[None, :] ^ (torch.arange(N)[:, None] & 7)
    idx = idx[:, :, None].expand(N, 8, 8).expand(t.shape)
    return torch.gather(t, -2, idx).transpose(-4, -3).reshape(
        *lead, N, nt * tk)


def test_prepared_bf16_tiles_hold_the_weights(ens):
    """The swizzled tiles of prepare_ensemble, undone, are the padded
    weights: enc_w as [j, c], emb_w^T as [c2, c] in chunks of CHUNK rows."""
    _, t = ens
    prep = cnn_fused.prepare_ensemble(t, torch.bfloat16)
    tt = prep.layout(cnn_fused.TC)
    n_chunk = -(-2 * C // cnn_fused.CHUNK)
    assert tt["enc_blob"].shape == (M, 4, cnn_fused.KV_PAD, cnn_fused.TILE_K)
    assert tt["emb_blob"].shape == (M, n_chunk, 4, cnn_fused.CHUNK,
                                    cnn_fused.TILE_K)
    enc = _unswizzle(tt["enc_blob"])       # [M, 104, 256]
    want = t["encoder"]["w"].reshape(M, 5 * V, C).to(torch.bfloat16)
    assert torch.equal(enc[:, :5 * V, :C], want)
    assert not enc[:, 5 * V:].any() and not enc[:, :, C:].any()
    emb = _unswizzle(tt["emb_blob"]).reshape(M, -1, 256)
    wantT = t["embed"]["w"].to(torch.bfloat16).transpose(1, 2)
    assert torch.equal(emb[:, :2 * C, :C], wantT)
    assert torch.equal(tt["embwT"][:, :, :C], wantT)
    assert not emb[:, 2 * C:].any() and not emb[:, :, C:].any()
    # element (row n, depth k) of a tile: 16-byte chunk XOR the row's low bits
    n, k = 11, 13
    pos = (((k % 64) // 8) ^ (n & 7)) * 8 + k % 8
    assert tt["enc_blob"][1, k // 64, n, pos] == want[1, n, k]
    assert tt["encb"].shape == (M, 256) and tt["embb"].shape == (
        M, n_chunk * cnn_fused.CHUNK)


def test_swizzle_tiles_is_its_own_inverse():
    w = torch.randn((2, 3, 10, 256), generator=torch.Generator().manual_seed(0))
    tiles = cnn_fused.swizzle_tiles(w)
    assert tiles.shape == (2, 3, 4, 10, 64)
    assert torch.equal(_unswizzle(tiles), w)
    with pytest.raises(ValueError):
        cnn_fused.swizzle_tiles(torch.zeros((4, 128)))


@pytest.mark.parametrize("width,length,batch", [
    (20, 18, 1),    # C not a multiple of 16, one sample
    (20, 5, 5),     # L = K: one window per sample
    (24, 12, 37),   # a ragged batch over several tiles of 8
])
@pytest.mark.parametrize("pool", ["split", "first"])
def test_plain_matches_pallas_interpret_at_ragged_sizes(width, length, batch,
                                                        pool):
    """The plain version at the sizes where kernel B's tiling has edges,
    against the TPU kernel's body in interpret mode, float32 (1e-5)."""
    j = jcnn.init_ensemble(jax.random.PRNGKey(width), M, input_size=width)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    x = jcodec.ints_to_onehot(np.random.default_rng(batch).integers(
        0, V, (batch, length)))
    fk, gk = cnn_pallas.ensemble_apply_and_grad(
        j, jnp.asarray(x), compute_dtype=jnp.float32, batch_tile=8,
        interpret=True, pool_bwd=pool)
    ft, gt = cnn_fused.ensemble_apply_and_grad(
        cnn_fused.prepare_ensemble(t), torch.from_numpy(x), pool_bwd=pool)
    assert ft.shape == (batch,) and gt.shape == x.shape
    np.testing.assert_allclose(ft.numpy(), np.asarray(fk), **F_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)


def test_bf16_plain_close_to_pallas_interpret_at_a_ragged_size():
    """bfloat16, C not a multiple of 16, against the TPU kernel's body at
    the JAX package's own bf16 bounds (fitness 3e-2, gradient cosine)."""
    j = jcnn.init_ensemble(jax.random.PRNGKey(3), M, input_size=20)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    x = jcodec.ints_to_onehot(np.random.default_rng(9).integers(0, V, (5, L)))
    fk, gk = cnn_pallas.ensemble_apply_and_grad(
        j, jnp.asarray(x), compute_dtype=jnp.bfloat16, batch_tile=8,
        interpret=True)
    ft, gt = cnn_fused.ensemble_apply_and_grad(
        cnn_fused.prepare_ensemble(t, torch.bfloat16), torch.from_numpy(x))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fk), rtol=3e-2,
                               atol=3e-2)
    a, b = gt.numpy().ravel(), np.asarray(gk, np.float32).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


@pytest.mark.parametrize("width", [C, 37])     # C a multiple of 16, and not
def test_prepared_f32_layout_holds_the_weights(width):
    """The float32 layout of prepare_ensemble holds the weights, zero-padded:
    enc_w's rows [j][c] and its transpose [c][j] (128 columns), emb_w in
    column chunks of 128 [ch][c][c2], emb_w^T's rows [c2][c], the biases and
    the decoder, C padded to a multiple of 16."""
    j = jcnn.init_ensemble(jax.random.PRNGKey(width), M, input_size=width)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    tt = cnn_fused.prepare_ensemble(t).layout(cnn_fused.SIMT)
    K, C2 = 5, 2 * width
    Cp = -(-width // cnn_fused.F32_DEPTH) * cnn_fused.F32_DEPTH
    n_chunk = -(-C2 // cnn_fused.F32_CHUNK)
    enc = t["encoder"]["w"].reshape(M, K * V, width)
    emb = t["embed"]["w"]
    assert tt["encw"].shape == (M, K * V, Cp)
    assert torch.equal(tt["encw"][:, :, :width], enc)
    assert not tt["encw"][:, :, width:].any()
    assert tt["encT"].shape == (M, Cp, cnn_fused.F32_CHUNK)
    assert torch.equal(tt["encT"][:, :width, :K * V], enc.transpose(1, 2))
    assert not tt["encT"][:, width:].any()
    assert not tt["encT"][:, :, K * V:].any()
    assert tt["emb"].shape == (M, n_chunk, Cp, cnn_fused.F32_CHUNK)
    whole = tt["emb"].transpose(1, 2).reshape(M, Cp, -1)
    assert torch.equal(whole[:, :width, :C2], emb)
    assert not whole[:, width:].any() and not whole[:, :, C2:].any()
    # element (member 1, depth c, column c2) of chunk c2 // 128
    c, c2 = width - 1, C2 - 1
    F = cnn_fused.F32_CHUNK
    assert tt["emb"][1, c2 // F, c, c2 % F] == emb[1, c, c2]
    assert tt["embwT"].shape == (M, C2, Cp)
    assert torch.equal(tt["embwT"][:, :, :width], emb.transpose(1, 2))
    assert torch.equal(tt["encb"][:, :width], t["encoder"]["b"].reshape(M, -1))
    assert tt["encb"].shape == (M, Cp) and not tt["encb"][:, width:].any()
    assert tt["embb"].shape == (M, n_chunk * cnn_fused.F32_CHUNK)
    assert torch.equal(tt["embb"][:, :C2], t["embed"]["b"].reshape(M, -1))
    assert torch.equal(tt["decw"], t["decoder"]["w"].reshape(M, C2))
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in tt.values())


# proteins past 256 residues: the reference-width CNN (C = L, the shapes of
# kernel B's wide kernel on the card) and a narrow one at the same length
@pytest.mark.parametrize("pool", ["split", "first"])
@pytest.mark.parametrize("width", [300, 16])
def test_long_sequences_match_jax(width, pool):
    """Fitness and input gradient at L = 300 (T = 296) against the XLA VJP
    of the JAX ensemble and the TPU kernel's body in interpret mode,
    float32, on random and on period-5 (tied) sequences."""
    length = 300
    j = jcnn.init_ensemble(jax.random.PRNGKey(width), M, input_size=width)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    rng = np.random.default_rng(width)
    x = jcodec.ints_to_onehot(np.concatenate([
        rng.integers(0, V, (2, length)),
        np.tile(rng.integers(0, V, (1, 5)), (1, length // 5))]))
    ft, gt = cnn_fused.ensemble_apply_and_grad(
        cnn_fused.prepare_ensemble(t), torch.from_numpy(x), pool_bwd=pool)
    assert ft.shape == (3,) and gt.shape == x.shape
    fj, gj = _jax_fit_and_grad(j, x, pool)
    np.testing.assert_allclose(ft.numpy(), fj, **F_TOL)
    np.testing.assert_allclose(gt.numpy(), gj, **G_TOL)
    fk, gk = cnn_pallas.ensemble_apply_and_grad(
        j, jnp.asarray(x), compute_dtype=jnp.float32, batch_tile=8,
        interpret=True, pool_bwd=pool)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fk), **F_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)


def test_wide_layout_holds_the_weights():
    """The wide kernels' float32 layout: enc_w in stages of WIDE_DEPTH
    channels, its transpose (WIDE_KV columns), emb_w in column tiles of
    256, emb_w^T's rows, C padded to WIDE_DEPTH, zero-padded; the biases and
    the decoder in float32 of the type's values (bf16's tiles: the test
    after this one)."""
    width = 300
    j = jcnn.init_ensemble(jax.random.PRNGKey(1), M, input_size=width)
    t = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j), "cpu")
    f32, KV = torch.float32, 5 * V
    Cp, ncol = 304, 3
    w = cnn_fused.wide_layout(t, f32)
    enc = t["encoder"]["w"].reshape(M, KV, width)
    emb = t["embed"]["w"]
    assert w["enc"].shape == (M, Cp // 16, KV, 16)
    enc_rows = w["enc"].transpose(1, 2).reshape(M, KV, Cp)
    assert torch.equal(enc_rows[:, :, :width], enc)
    assert not enc_rows[:, :, width:].any()
    assert w["encT"].shape == (M, Cp, cnn_fused.WIDE_KV)
    assert torch.equal(w["encT"][:, :width, :KV], enc.transpose(1, 2))
    assert not w["encT"][:, width:].any() and not w["encT"][:, :, KV:].any()
    assert w["emb"].shape == (M, ncol, Cp, 256)
    emb_all = w["emb"].transpose(1, 2).reshape(M, Cp, ncol * 256)
    assert torch.equal(emb_all[:, :width, :2 * width], emb)
    assert not emb_all[:, width:].any()
    assert not emb_all[:, :, 2 * width:].any()
    assert torch.equal(w["embwT"], torch.nn.functional.pad(
        emb.transpose(1, 2), (0, Cp - width)))
    assert w["embb"].shape == (M, ncol * 256) and w["encb"].shape == (M, Cp)
    assert torch.equal(w["decw"], t["decoder"]["w"].reshape(M, -1))
    assert all(v.dtype == f32 and v.is_contiguous() for v in w.values())
    wb = cnn_fused.wide_layout(t, torch.bfloat16)  # column tiles of 200
    assert wb["embb"].shape == (M, 3 * 200) and wb["encb"].shape == (M, 320)
    assert torch.equal(wb["encb"][:, :width], t["encoder"]["b"].reshape(
        M, width))
    assert torch.equal(wb["decw"], t["decoder"]["w"].to(torch.bfloat16)
                       .float().reshape(M, -1))
    # a kernel's layout is made at its first call, and kept
    prep = cnn_fused.prepare_ensemble(t)
    assert set(prep.tensors) == {"decw", "decb"} and not prep.layouts
    w = prep.layout(cnn_fused.WIDE)
    assert set(prep.layouts) == {cnn_fused.WIDE}
    assert prep.layout(cnn_fused.WIDE) is w
    assert torch.equal(w["decw"], cnn_fused.wide_layout(t, torch.float32)[
        "decw"])


@pytest.mark.parametrize("width,N", [(300, 200), (400, 200), (1022, 256),
                                     (40, 200), (129, 200)])
def test_wide_bf16_tiles_hold_the_weights(width, N):
    """The wide kernels' bf16 tiles, their swizzle undone, are the
    bf16-rounded weights, zero-padded: enc_w as [j, c] (j to WIDE_KV, c to a
    multiple of 64), emb_w^T as [c2, c] in column tiles of N (256 or 200,
    whichever pads 2C less); emb_w^T's rows in bf16."""
    t = cnn.init_ensemble(torch.Generator().manual_seed(width), M,
                          input_size=width)
    bf16, KV, C2 = torch.bfloat16, 5 * V, 2 * width
    assert cnn_fused.wide_cols(C2, bf16) == N
    Cp, ncol = -(-width // 64) * 64, -(-C2 // N)
    w = cnn_fused.wide_layout(t, bf16)
    want_enc = t["encoder"]["w"].reshape(M, KV, width).to(bf16)
    want_embT = t["embed"]["w"].to(bf16).transpose(1, 2)  # [M, C2, C]
    assert w["enc"].shape == (M, Cp // 64, cnn_fused.WIDE_KV, 64)
    enc = _unswizzle(w["enc"])                             # [M, 128, Cp]
    assert torch.equal(enc[:, :KV, :width], want_enc)
    assert not enc[:, KV:].any() and not enc[:, :, width:].any()
    assert w["emb"].shape == (M, ncol, Cp // 64, N, 64)
    emb = _unswizzle(w["emb"]).reshape(M, ncol * N, Cp)
    assert torch.equal(emb[:, :C2, :width], want_embT)
    assert not emb[:, C2:].any() and not emb[:, :, width:].any()
    assert w["embwT"].dtype == bf16 and w["embwT"].shape == (M, C2, Cp)
    assert torch.equal(w["embwT"][:, :, :width], want_embT)
    assert not w["embwT"][:, :, width:].any()
    # element (row n, depth k) of a tile: 16-byte chunk XOR the row's low bits
    n, k = 11, min(width - 1, 77)
    pos = (((k % 64) // 8) ^ (n & 7)) * 8 + k % 8
    assert w["emb"][2, n // N, k // 64, n % N, pos] == want_embT[2, n, k]
    assert all(v.is_contiguous() for v in w.values())
