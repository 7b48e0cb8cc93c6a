"""ppde_tpu_torch.models.potts and kernel A's plain version against
ppde_tpu.models.potts (XLA path and the Pallas kernel in interpret mode).

Tolerances: float32 on the CPU, sums in another order than XLA's, so
energies at rtol 1e-5 / atol 1e-4 and gradients at atol 1e-5."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec
from ppde_tpu.models import potts as jpotts
from ppde_tpu.ops import potts_pallas
from ppde_tpu_torch import convert
from ppde_tpu_torch.models import potts
from ppde_tpu_torch.ops import potts_fused

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRSTVWY"  # 20 residues
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_TOL = dict(rtol=1e-5, atol=1e-4)
G_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jp = jpotts.synthetic(WT, min_pos=2, max_pos=17, seed=1,
                          coupling_scale=0.1)
    tp = potts.synthetic(WT, min_pos=2, max_pos=17, seed=1,
                         coupling_scale=0.1, device="cpu")
    return jp, tp


def _x(rng, n, L=len(WT)):
    return jcodec.ints_to_onehot(rng.integers(0, 20, (n, L)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_same_parameters(dtype):
    jp = jpotts.synthetic(WT, min_pos=1, max_pos=18, seed=4,
                          dtype=getattr(jnp, dtype))
    tp = potts.synthetic(WT, min_pos=1, max_pos=18, seed=4,
                         dtype=getattr(torch, dtype), device="cpu")
    # the same numpy draws: W and h equal bit for bit
    np.testing.assert_array_equal(tp.W.float().numpy(),
                                  np.asarray(jp.W, np.float32))
    np.testing.assert_array_equal(tp.h.float().numpy(),
                                  np.asarray(jp.h, np.float32))
    np.testing.assert_allclose(float(tp.wt_H), float(jp.wt_H), **E_TOL)
    assert (tp.seq_len, tp.min_pos, tp.max_pos, tp.padded_dim) == \
        (jp.seq_len, jp.min_pos, jp.max_pos, jp.padded_dim)


def test_hamiltonian_and_grad_matches_jax(pair, rng):
    jp, tp = pair
    x = _x(rng, 6, L=16)
    Hj, gj = jpotts.hamiltonian_and_grad(jp, jnp.asarray(x), use_pallas=False)
    Ht, gt = potts.hamiltonian_and_grad(tp, torch.from_numpy(x))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **G_TOL)
    np.testing.assert_allclose(potts.hamiltonian(tp, torch.from_numpy(x)),
                               np.asarray(jpotts.hamiltonian(jp, x)), **E_TOL)


def test_plain_matches_pallas_interpret(pair, rng):
    """Kernel A's plain version against the TPU kernel's own body, run in
    interpret mode."""
    jp, tp = pair
    x = _x(rng, 5, L=16)
    xf = jpotts._pad_flat(jp, jnp.asarray(x))
    Hk, gk = potts_pallas.energy_and_grad(jp.W, jp.h, xf, interpret=True)
    Ht, gt = potts_fused.energy_and_grad(tp.W, tp.h,
                                         torch.from_numpy(np.array(xf)))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hk), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)


def test_score_and_grad_matches_jax(pair, rng):
    jp, tp = pair
    x = _x(rng, 7)
    sj, gj = jpotts.score_and_grad(jp, jnp.asarray(x), use_pallas=False)
    st, gt = potts.score_and_grad(tp, torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **G_TOL)
    np.testing.assert_allclose(potts.score(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jpotts.score(jp, jnp.asarray(x))),
                               **E_TOL)
    # zero gradient outside the window [2, 17]
    assert (gt[:, :2] == 0).all() and (gt[:, 18:] == 0).all()


def test_wt_delta_is_zero(pair):
    _, tp = pair
    wt = torch.from_numpy(jcodec.seqs_to_onehot([WT]))
    s, _ = potts.score_and_grad(tp, wt)
    assert abs(float(s[0])) < 1e-4
    assert abs(float(potts.score(tp, wt)[0])) < 1e-4


def test_grad_is_the_autograd_gradient(pair, rng):
    _, tp = pair
    x = torch.from_numpy(_x(rng, 3)).requires_grad_(True)
    potts.score(tp, x).sum().backward()
    _, g = potts.score_and_grad(tp, x.detach())
    torch.testing.assert_close(g, x.grad, rtol=0, atol=1e-5)


def test_load_npz_matches_jax():
    """The tracked UBE4B fit (window 23..98 after the 1070 offset); any
    sequence of the right length serves as the wild type."""
    path = os.path.join(ROOT, "weights",
                        "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio",
                        "potts.npz")
    seq = jcodec.ALPHABET * 5
    jp = jpotts.load_npz(path, seq)
    tp = potts.load_npz(path, seq, device="cpu")
    np.testing.assert_array_equal(tp.W.numpy(), np.asarray(jp.W))
    assert (tp.min_pos, tp.max_pos, tp.reg_coef) == \
        (jp.min_pos, jp.max_pos, jp.reg_coef)
    x = _x(np.random.default_rng(5), 3, L=len(seq))
    sj, gj = jpotts.score_and_grad(jp, jnp.asarray(x), use_pallas=False)
    st, gt = potts.score_and_grad(tp, torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **G_TOL)


def test_convert_potts_from_numpy(pair, rng):
    jp, _ = pair
    tp = convert.potts_from_numpy(
        *jax.tree.map(np.asarray, (jp.W, jp.h, jp.wt_H)), jp.seq_len,
        jp.min_pos, jp.max_pos, jp.reg_coef, device="cpu")
    x = _x(rng, 4)
    np.testing.assert_allclose(
        potts.score(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jpotts.score(jp, jnp.asarray(x))), **E_TOL)


@pytest.mark.parametrize("batch", [1, 37, 130])
def test_plain_matches_pallas_interpret_at_ragged_batches(pair, batch):
    """Kernel A's plain version at the batch sizes where the kernel's
    128-row tiles have edges (one row, a part of a tile, one over a tile),
    against the TPU kernel's body in interpret mode, float32."""
    jp, tp = pair
    x = _x(np.random.default_rng(batch), batch, L=16)
    xf = jpotts._pad_flat(jp, jnp.asarray(x))
    Hk, gk = potts_pallas.energy_and_grad(jp.W, jp.h, xf, interpret=True)
    Ht, gt = potts_fused.energy_and_grad(tp.W, tp.h,
                                         torch.from_numpy(np.array(xf)))
    assert Ht.shape == (batch,) and gt.shape == (batch, tp.padded_dim)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hk), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)


@pytest.mark.parametrize("length", [6, 32])   # P = 128 and P = 640
def test_plain_matches_jax_at_other_widths(length):
    """One and five column tiles of 128 (GFP's 38 run on the card only)."""
    wt = (WT * 2)[:length]
    jp = jpotts.synthetic(wt, seed=length)
    tp = potts.synthetic(wt, seed=length, device="cpu")
    assert tp.padded_dim == -(-length * 20 // 128) * 128
    x = _x(np.random.default_rng(length), 9, L=length)
    Hj, gj = jpotts.hamiltonian_and_grad(jp, jnp.asarray(x), use_pallas=False)
    Ht, gt = potts.hamiltonian_and_grad(tp, torch.from_numpy(x))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **G_TOL)


def test_couplings_are_symmetric(pair):
    """xf @ W + h is the Hamiltonian's gradient only for a symmetric W:
    the flattened couplings are symmetric, from a seed and from a file."""
    _, tp = pair
    assert torch.equal(tp.W, tp.W.T)
    rng = np.random.default_rng(0)
    Lw, Vv = 6, 20
    J = rng.standard_normal((Lw, Lw, Vv, Vv)).astype(np.float32)
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))   # J[i,j,k,l] = J[j,i,l,k]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.npz")
        np.savez(path, J=J, h=rng.standard_normal((Lw, Vv)).astype(np.float32),
                 index_list=np.arange(Lw), reg_coef=1.0, offset=0)
        loaded = potts.load_npz(path, WT[:Lw], device="cpu")
    assert torch.equal(loaded.W, loaded.W.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_flat_pads_and_casts_in_one_copy(pair, rng, dtype):
    _, tp = pair
    x = torch.from_numpy(_x(rng, 4, L=16))
    want = torch.nn.functional.pad(x.reshape(4, -1),
                                   (0, tp.padded_dim - 320)).to(dtype)
    got = potts._pad_flat(tp, x, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(potts._pad_flat(tp, x), want.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_a_w_that_is_not_symmetric(pair, rng, dtype):
    """energy_and_grad computes xf @ W for any W, not xf @ W.T: kernel A
    reads the W tile as it lies in memory and relies on no symmetry (held
    on the card by tests/test_torch_port_kernels_cuda.py)."""
    _, tp = pair
    W = tp.W.clone()
    W[0, 21] += 0.5                       # one coupling, on one side only
    W, h = W.to(dtype), tp.h.to(dtype)
    x = torch.from_numpy(_x(rng, 3, L=16))
    x[0, 0] = 0.0
    x[0, 0, 0] = 1.0                      # row 0 of W is selected
    xf = potts._pad_flat(tp, x, dtype)
    H, g = potts_fused.energy_and_grad(W, h, xf)
    want = xf.float() @ W.float() + h.float()
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
    assert abs(float(g[0, 21] - (xf.float() @ W.float().T + h.float())[0, 21])
               - 0.5) < 1e-2
    assert H.shape == (3,)
