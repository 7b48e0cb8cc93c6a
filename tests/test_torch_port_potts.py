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


def _hand_picked_w():
    """W holding +0, -0, large, tiny normal values and values with all 24
    significand bits set (every plane nonzero), padded to 128 x 128."""
    vals = np.array([0.0, -0.0, 1e38, -3e37, 1.1754944e-38 * 2 ** 40,
                     2 ** -100, -(2 ** -90) * 1.5,
                     np.nextafter(np.float32(1.0), np.float32(2.0)),
                     np.float32(1.0) - np.float32(2 ** -24),
                     np.float32(16777215.0), np.float32(-0.1),
                     np.float32(1 / 3), np.float32(np.pi)], np.float32)
    all_bits = np.frombuffer(
        (np.arange(256, dtype=np.uint32) << 23 | 0x7FFFFF).astype(np.uint32)
        .tobytes(), np.float32)
    all_bits = all_bits[np.isfinite(all_bits) & (np.abs(all_bits) > 1e-30)
                        & (np.abs(all_bits) < 1e38)]
    w = np.zeros(128 * 128, np.float32)
    w[:len(vals)] = vals
    w[len(vals):len(vals) + len(all_bits)] = all_bits
    w[-len(all_bits):] = -all_bits
    return torch.from_numpy(w.reshape(128, 128))


@pytest.mark.parametrize("which", ["gfp", "hand-picked"])
def test_prepare_planes_rebuild_w_bit_for_bit(which):
    """Kernel A's three bf16 planes of a float32 W add up to W exactly: the
    seeded GFP-width couplings (P = 4864) and hand-picked values. A bf16 W
    is its own single plane; h is kept in float32."""
    if which == "gfp":
        gfp = ("SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLV"
               "TTLSYGVQCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNR"
               "IELKGIDFKEDGNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQ"
               "QNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK")
        tp = potts.synthetic(gfp, seed=0, device="cpu")
        W, h = tp.W, tp.h
        assert W.shape == (4864, 4864)
    else:
        W = _hand_picked_w()
        h = torch.linspace(-1.0, 1.0, 128)
    prep = potts_fused.prepare(W, h)
    assert prep.planes.dtype == torch.bfloat16
    assert prep.planes.shape == (3,) + tuple(W.shape)
    hi, mid, lo = prep.planes.float()
    bits = W.view(torch.int32)
    # in either order the kernel's sums can take them: exact, -0 included
    assert torch.equal(((hi + mid) + lo).view(torch.int32), bits)
    assert torch.equal((hi + (mid + lo)).view(torch.int32), bits)
    assert prep.h32.dtype == torch.float32 and torch.equal(prep.h32, h)
    bf = potts_fused.prepare(W.to(torch.bfloat16), h.to(torch.bfloat16))
    assert bf.planes.shape == (1,) + tuple(W.shape)
    assert torch.equal(bf.planes[0], W.to(torch.bfloat16))
    assert torch.equal(bf.h32, h.to(torch.bfloat16).float())


@pytest.mark.parametrize("batch", [5, 130])
def test_plane_arithmetic_matches_pallas_interpret(pair, batch):
    """What kernel A computes from the planes, sum_plane xf @ W_plane + h
    in float32, against the TPU kernel's body in interpret mode on
    one-hots, at the tolerances of test_plain_matches_pallas_interpret;
    energy_and_grad from a Prepared on the CPU is the plain version's."""
    jp, tp = pair
    x = _x(np.random.default_rng(batch), batch, L=16)
    xf = jpotts._pad_flat(jp, jnp.asarray(x))
    Hk, gk = potts_pallas.energy_and_grad(jp.W, jp.h, xf, interpret=True)
    prep = potts_fused.prepare(tp.W, tp.h)
    xt = torch.from_numpy(np.array(xf)).to(torch.bfloat16).float()
    Jx = sum(xt @ plane.float() for plane in prep.planes)
    gt = Jx + prep.h32
    Ht = (xt * (0.5 * Jx + prep.h32)).sum(-1)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hk), **E_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gk), **G_TOL)
    H0, g0 = potts_fused.energy_and_grad(prep, None, xt)
    H1, g1 = potts_fused.energy_and_grad(tp.W, tp.h, xt)
    assert torch.equal(H0, H1) and torch.equal(g0, g1)


def test_prepare_refuses_what_the_kernel_does_not_take():
    W = torch.zeros((256, 256))
    with pytest.raises(TypeError):
        potts_fused.prepare(W, torch.zeros(256, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        potts_fused.prepare(torch.zeros((200, 200)), torch.zeros(200))
    with pytest.raises(ValueError):   # not contiguous
        potts_fused.prepare(torch.zeros((256, 512))[:, ::2], torch.zeros(256))
