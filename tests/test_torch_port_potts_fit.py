"""The port's Potts fitting and Gibbs sampling (ppde_tpu_torch/models/
potts_fit.py, potts.gibbs_sweep / gibbs_sample / _field) against the JAX
package's on the CPU.

Tolerances: ``sequence_weights`` equal (integer identity counts from a
float32 product of one-hots); the fit (deterministic in both packages:
zero init, Adam, cosine schedule) within float32 rounding: each step's
loss to rtol 1e-5, J and h to 2e-5 of their largest magnitude but for at
most 0.1% of their elements (within 1e-3: Adam's eps against a gradient
near zero), the fitted energies of the alignment's rows to rtol 1e-4;
Gibbs tokens equal with the JAX package's Gumbel draws replayed, and the
incremental field within 1e-5 of its magnitude of a fresh ``_field``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from ppde_tpu import io as jio
from ppde_tpu.models import potts as jpotts, potts_fit as jfit
from ppde_tpu_torch import convert, io as pio
from ppde_tpu_torch.models import potts as ppotts, potts_fit as pfit

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PABP_A2M = os.path.join(REPO, "data", "proteins", "synthetic",
                        "PABP_YEAST_Fields2013_synth.a2m")


@pytest.fixture(scope="module")
def pabp_cut():
    """300 rows of the tracked PABP synthetic alignment, 12 columns, a
    few gaps put in by a numpy seed, and 60 near-copies of its first rows
    (2-4 letters changed: identities 8/12 to 10/12 about the 0.75 and 0.8
    thresholds, with exact ties at 9/12)."""
    msa = pio.load_msa(PABP_A2M)[:300]
    assert msa == jio.load_msa(PABP_A2M)[:300]
    rng = np.random.default_rng(0)
    rows = []
    for name, s in msa:
        s = list(s[20:32])
        for j in rng.choice(12, rng.integers(0, 3), replace=False):
            s[j] = "-"
        rows.append((name, "".join(s)))
    for i, (name, s) in enumerate(rows[:60]):
        s = list(s)
        for j in rng.choice(12, 2 + i % 3, replace=False):
            s[j] = "ACDEFGHIKLMNPQRSTVWY"[rng.integers(20)]
        rows.append((name + "_copy", "".join(s)))
    return rows


def test_onehot_and_sequence_weights_equal(pabp_cut):
    oh = pfit.msa_to_onehot(pabp_cut)
    np.testing.assert_array_equal(oh, jfit.msa_to_onehot(pabp_cut))
    for identity in (0.75, 0.8):
        w_j = jfit.sequence_weights(oh, identity=identity, batch=128)
        w_p = pfit.sequence_weights(oh, identity=identity, batch=128,
                                    device="cpu")
        np.testing.assert_array_equal(w_p, w_j)
        assert w_p.min() < 1.0  # the near-copies count
    np.testing.assert_array_equal(pfit._diag_block_mask(5),
                                  jfit._diag_block_mask(5))


def test_fit_matches_jax_within_float32_rounding(pabp_cut):
    """25 steps with generic row weights (a numpy uniform draw). With many
    equal weights a weighted letter frequency can cancel a gradient
    exactly; Adam then scales rounding noise (|g| ~ 1e-9 against eps =
    1e-8) to a step of up to lr, in either package, and the two fits part
    (ROADMAP Queue 3, by design)."""
    oh = pfit.msa_to_onehot(pabp_cut)
    w = np.random.default_rng(1).uniform(0.5, 1.5, len(oh)).astype(
        np.float32)
    J_j, h_j, hist_j = jfit.fit(oh, w, steps=25, lr=0.05)
    J_p, h_p, hist_p = pfit.fit(oh, w, steps=25, lr=0.05, device="cpu")
    np.testing.assert_allclose(hist_p, hist_j, rtol=1e-5)
    assert hist_p[-1] < hist_p[0]
    for ours, theirs in ((J_p, J_j), (h_p, h_j)):
        d = np.abs(ours - theirs) / np.abs(theirs).max()
        # a gradient crossing zero still meets Adam's eps: at most 0.1% of
        # the elements, by at most 1e-3
        assert (d > 2e-5).mean() <= 1e-3 and d.max() <= 1e-3, (
            (d > 2e-5).sum(), d.max())
    # the fitted Hamiltonians of the alignment's rows
    x = oh.reshape(len(oh), -1)

    def energies(J, h):
        W = J.transpose(1, 3, 0, 2).reshape(x.shape[1], x.shape[1])
        return 0.5 * np.einsum("mi,ij,mj->m", x, W, x) + x @ h.reshape(-1)

    np.testing.assert_allclose(energies(J_p, h_p), energies(J_j, h_j),
                               rtol=1e-4, atol=1e-4)
    assert np.array_equal(J_p, J_p.transpose(1, 0, 3, 2))
    assert not J_p[np.arange(12), np.arange(12)].any()


def test_fit_from_a2m_matches_jax(tmp_path):
    """The artifact path: subsampling, index_list and offset."""
    lines = open(PABP_A2M).read().split("\n")
    path = str(tmp_path / "cut.a2m")
    with open(path, "w") as f:
        f.write("\n".join(
            [lines[0], lines[1][:10].lower() + lines[1][10:18]]
            + [ln if ln.startswith(">") else ln[:18]
               for ln in lines[2:200]]) + "\n")
    out_j = jfit.fit_from_a2m(path, steps=3, max_seqs=50, seed=1)
    out_p = pfit.fit_from_a2m(path, steps=3, max_seqs=50, seed=1,
                              device="cpu")
    np.testing.assert_array_equal(out_p[2], out_j[2])
    assert out_p[3] == out_j[3]
    np.testing.assert_allclose(out_p[4], out_j[4], rtol=1e-5)
    assert out_p[1].shape == (8, 20)


def _small_potts(L=10, seed=3):
    wt = "".join(np.random.default_rng(seed).choice(
        list("ACDEFGHIKLMNPQRSTVWY"), L))
    j = jpotts.synthetic(wt, seed=seed, coupling_scale=0.3)
    p = convert.potts_from_numpy(np.asarray(j.W), np.asarray(j.h),
                                 np.asarray(j.wt_H), j.seq_len, j.min_pos,
                                 j.max_pos, device="cpu")
    return j, p


class GumbelReplay:
    def __init__(self, arrays):
        self.queue = [np.array(a) for a in arrays]

    def gumbel(self, shape):
        a = self.queue.pop(0)
        assert a.shape == tuple(shape)
        return torch.from_numpy(a)


def test_gibbs_sweeps_match_jax_with_replayed_gumbels():
    j, p = _small_potts()
    B, L, V = 16, j.seq_len, 20
    x0 = jax.nn.one_hot(jax.random.randint(jax.random.PRNGKey(0), (B, L),
                                           0, V), V)
    sweep = jax.jit(jpotts.gibbs_sweep)
    x, F = x0, jpotts._field(j, x0)
    xp = torch.from_numpy(np.array(x0))
    Fp = ppotts._field(p, xp)
    np.testing.assert_allclose(Fp.numpy(), np.asarray(F), rtol=0, atol=1e-5)
    for key in jax.random.split(jax.random.PRNGKey(1), 3):
        x, F = sweep(j, x, F, key)
        draws = GumbelReplay([jax.random.gumbel(k, (B, V))
                              for k in jax.random.split(key, L)])
        xp, Fp = ppotts.gibbs_sweep(p, xp, Fp, draws)
        assert not draws.queue
        np.testing.assert_array_equal(xp.numpy(), np.asarray(x))
        fresh = ppotts._field(p, xp)
        np.testing.assert_allclose(Fp.numpy(), fresh.numpy(), rtol=0,
                                   atol=1e-5 * fresh.abs().max().item())
    assert (xp.argmax(-1) != torch.from_numpy(np.array(x0)).argmax(-1)).any()


def test_gibbs_sample_draws_from_the_field_law():
    """At beta = 0 every letter is equally likely; with x0 None the start
    is softmax(beta h) per position (strong fields pin it)."""
    _, p = _small_potts(L=4)
    gen = torch.Generator().manual_seed(0)
    x = ppotts.gibbs_sample(p, gen, n_chains=2000, n_sweeps=1, beta=0.0)
    assert x.shape == (2000, 4, 20) and torch.all(x.sum(-1) == 1)
    freq = x.mean(0)
    assert float((freq - 0.05).abs().max()) < 0.02
    p.h = p.h * 0 + 50.0 * torch.nn.functional.one_hot(
        torch.arange(p.h.shape[0]) % 20, 20)[:, 3].float()
    x0 = ppotts.gibbs_sample(p, gen, n_chains=8, n_sweeps=0)
    assert torch.all(x0.argmax(-1) == 3)
