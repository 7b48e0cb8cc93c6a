"""ppde_tpu_torch.energy against ppde_tpu.energy, mirroring
test_energy.py::test_protein_poe_grad_matches_autodiff,
::test_protein_poe_lambda_composition and
::test_cnn_chunked_energy_matches_full.

Tolerances: float32 on the CPU, sums in another order than XLA's: energies
at rtol 1e-5 / atol 1e-4, gradients at atol 1e-5. With the tiny transformer
expert (2 layers, dim 32; a pseudo-log-likelihood of about -50 per sequence)
energies at atol 2e-4 and gradients at atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy
from ppde_tpu.models import cnn as jcnn, esm2 as jesm2, potts as jpotts
from ppde_tpu_torch import convert, energy
from ppde_tpu_torch.models import esm2, potts

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRS"  # 16 residues
E_TOL = dict(rtol=1e-5, atol=1e-4)
G_TOL = dict(rtol=0, atol=1e-5)


def _ens(n_res, seed=0):
    j = jcnn.init_ensemble(jax.random.PRNGKey(seed), 3, input_size=n_res)
    return j, convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j),
                                              "cpu")


def _pair(wt, lam, min_pos=0, max_pos=None, seed=3, **kw):
    jp = jpotts.synthetic(wt, min_pos=min_pos, max_pos=max_pos, seed=seed)
    tp = potts.synthetic(wt, min_pos=min_pos, max_pos=max_pos, seed=seed,
                         device="cpu")
    je, te = _ens(len(wt))
    wt_oh = jcodec.seqs_to_onehot([wt])
    return (jenergy.protein_poe(jp, je, lam, jnp.asarray(wt_oh)),
            energy.protein_poe(tp, te, lam, torch.from_numpy(wt_oh), **kw))


def _x(rng, n, L):
    return jcodec.ints_to_onehot(rng.integers(0, 20, (n, L)))


def test_protein_poe_grad_matches_autodiff(rng):
    jen, ten = _pair(WT, 2.5, min_pos=1, max_pos=14)
    x = _x(rng, 4, len(WT))
    xt = torch.from_numpy(x)
    e, fit, grad = ten.energy_and_grad(ten.params, xt)
    e2, fit2 = ten.energy(ten.params, xt)
    torch.testing.assert_close(e, e2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fit, fit2, rtol=1e-5, atol=1e-6)
    xg = xt.clone().requires_grad_(True)
    ten.energy(ten.params, xg)[0].sum().backward()
    torch.testing.assert_close(grad, xg.grad, rtol=1e-4, atol=1e-5)
    # and the JAX package's energy and gradient on the same inputs
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **E_TOL)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), **E_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gj), **G_TOL)


def test_protein_poe_lambda_composition(rng):
    tp = potts.synthetic(WT, seed=3, device="cpu")
    _, te = _ens(len(WT))
    wt_oh = torch.from_numpy(jcodec.seqs_to_onehot([WT]))
    x = torch.from_numpy(_x(rng, 4, len(WT)))
    en0 = energy.protein_poe(tp, te, 0.0, wt_oh)
    e0, fit = en0.energy(en0.params, x)
    en5 = energy.protein_poe(tp, te, 5.0, wt_oh)
    e5, _ = en5.energy(en5.params, x)
    torch.testing.assert_close(e5 - e0, 5.0 * fit, rtol=1e-4, atol=1e-5)
    # lam=0 energy is the pure potts delta
    torch.testing.assert_close(e0, potts.score(tp, x, delta=True),
                               rtol=1e-5, atol=1e-6)


def test_protein_supervised_matches_jax(rng):
    je, te = _ens(len(WT), seed=1)
    wt_oh = jcodec.seqs_to_onehot([WT])
    jen = jenergy.protein_supervised(je, jnp.asarray(wt_oh))
    ten = energy.protein_supervised(te, torch.from_numpy(wt_oh))
    x = _x(rng, 4, len(WT))
    e, fit, g = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    torch.testing.assert_close(e, fit)
    ej, _, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **E_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **G_TOL)


@pytest.mark.parametrize("chunk", [4, 5])  # 5 does not divide 16: one call
def test_cnn_chunked_energy_matches_full(chunk):
    wt = "ACDEFGHIKLMNPQRSTVWYACDEFGHIKLMN"
    jen, full = _pair(wt, 2.0, seed=0)
    _, chunked = _pair(wt, 2.0, seed=0, cnn_chunk=chunk)
    x = _x(np.random.default_rng(0), 16, len(wt))
    xt = torch.from_numpy(x)
    e0, f0, g0 = full.energy_and_grad(full.params, xt)
    e1, f1, g1 = chunked.energy_and_grad(chunked.params, xt)
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)
    ej, _, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e1.numpy(), np.asarray(ej), **E_TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(gj), **G_TOL)


# ---------------------------------------------------------------------------
# the transformer term
# ---------------------------------------------------------------------------

TINY = dict(layers=2, dim=32, heads=4, ffn=64)
TR_E_TOL = dict(rtol=1e-5, atol=2e-4)
TR_G_TOL = dict(rtol=0, atol=1e-4)


def _experts(wt, tmp_path, seed=5):
    """The same tiny ESM2 expert in both packages, through an npz file
    written by the JAX package."""
    jesm2.CONFIGS["tiny"] = TINY
    esm2.CONFIGS["tiny"] = TINY
    path = str(tmp_path / "tiny.npz")
    jesm2.save_npz_checkpoint(path, jesm2.init(
        jax.random.PRNGKey(seed), "tiny", dtype=jnp.float32, scale=0.3))
    return (jesm2.load_expert("tiny", wt, weights_path=path,
                              dtype=jnp.float32),
            esm2.load_expert("tiny", wt, weights_path=path,
                             dtype=torch.float32, device="cpu"))


def _tr_pair(wt, lam, tmp_path, with_potts=True, **kw):
    jtr, ttr = _experts(wt, tmp_path)
    jp = jpotts.synthetic(wt, seed=3) if with_potts else None
    tp = potts.synthetic(wt, seed=3, device="cpu") if with_potts else None
    je, te = _ens(len(wt))
    wt_oh = jcodec.seqs_to_onehot([wt])
    jkw = {k: v for k, v in kw.items() if k == "chunk_size"}
    return (jenergy.protein_poe(jp, je, lam, jnp.asarray(wt_oh),
                                transformer=jtr, **jkw),
            energy.protein_poe(tp, te, lam, torch.from_numpy(wt_oh),
                               transformer=ttr, **kw))


@pytest.mark.parametrize("with_potts", [True, False])
def test_protein_poe_with_transformer_matches_jax(rng, tmp_path, with_potts):
    jen, ten = _tr_pair(WT, 1.5, tmp_path, with_potts=with_potts)
    assert ("potts" in ten.params) == with_potts and "tr" in ten.params
    x = _x(rng, 5, len(WT))
    xt = torch.from_numpy(x)
    with torch.no_grad():  # as the samplers call it
        e, fit, grad = ten.energy_and_grad(ten.params, xt)
        e2, fit2 = ten.energy(ten.params, xt)
    assert not (e.requires_grad or grad.requires_grad)
    torch.testing.assert_close(e, e2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fit, fit2, rtol=1e-5, atol=1e-6)
    xg = xt.clone().requires_grad_(True)
    ten.energy(ten.params, xg)[0].sum().backward()
    torch.testing.assert_close(grad, xg.grad, rtol=1e-4, atol=1e-5)
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **TR_E_TOL)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), **E_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gj), **TR_G_TOL)
    # the transformer moves the energy and its gradient
    _, plain = _pair(WT, 1.5) if with_potts else (None, energy.protein_poe(
        None, ten.params["sup"], 1.5, ten.wt_onehot))
    e0, _, g0 = plain.energy_and_grad(plain.params, xt)
    assert (e - e0).abs().min() > 1e-2 and (grad - g0).abs().max() > 1e-3


@pytest.mark.parametrize("chunk", [2, 3, 8])  # 3 leaves a ragged last chunk
def test_transformer_chunked_equals_monolithic(rng, tmp_path, chunk):
    jen, full = _tr_pair(WT, 1.0, tmp_path)
    _, chunked = _tr_pair(WT, 1.0, tmp_path, chunk_size=chunk)
    x = _x(rng, 7, len(WT))
    xt = torch.from_numpy(x)
    e0, f0, g0 = full.energy_and_grad(full.params, xt)
    e1, f1, g1 = chunked.energy_and_grad(chunked.params, xt)
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f1, f0, rtol=0, atol=0)
    torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)
    ej, _, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e1.numpy(), np.asarray(ej), **TR_E_TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(gj), **TR_G_TOL)


def test_transformer_term_is_zero_at_the_wild_type(tmp_path):
    _, ten = _tr_pair(WT, 0.0, tmp_path)
    wt_oh = torch.from_numpy(jcodec.seqs_to_onehot([WT]))
    e, _, _ = ten.energy_and_grad(ten.params, wt_oh)
    assert abs(float(e[0])) < 1e-4   # potts delta and PLL delta both vanish
    assert ten.params["tr"]["wt_score"].shape == (1,)
