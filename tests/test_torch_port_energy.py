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
from ppde_tpu_torch.ops import potts_fused

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


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_energy_with_prepared_weights_matches_stacked(rng, dtype):
    """protein_poe keeps kernel B's prepared weights per energy; on a CPU
    tensor it hands the stacked layout on, and the prepared form gives the
    same fitness and gradient through the plain version."""
    from ppde_tpu_torch import energy as tenergy
    from ppde_tpu_torch.models import cnn as tcnn
    from ppde_tpu_torch.ops import cnn_fused

    ens = tcnn.init_ensemble(torch.Generator().manual_seed(0), 3,
                             input_size=16)
    x = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 20, (6, 18))), 20).float()
    once = tenergy._ensemble_once(ens, dtype)
    assert once.get(ens, x) is ens and once.prepared is None
    other = tcnn.init_ensemble(torch.Generator().manual_seed(1), 3,
                               input_size=16)
    assert once.get(other, x) is other
    en = tenergy.protein_supervised(ens, x[:1], compute_dtype=dtype)
    e, fit, g = en.energy_and_grad(en.params, x)
    f1, g1 = cnn_fused.ensemble_apply_and_grad(
        cnn_fused.prepare_ensemble(ens, dtype), x)
    assert torch.equal(fit, f1) and torch.equal(g, g1) and torch.equal(e, fit)
    # an ensemble handed in through params is used, not the prepared one
    _, fit_o, _ = en.energy_and_grad({"sup": other}, x)
    assert not torch.equal(fit_o, fit)


def test_prepared_weights_follow_in_place_updates():
    """The kept prepared weights are made once and made anew after an
    in-place update of a weight (x on the meta device: no CPU tensor, so the
    prepared form is asked for; preparing itself is plain PyTorch)."""
    from ppde_tpu_torch import energy as tenergy
    from ppde_tpu_torch.models import cnn as tcnn

    ens = tcnn.init_ensemble(torch.Generator().manual_seed(0), 3,
                             input_size=16)
    once = tenergy._ensemble_once(ens, torch.bfloat16)
    x = torch.empty((2, 18, 20), device="meta")
    first = once.get(ens, x)
    assert first is not ens and once.get(ens, x) is first
    ens["decoder"]["w"].mul_(2.0)
    second = once.get(ens, x)
    assert second is not first and once.get(ens, x) is second
    want = ens["decoder"]["w"].to(torch.bfloat16).reshape(3, -1)
    assert torch.equal(second.tensors["decw"], want)
    assert not torch.equal(first.tensors["decw"], want)


def _tie_ensembles():
    """A 3-member OnehotCNN ensemble (n_tokens 20, kernel 5, width 8) in
    both packages, from jax.random.split(PRNGKey(0), 3)."""
    from ppde_tpu.models import layers as jlayers

    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    j = jlayers.stack_params([jcnn.init(k, 20, 5, 8) for k in keys])
    return j, convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, j),
                                              "cpu")


@pytest.mark.parametrize("pool_bwd", ["split", "first"])
def test_energy_gradient_matches_jax_for_each_pool_mode(pool_bwd):
    """The gradient of energy(...)[0].sum() equals the JAX package's for
    either pool_bwd: there only energy_and_grad honours the flag, and
    energy's max-pool always splits ties. Two rows of token 0 (every window
    ties in every channel) and two random rows, L = 12. energy_and_grad
    still honours the flag: on the tie rows "first" differs from "split",
    and each mode matches the JAX package's energy_and_grad."""
    je, te = _tie_ensembles()
    L = 12
    toks = np.zeros((4, L), np.int64)
    toks[2:] = np.random.default_rng(0).integers(0, 20, (2, L))
    x = jcodec.ints_to_onehot(toks)
    wt = x[:1]
    pairs = [
        (jenergy.protein_supervised(je, jnp.asarray(wt), pool_bwd=pool_bwd),
         energy.protein_supervised(te, torch.from_numpy(wt),
                                   pool_bwd=pool_bwd)),
        (jenergy.protein_poe(None, je, 2.0, jnp.asarray(wt),
                             pool_bwd=pool_bwd),
         energy.protein_poe(None, te, 2.0, torch.from_numpy(wt),
                            pool_bwd=pool_bwd))]
    for jen, ten in pairs:
        gj = jax.grad(lambda v: jen.energy(jen.params, v)[0].sum())(
            jnp.asarray(x))
        xg = torch.from_numpy(x).requires_grad_(True)
        ten.energy(ten.params, xg)[0].sum().backward()
        np.testing.assert_allclose(xg.grad.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-6)
        _, _, g = ten.energy_and_grad(ten.params, torch.from_numpy(x))
        _, _, gj2 = jen.energy_and_grad(jen.params, jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(gj2), rtol=0,
                                   atol=1e-6)
        # energy_and_grad routes by the flag, energy always splits
        split = pool_bwd == "split"
        assert np.allclose(g[:2].numpy(), xg.grad[:2].numpy(),
                           atol=1e-6) == split


def test_prepared_potts_planes_follow_in_place_updates():
    """protein_poe keeps kernel A's planes: made once, and made anew after
    an in-place update of W (x on the meta device, as in the test above;
    the split itself is plain PyTorch)."""
    tp = potts.synthetic(WT, seed=3, device="cpu")
    once = energy._potts_once(tp)
    x = torch.empty((2, len(WT), 20), device="meta")
    assert once.get(tp, torch.zeros((2, len(WT), 20))) is tp  # CPU: plain
    first = once.get(tp, x)
    assert isinstance(first, potts_fused.Prepared)
    assert first.planes.shape == (3,) + tuple(tp.W.shape)
    assert once.get(tp, x) is first
    tp.W.mul_(2.0)
    second = once.get(tp, x)
    assert second is not first and once.get(tp, x) is second
    assert torch.equal(second.planes.float().sum(0), tp.W)
    other = potts.synthetic(WT, seed=4, device="cpu")
    assert once.get(other, x) is other
    # and the energy's gradient on the CPU is the same with a kept Prepared
    en = energy.protein_poe(tp, _ens(len(WT))[1], 2.0,
                            torch.from_numpy(jcodec.seqs_to_onehot([WT])))
    xs = torch.from_numpy(_x(np.random.default_rng(1), 3, len(WT)))
    _, _, g = en.energy_and_grad(en.params, xs)
    prep = potts_fused.prepare(tp.W, tp.h)
    s0, g0 = potts.score_and_grad(tp, xs)
    s1, g1 = potts.score_and_grad(tp, xs, prepared=prep)
    assert torch.equal(s0, s1) and torch.equal(g0, g1)
    assert g.shape == xs.shape


def test_protein_poe_at_300_residues_matches_jax(tmp_path):
    """A wild type past 256 residues (drawn from a numpy seed) with the
    reference-width CNN (C = L = 300), the Potts term and the tiny ESM2
    expert (T = 300): on the card the path of kernel B's wide kernel and
    the key-tiled kernels C and C'; here the plain versions against the JAX
    package's energy_and_grad. The Potts gradient sums 6,000 couplings a
    entry (entries up to about 30): gradients are held at the transformer
    tolerance plus rtol 1e-5, float32's rounding of such sums."""
    rng = np.random.default_rng(300)
    wt = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[
        rng.integers(0, 20, 300)])
    jen, ten = _tr_pair(wt, 1.5, tmp_path)
    assert ten.params["sup"]["embed"]["w"].shape[-2:] == (300, 600)
    x = jcodec.seqs_to_onehot([wt])
    x = np.concatenate([x, _x(rng, 2, 300)])
    x[0, 7] = np.roll(x[0, 7], 3)  # one mutation of the wild type
    with torch.no_grad():
        e, fit, grad = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **TR_E_TOL)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), **E_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gj),
                               **dict(TR_G_TOL, rtol=1e-5))
