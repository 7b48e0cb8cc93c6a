"""ppde_tpu_torch.parallel.pipeline (GPipe over send / recv) on the CPU.

Mirrors ``tests/test_pipeline.py``: the pipelined forward for (pp, dp,
n_mb) as the JAX tests parametrise it, against the JAX package's
single-device ``esm2.forward_logits`` on the same weights (rtol / atol
1e-5), the pipelined PLL and its dE/dx (rtol 1e-4 / atol 1e-5; the layers'
gradients too, against the port's single-device ones), remat (1e-6) and
the divisibility errors. Ranks are spawned under gloo (one thread each,
the process group over a file under ``tmp_path``), one spawn per world
size. The module's top level imports no JAX: the spawned ranks import it.
"""
import functools

import numpy as np
import pytest
import torch

from ppde_tpu_torch import convert
from ppde_tpu_torch.models import esm2
from ppde_tpu_torch.parallel import mesh as pmesh, pipeline

from test_torch_port_parallel import np_, spawn

TINY = dict(layers=4, dim=64, heads=4, ffn=128)


@functools.lru_cache(maxsize=None)
def jax_case(B, T, seed, layers=4, grad=False):
    """The JAX tests' tiny float32 ESM2 (PRNGKey(0)) and one-hot batch, and
    its single-device logits (with ``grad``: its PLL and dPLL/dx)."""
    import jax
    import jax.numpy as jnp

    from ppde_tpu.models import esm2 as jesm2

    jesm2.CONFIGS["_tiny"] = dict(TINY, layers=layers)
    try:
        params = jesm2.init(jax.random.PRNGKey(0), "_tiny",
                            dtype=jnp.float32)
    finally:
        del jesm2.CONFIGS["_tiny"]
    toks = jax.random.randint(jax.random.PRNGKey(seed), (B, T), 4, 24)
    x = jax.nn.one_hot(toks, jesm2.ESM_VOCAB, dtype=jnp.float32)
    ref = {"logits": np.asarray(jax.jit(
        lambda p, v: jesm2.forward_logits(p, v, heads=4))(params, x))}
    if grad:
        def pll(v):
            return jesm2.pseudo_log_likelihood(params, v, heads=4)

        ref["pll"] = np.asarray(jax.jit(pll)(x))
        ref["dx"] = np.asarray(jax.jit(jax.grad(lambda v: pll(v).sum()))(x))
    return jax.tree.map(np.asarray, params), np.asarray(x), ref


def _params(tree):
    return convert.esm2_from_numpy(tree, "cpu")


def _forward(params, x, pp, dp, n_mb, **kw):
    mesh = pmesh.make_mesh(dp=dp, pp=pp, device="cpu")
    return pipeline.forward_logits_pp(pipeline.pipeline_params(params, pp),
                                      x, mesh, heads=4, n_microbatches=n_mb,
                                      **kw)


def _ranks(rank, cases, grad_case, tree3):
    got = {}
    for (pp, dp, n_mb), (tree, x) in cases.items():
        got[(pp, dp, n_mb)] = np_(_forward(_params(tree), torch.from_numpy(x),
                                           pp, dp, n_mb))
    if grad_case is not None:
        (pp, dp, n_mb), (tree, x) = grad_case
        x = torch.from_numpy(x)
        params = _params(tree)
        leaves = [params["layers"][1]["fc1"]["w"], params["embed"]]
        for leaf in leaves:
            leaf.requires_grad_(True)
        mesh = pmesh.make_mesh(dp=dp, pp=pp, device="cpu")
        pparams = pipeline.pipeline_params(params, pp)
        xg = x.clone().requires_grad_(True)
        pll = pipeline.pseudo_log_likelihood_pp(pparams, xg, mesh, heads=4,
                                                n_microbatches=n_mb)
        g_x, g_fc1, g_embed = torch.autograd.grad(
            pll.sum(), [xg, pparams["layers_stacked"]["fc1"]["w"],
                        params["embed"]])
        xg = x.clone().requires_grad_(True)
        ref = esm2.pseudo_log_likelihood(params, xg, 4)
        r_x, r_fc1, r_embed = torch.autograd.grad(ref.sum(),
                                                  [xg] + leaves)
        got["grad"] = [np_(a) for a in (pll, g_x, g_fc1[1], g_embed, ref,
                                        r_x, r_fc1, r_embed)]
        base = _forward(params, x, pp, dp, n_mb)
        rem = _forward(params, x, pp, dp, n_mb, remat=True)
        got["remat"] = (np_(base), np_(rem))
        xg = x.clone().requires_grad_(True)
        (g_rem,) = torch.autograd.grad(pipeline.pseudo_log_likelihood_pp(
            pparams, xg, mesh, heads=4, n_microbatches=n_mb,
            remat=True).sum(), xg)
        got["remat_grad"] = np_(g_rem)
        # dPLL/dx with every weight frozen (no layer gradient to sum)
        xg = x.clone().requires_grad_(True)
        (g_fz,) = torch.autograd.grad(pipeline.pseudo_log_likelihood_pp(
            pipeline.pipeline_params(_params(tree), pp), xg, mesh, heads=4,
            n_microbatches=n_mb).sum(), xg)
        got["frozen_grad"] = np_(g_fz)
    if tree3 is not None:
        params3 = _params(tree3)
        try:
            pipeline.pipeline_params(params3, 2)
        except ValueError as e:
            got["layers_err"] = str(e)
        tree, x = next(iter(cases.values()))
        try:
            _forward(_params(tree), torch.from_numpy(x[:6]), 2, 1, 4)
        except ValueError as e:
            got["mb_err"] = str(e)
    return got


def test_stack_layers_roundtrip():
    esm2.CONFIGS["_tiny"] = dict(TINY)
    try:
        params = esm2.init(torch.Generator().manual_seed(0), "_tiny",
                           torch.float32)
    finally:
        del esm2.CONFIGS["_tiny"]
    stacked = pipeline.stack_layers(params["layers"])
    assert stacked["q"]["w"].shape[0] == 4
    for k in ("q", "fc2"):
        for leaf in ("w", "b"):
            torch.testing.assert_close(stacked[k][leaf][2],
                                       params["layers"][2][k][leaf],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("world,cases", [
    (2, [(2, 1, 4)]),
    (4, [(2, 2, 2), (4, 1, 4)]),
    (8, [(4, 2, 4)]),
], ids=["world2", "world4", "world8"])
def test_pipeline_matches_single_device(world, cases, tmp_path):
    """Logits of the pipeline for (pp, dp, n_mb) equal the JAX package's
    single-device forward (B = 8, T = 12); on 2 ranks also the PLL, dE/dx
    (with the weights trained and frozen) and the layers' gradients through
    the pipeline, remat and the
    divisibility errors (``test_pipeline_pll_matches_and_is_
    differentiable``, ``test_pipeline_remat_equal``,
    ``test_pipeline_validates_divisibility``)."""
    tree, x, ref = jax_case(8, 12, seed=0)
    grad_case = tree3 = None
    if world == 2:
        gtree, gx, gref = jax_case(4, 10, seed=3, grad=True)
        grad_case = ((2, 1, 2), (gtree, gx))
        tree3 = jax_case(1, 4, seed=0, layers=3)[0]
    got_all = spawn(_ranks, world, tmp_path,
                    {c: (tree, x) for c in cases}, grad_case, tree3)
    for got in got_all:
        for c in cases:
            np.testing.assert_allclose(got[c], ref["logits"], rtol=1e-5,
                                       atol=1e-5)
        if world != 2:
            continue
        pll, g_x, g_fc1, g_embed, r, r_x, r_fc1, r_embed = got["grad"]
        np.testing.assert_allclose(pll, gref["pll"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g_x, gref["dx"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_x, r_x, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_fc1, r_fc1, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_embed, r_embed, rtol=1e-4, atol=1e-5)
        base, rem = got["remat"]
        np.testing.assert_allclose(rem, base, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["remat_grad"], g_x, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["frozen_grad"], gref["dx"],
                                   rtol=1e-4, atol=1e-5)
        assert "not divisible" in got["layers_err"]
        assert "microbatches" in got["mb_err"]
