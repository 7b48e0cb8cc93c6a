"""ppde_tpu_torch's parallel tempering (samplers/pt_core.py,
samplers/protein/pt.py, ppde.make_step(tempered=True)) against ppde_tpu's.

Held three ways, as the PPDE slice is: the ladder and the exchange phase on
the same inputs and the JAX package's own uniforms; a whole PT run with the
JAX package's draws replayed (tokens, swaps and bests equal, energies at
rtol 1e-5 / atol 1e-4: float32 sums in another order than XLA's); and the
gold test of tests/test_pt.py on the port's own generator (every level
within 0.15 exact std of its tempered Boltzmann mean)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy
from ppde_tpu.models import cnn as jcnn, potts as jpotts
from ppde_tpu.samplers import base as jbase, pt_core as jpt_core
from ppde_tpu.samplers.protein import pt as jpt
from ppde_tpu_torch import convert, energy, utils
from ppde_tpu_torch.samplers import base, pt_core
from ppde_tpu_torch.samplers.protein import ppde, pt

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRSTVWY"  # 20 residues
E_TOL = dict(rtol=1e-5, atol=1e-4)


def _energies(lam=1.0, seed=0):
    """The same Potts + CNN product of experts in both packages."""
    jp = jpotts.synthetic(WT, min_pos=2, max_pos=17, seed=seed,
                          coupling_scale=0.1, field_scale=0.5)
    je = jcnn.init_ensemble(jax.random.PRNGKey(seed), 3, input_size=len(WT))
    wt_oh = jcodec.seqs_to_onehot([WT])
    jen = jenergy.protein_poe(jp, je, lam, jnp.asarray(wt_oh))
    ten = energy.protein_poe(
        convert.potts_from_numpy(
            *jax.tree.map(np.asarray, (jp.W, jp.h, jp.wt_H)), jp.seq_len,
            jp.min_pos, jp.max_pos, device="cpu"),
        convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, je), "cpu"),
        lam, torch.from_numpy(wt_oh))
    return jen, ten, wt_oh


class Replay:
    """Hands out a queue of the JAX package's draws through the port's
    ``Draws`` methods, checking each shape."""

    def __init__(self, queue):
        self.queue = [np.array(a) for a in queue][::-1]

    def _next(self, shape=None):
        a = torch.from_numpy(self.queue.pop())
        if shape is not None:
            assert tuple(a.shape) == tuple(np.atleast_1d(shape)), a.shape
        return a

    def path_lengths(self, n, high):
        return self._next((n,)).long()

    def gumbel(self, shape):
        return self._next(shape)

    def uniform(self, shape):
        return self._next(shape)


def ppde_step_draws(k, n, L, V, pas_length):
    """The draws of one JAX PPDE step from its key, in the port's order."""
    max_u = max(2 * pas_length - 1, 1)
    k_u, k_inner, k_acc = jax.random.split(k, 3)
    out = [jax.random.randint(k_u, (n,), 1, 2 * pas_length)]
    for ki in jax.random.split(k_inner, max_u):
        k1, k2 = jax.random.split(ki)
        out += [jax.random.gumbel(k1, (n, L)), jax.random.gumbel(k2, (n, V))]
    return out + [jax.random.uniform(k_acc, (n,))]


def pt_run_draws(key, num_steps, log_every, n, L, V, pas_length, K):
    """run_segmented's key splits, then per step split(key) -> the move's
    PPDE draws and the [K, M] swap uniforms."""
    queue = []
    for length in jbase.segment_lengths(num_steps, log_every):
        key, seg_key = jax.random.split(key)
        for k in jax.random.split(seg_key, length):
            k_move, k_swap = jax.random.split(k)
            queue += ppde_step_draws(k_move, n, L, V, pas_length)
            queue.append(jax.random.uniform(k_swap, (K, n // K)))
    return queue


# ---------------------------------------------------------------------------
# ladder and exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K,beta_min", [(32, 4, 0.25), (16, 1, 0.5),
                                          (24, 3, 1.0), (128, 8, 0.1)])
def test_ladder_matches_jax(n, K, beta_min):
    b = pt_core.ladder(n, K, beta_min)
    np.testing.assert_array_equal(b, jpt_core.ladder(n, K, beta_min))
    assert b.dtype == np.float32
    cfg = pt.PTConfig(n_levels=K, beta_min=beta_min)
    np.testing.assert_array_equal(pt.ladder(n, cfg),
                                  jpt.ladder(n, jpt.PTConfig(
                                      n_levels=K, beta_min=beta_min)))


def test_ladder_rejects_bad_arguments():
    with pytest.raises(ValueError):
        pt_core.ladder(30, 4, 0.25)
    with pytest.raises(ValueError):
        pt_core.ladder(32, 4, 0.0)


@pytest.mark.parametrize("swap_every", [1, 3])
def test_exchange_matches_jax_with_replayed_uniforms(swap_every):
    """Every parity and gate over 6 counts: the exchange by index gives the
    JAX package's one-hot-permutation exchange exactly (the swapped arrays
    of several dtypes and trailing shapes, and n_swapped)."""
    K, M = 4, 5
    n = K * M
    rng = np.random.default_rng(0)
    beta = pt_core.ladder(n, K, 0.3)
    x = rng.normal(size=(n, 3, 2)).astype(np.float32)
    toks = rng.integers(0, 9, (n, 7)).astype(np.int32)
    jphase = jpt_core.make_exchange(n, K, swap_every)
    tphase = pt_core.make_exchange(n, K, swap_every, "cpu")
    total = 0
    for count in range(6):
        e = rng.normal(scale=2.0, size=n).astype(np.float32)
        key = jax.random.PRNGKey(count)
        (jx, jt, je), jn = jphase(jnp.asarray(beta), jnp.asarray(e),
                                  jnp.asarray(count), key,
                                  [jnp.asarray(x), jnp.asarray(toks),
                                   jnp.asarray(e)])
        draws = Replay([jax.random.uniform(key, (K, M))])
        (tx, tt, te), tn = tphase(torch.from_numpy(beta), torch.from_numpy(e),
                                  count, draws,
                                  [torch.from_numpy(x), torch.from_numpy(toks),
                                   torch.from_numpy(e)])
        assert not draws.queue
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert int(tn) == int(jn)
        total += int(tn)
        x, toks = tx.numpy(), tt.numpy()
    assert total > 0


# ---------------------------------------------------------------------------
# the tempered step and whole runs
# ---------------------------------------------------------------------------

def test_tempered_step_beta1_equals_plain_step():
    """make_step(tempered=True) at beta == 1 gives the plain step's values
    bit for bit on the same draws."""
    _, en, wt_oh = _energies()
    n, L, V = 8, len(WT), 20
    pop = torch.from_numpy(wt_oh).repeat(n, 1, 1)
    window_ok = utils.position_window_mask(L, V, 2, 17)
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=5)
    e0, f0, g0 = en.energy_and_grad(en.params, pop)
    ctx = {"energy": en.params, "wt": pop[0], "init_x": pop,
           "wt_e": e0[0], "wt_fit": f0[0], "wt_grad": g0[0]}
    state = (pop, (e0, f0, g0), (e0, f0, pop))
    plain = ppde.make_step(en, cfg, window_ok, n, L, V)
    temp = ppde.make_step(en, cfg, window_ok, n, L, V, tempered=True)
    for _ in range(3):
        s1, y1 = plain(ctx, state,
                       base.Draws(torch.Generator().manual_seed(5)))
        s2, y2 = temp(dict(ctx, beta=torch.ones(n)), state,
                      base.Draws(torch.Generator().manual_seed(5)))
        for a, b in zip(jax.tree_util.tree_leaves((s1, y1)),
                        jax.tree_util.tree_leaves((s2, y2))):
            assert torch.equal(a, b)
        state = s1


def test_pt_run_matches_jax_with_injected_draws():
    """12 steps of 8 chains on 4 levels (swap_every 2): the same draws give
    the same tokens, swaps, accepts and bests; energies within float32."""
    jen, ten, wt_oh = _energies()
    n, K, steps, log_every = 8, 4, 12, 6
    pop = np.repeat(wt_oh, n, 0)
    kw = dict(pas_length=2, nmut_threshold=4, n_levels=K, beta_min=0.3,
              swap_every=2)
    key = jax.random.PRNGKey(7)
    rj = jpt.run(jen, jnp.asarray(pop), steps, 2, 17, cfg=jpt.PTConfig(**kw),
                 key=key, log_every=log_every, quiet=True)
    draws = Replay(pt_run_draws(key, steps, log_every, n, len(WT), 20, 2, K))
    rt = pt.run(ten, pop, steps, 2, 17, cfg=pt.PTConfig(**kw), draws=draws,
                log_every=log_every, quiet=True, device="cpu")
    assert not draws.queue
    np.testing.assert_array_equal(rt.n_accepted, rj.n_accepted)
    assert 0 < rt.n_accepted.sum() < steps * n
    np.testing.assert_array_equal(rt.random_traj, rj.random_traj)
    np.testing.assert_array_equal(rt.final_x, rj.final_x)
    np.testing.assert_array_equal(rt.best_x, rj.best_x)
    for a, b in ((rt.energy_history, rj.energy_history),
                 (rt.fitness_history, rj.fitness_history),
                 (rt.best_energy, rj.best_energy)):
        np.testing.assert_allclose(a, np.asarray(b), **E_TOL)


def test_pt_swap_records_match_jax():
    """The n_swapped record of the exchange phase inside the step: a
    segment of the JAX package's step against the port's, swaps counted."""
    jen, ten, wt_oh = _energies()
    n, K, L, V = 8, 4, len(WT), 20
    pop = np.repeat(wt_oh, n, 0)
    cfg_kw = dict(pas_length=1, n_levels=K, beta_min=0.1)
    jwin = jnp.asarray(np.asarray(utils.position_window_mask(L, V, 2, 17)))
    jstep = jpt.make_pt_step(jen, jpt.PTConfig(**cfg_kw), jwin, n, L, V)
    tstep = pt.make_pt_step(ten, pt.PTConfig(**cfg_kw),
                            utils.position_window_mask(L, V, 2, 17), n, L, V)

    def ctx_state(en, x, beta, arr):
        e0, f0, g0 = en.energy_and_grad(en.params, x)
        ctx = {"energy": en.params, "wt": x[0], "init_x": x, "beta": beta,
               "wt_e": e0[0], "wt_fit": f0[0], "wt_grad": g0[0]}
        return ctx, ((x, (e0, f0, g0), (e0, f0, x)), arr(0))

    jctx, jstate = ctx_state(jen, jnp.asarray(pop),
                             jnp.asarray(pt.ladder(n, pt.PTConfig(**cfg_kw))),
                             lambda c: jnp.asarray(c, jnp.int32))
    tctx, tstate = ctx_state(ten, torch.from_numpy(pop),
                             torch.from_numpy(pt.ladder(n, pt.PTConfig(
                                 **cfg_kw))), int)
    swaps = 0
    with torch.no_grad():
        for i, k in enumerate(jax.random.split(jax.random.PRNGKey(3), 10)):
            jstate, jys = jax.jit(jstep)(jctx, jstate, k)
            k_move, k_swap = jax.random.split(k)
            draws = Replay(ppde_step_draws(k_move, n, L, V, 1)
                           + [jax.random.uniform(k_swap, (K, n // K))])
            tstate, tys = tstep(tctx, tstate, draws)
            assert int(tys["n_swapped"]) == int(jys["n_swapped"])
            swaps += int(tys["n_swapped"])
            np.testing.assert_array_equal(tstate[0][0].numpy(),
                                          np.asarray(jstate[0][0]))
            assert tstate[1] == i + 1
    assert swaps > 0


def _quad_energy(seed=3, L=4, V=4):
    """The enumerable 256-state quadratic target of tests/test_pt.py."""
    rng = np.random.default_rng(seed)
    D = L * V
    J = rng.normal(0, 0.6, (D, D))
    J = (J + J.T) / 2
    for i in range(L):
        J[i * V:(i + 1) * V, i * V:(i + 1) * V] = 0.0
    h = rng.normal(0, 0.8, D)
    Jb = {"J": torch.from_numpy(J.astype(np.float32)),
          "h": torch.from_numpy(h.astype(np.float32))}

    def e_fn(p, x):
        xf = x.reshape(x.shape[0], -1)
        e = 0.5 * ((xf @ p["J"]) * xf).sum(-1) + xf @ p["h"]
        return e, e

    def e_and_grad(p, x):
        e, _ = e_fn(p, x)
        xf = x.reshape(x.shape[0], -1)
        return e, e, (xf @ p["J"] + p["h"][None]).reshape(x.shape)

    en = energy.Energy(params=Jb, energy=e_fn, energy_and_grad=e_and_grad,
                       fitness=lambda p, x: e_fn(p, x)[0])
    toks = np.array(np.meshgrid(*([range(V)] * L),
                                indexing="ij")).reshape(L, -1).T
    states = np.eye(V, dtype=np.float32)[toks].reshape(-1, D)
    es = 0.5 * np.einsum("nd,de,ne->n", states, J, states) + states @ h
    return en, es, (L, V)


def test_pt_every_level_samples_its_tempered_boltzmann():
    """Gold test (tests/test_pt.py:287, at its size): full PT on the
    enumerable quadratic target; each level's mean energy within 0.15 exact
    std of the exact mean of pi_l ~ exp(beta_l * E)."""
    en, es, (L, V) = _quad_energy()
    K, M = 4, 16
    n = K * M
    cfg = pt.PTConfig(pas_length=1, n_levels=K, beta_min=0.25)
    rng = np.random.default_rng(5)
    x0 = np.eye(V, dtype=np.float32)[rng.integers(0, V, (n, L))]
    n_steps, burn = 3000, 600
    res = pt.run(en, x0, n_steps, min_pos=0, max_pos=L - 1, cfg=cfg,
                 generator=torch.Generator().manual_seed(11),
                 log_every=n_steps, quiet=True, device="cpu")
    betas = pt.ladder(n, cfg).reshape(K, M)[:, 0]
    hist = res.energy_history[burn:]
    for lvl in range(K):
        p = np.exp(betas[lvl] * es - (betas[lvl] * es).max())
        p /= p.sum()
        mean = (p * es).sum()
        std = np.sqrt((p * (es - mean) ** 2).sum())
        gap = (hist[:, lvl * M:(lvl + 1) * M].mean() - mean) / std
        assert abs(gap) < 0.15, (lvl, betas[lvl], gap)


def test_pt_nmut_hard_constraint_all_levels_and_shapes():
    _, en, wt_oh = _energies()
    n = 16
    pop = np.repeat(wt_oh, n, 0)
    cfg = pt.PTConfig(pas_length=3, nmut_threshold=3, n_levels=4,
                      beta_min=0.3)
    res = pt.run(en, pop, 40, 2, 17, cfg=cfg, oracle=None,
                 generator=torch.Generator().manual_seed(3), log_every=20,
                 quiet=True, device="cpu")
    wt = torch.from_numpy(wt_oh[0])
    assert utils.mut_distance(torch.from_numpy(res.best_x), wt).max() <= 3
    assert utils.mut_distance(torch.from_numpy(res.final_x), wt).max() < 3
    assert res.energy_history.shape == (41, n)
    assert res.random_traj.shape == (41, len(WT), 20)
    assert (res.final_x[:, :2] == wt_oh[0][None, :2]).all()
    assert (res.final_x[:, 18:] == wt_oh[0][None, 18:]).all()
    assert np.all(res.best_energy >= res.energy_history.max(0) - 1e-4)


def test_pt_rejects_paper_mode():
    _, en, wt_oh = _energies()
    with pytest.raises(ValueError, match="paper_results"):
        pt.run(en, np.repeat(wt_oh, 8, 0), 4, 2, 17,
               cfg=pt.PTConfig(paper_results=True, n_levels=4), quiet=True,
               device="cpu")
