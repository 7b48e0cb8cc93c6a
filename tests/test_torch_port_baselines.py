"""ppde_tpu_torch's protein baselines (samplers/protein/sa.py,
random_search.py, mala_approx.py, cmaes.py, samplers/cma_core.py) against
ppde_tpu's, mirroring tests/test_baseline_samplers.py.

SA, Random and MALA-approx run on the JAX package's own draws, replayed
through the port's ``Draws`` interface: the same tokens; energies at rtol
1e-5 / atol 1e-4 (float32 sums in another order than XLA's; MALA's logits
carry the gradient's last-bit differences from step to step). CMA-ES is
numpy-seeded in both packages: the same ``ask()`` bit for bit and the same
top-K archive."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy
from ppde_tpu.models import cnn as jcnn, potts as jpotts
from ppde_tpu.samplers import base as jbase, cma_core as jcma_core
from ppde_tpu.samplers.protein import cmaes as jcmaes
from ppde_tpu.samplers.protein import mala_approx as jmala
from ppde_tpu.samplers.protein import random_search as jrandom, sa as jsa
from ppde_tpu_torch import convert, energy, utils
from ppde_tpu_torch.samplers import base, cma_core
from ppde_tpu_torch.samplers.protein import cmaes, mala_approx
from ppde_tpu_torch.samplers.protein import random_search, sa

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRSTVWY"  # 20 residues
L, V = len(WT), 20
E_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    """The same Potts + CNN product of experts in both packages, and the
    wild-type population of 8 chains."""
    jp = jpotts.synthetic(WT, min_pos=2, max_pos=17, seed=0,
                          coupling_scale=0.1, field_scale=0.5)
    je = jcnn.init_ensemble(jax.random.PRNGKey(0), 3, input_size=len(WT))
    wt_oh = jcodec.seqs_to_onehot([WT])
    jen = jenergy.protein_poe(jp, je, 1.0, jnp.asarray(wt_oh))
    tp = convert.potts_from_numpy(
        *jax.tree.map(np.asarray, (jp.W, jp.h, jp.wt_H)), jp.seq_len,
        jp.min_pos, jp.max_pos, device="cpu")
    ten = energy.protein_poe(
        tp, convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, je),
                                            "cpu"),
        1.0, torch.from_numpy(wt_oh))
    return jen, ten, np.repeat(wt_oh, 8, 0), (jp, tp)


class Replay:
    """Hands out a queue of the JAX package's draws through the port's
    ``Draws`` methods, checking each shape."""

    def __init__(self, queue):
        self.queue = [np.array(a) for a in queue][::-1]

    def _next(self, shape):
        a = torch.from_numpy(self.queue.pop())
        assert tuple(a.shape) == tuple(np.atleast_1d(shape)), a.shape
        return a

    def gumbel(self, shape):
        return self._next(shape)

    def uniform(self, shape):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)

    def poisson(self, rate):
        return self._next(rate.shape).float()

    def randint(self, high, shape):
        return self._next(shape).long()


def propose_draws(key, mu, n, max_edits):
    """sa.propose's draws from its key: split 3 -> Poisson, Gumbel, values."""
    k_pois, k_pos, k_aa = jax.random.split(key, 3)
    return [jax.random.poisson(k_pois, mu - 1.0),
            jax.random.gumbel(k_pos, (n, L)),
            jax.random.randint(k_aa, (n, max_edits), 0, V - 1)]


def run_draws(key, num_steps, log_every, n, per_step, with_mu=True):
    """A run's draws: the mu uniforms (SA, Random), then run_segmented's key
    splits, per step ``per_step(step_key, mu)``."""
    queue, mu = [], None
    if with_mu:
        key, k_mu = jax.random.split(key)
        u = jax.random.uniform(k_mu, (n,))
        queue.append(u)
        mu = 1.5 * u + 1.0
    for length in jbase.segment_lengths(num_steps, log_every):
        key, seg_key = jax.random.split(key)
        for k in jax.random.split(seg_key, length):
            queue += per_step(k, mu)
    return queue


def _same_run(rt, rj, steps, n):
    np.testing.assert_array_equal(rt.random_traj, rj.random_traj)
    np.testing.assert_array_equal(rt.final_x, np.asarray(rj.final_x))
    np.testing.assert_array_equal(rt.best_x, rj.best_x)
    for a, b in ((rt.energy_history, rj.energy_history),
                 (rt.fitness_history, rj.fitness_history),
                 (rt.best_energy, rj.best_energy),
                 (rt.oracle_history, rj.oracle_history)):
        np.testing.assert_allclose(a, np.asarray(b), **E_TOL)
    assert rt.energy_history.shape == (steps + 1, n)


def _oracles(setup):
    jp, tp = setup[3]
    from ppde_tpu_torch.models import potts
    return ((jp, lambda p, x: jpotts.score(p, x, delta=True)),
            (tp, lambda p, x: potts.score(p, x, delta=True)))


# ---------------------------------------------------------------------------
# SA, Random, MALA-approx with the JAX package's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_pos,max_pos,max_edits",
                         [(2, 17, 12), (4, 9, 12), (0, 19, 3)])
def test_sa_propose_matches_jax(min_pos, max_pos, max_edits):
    """The proposal on JAX's draws: distinct positions (ties at -inf broken
    by index when the window is narrower than max_edits), a different amino
    acid each, the same one-hots."""
    n = 16
    rng = np.random.default_rng(min_pos)
    x = jcodec.ints_to_onehot(rng.integers(0, V, (n, L)))
    mu = jnp.asarray(np.linspace(1.0, 9.0, n), jnp.float32)
    key = jax.random.PRNGKey(max_pos)
    yj = np.asarray(jsa.propose(key, jnp.asarray(x), mu, min_pos, max_pos,
                                max_edits))
    draws = Replay(propose_draws(key, mu, n, max_edits))
    yt = sa.propose(draws, torch.from_numpy(x), torch.from_numpy(
        np.array(mu)), min_pos, max_pos, max_edits)
    assert not draws.queue
    np.testing.assert_array_equal(yt.numpy(), yj)
    changed = (yt.numpy() != x).any(-1)
    assert changed.any()
    if max_pos - min_pos + 1 >= max_edits:
        assert not changed[:, :min_pos].any()
        assert not changed[:, max_pos + 1:].any()


def test_sa_run_matches_jax_with_injected_draws(setup):
    jen, ten, pop, _ = setup
    n, steps, log_every = pop.shape[0], 20, 10
    cfg_kw = dict(temp=1.0, nmut_threshold=4)
    key = jax.random.PRNGKey(3)
    joracle, toracle = _oracles(setup)
    rj = jsa.run(jen, jnp.asarray(pop), steps, 2, 17, oracle=joracle,
                 cfg=jsa.SAConfig(**cfg_kw), key=key, log_every=log_every,
                 quiet=True)

    def per_step(k, mu):
        k_prop, k_acc = jax.random.split(k)
        return (propose_draws(k_prop, mu, n, 12)
                + [jax.random.uniform(k_acc, (n,))])

    draws = Replay(run_draws(key, steps, log_every, n, per_step))
    rt = sa.run(ten, pop, steps, 2, 17, oracle=toracle,
                cfg=sa.SAConfig(**cfg_kw), draws=draws, log_every=log_every,
                quiet=True, device="cpu")
    assert not draws.queue
    _same_run(rt, rj, steps, n)
    np.testing.assert_array_equal(rt.n_accepted, rj.n_accepted)
    assert 0 < rt.n_accepted.sum() < steps * n
    d = utils.mut_distance(torch.from_numpy(rt.best_x),
                           torch.from_numpy(pop[0]))
    assert d.max() <= 4


def test_sa_rejection_resets_to_initial(setup):
    """With T -> 0 a proposal that lowers the energy is rejected, and a
    rejected chain holds the INITIAL population (reference :104), not its
    previous state; its recorded energy carries the previous value."""
    _, ten, pop, _ = setup
    x0 = torch.from_numpy(pop).clone()
    x0[1:, 5] = torch.eye(V)[3]  # chains 1.. start one mutation off WT
    cfg = sa.SAConfig(temp=1e-6)
    mu = torch.full((8,), 2.0)
    step = sa.make_step(ten, cfg, 2, 17, 8)
    with torch.no_grad():
        e0, f0 = ten.energy(ten.params, x0)
        ctx = {"energy": ten.params, "wt": x0[0], "init_x": x0, "mu": mu}
        state = (x0, e0, f0, 0, (e0, f0, x0))
        draws = base.Draws(torch.Generator().manual_seed(2))
        saw = 0
        for _ in range(6):
            prev_e = state[1]
            state, ys = step(ctx, state, draws)
            rej = ~ys["accepted"]
            saw += int(rej.sum())
            assert torch.equal(state[0][rej], x0[rej])
            assert torch.equal(state[1][rej], prev_e[rej])
            assert (ys["energy"] > -1e29).all()
    assert saw > 0 and state[3] == 6


def test_random_run_matches_jax_with_injected_draws(setup):
    jen, ten, pop, _ = setup
    n, steps, log_every = pop.shape[0], 20, 10
    key = jax.random.PRNGKey(5)
    joracle, toracle = _oracles(setup)
    rj = jrandom.run(jen, jnp.asarray(pop), steps, 2, 17, oracle=joracle,
                     key=key, log_every=log_every, quiet=True)
    draws = Replay(run_draws(key, steps, log_every, n,
                             lambda k, mu: propose_draws(k, mu, n, 12)))
    rt = random_search.run(ten, pop, steps, 2, 17, oracle=toracle,
                           draws=draws, log_every=log_every, quiet=True,
                           device="cpu")
    assert not draws.queue
    _same_run(rt, rj, steps, n)
    d = utils.mut_distance(torch.from_numpy(rt.final_x),
                           torch.from_numpy(pop[0]))
    assert 0 < d.max() <= 12


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_mala_run_matches_jax_with_injected_draws(setup, compute_dtype):
    """Autograd through energy.energy (float32, and the bf16 CNN) on JAX's
    Gumbel and normal noise: the same tokens every step."""
    jen, ten, pop, (jp, tp) = setup
    if compute_dtype:
        je = jen.params["sup"]
        jen = jenergy.protein_poe(jp, je, 1.0, jnp.asarray(pop[:1]),
                                  compute_dtype=jnp.bfloat16)
        ten = energy.protein_poe(tp, ten.params["sup"], 1.0,
                                 torch.from_numpy(pop[:1]),
                                 compute_dtype=torch.bfloat16)
    n, steps, log_every = pop.shape[0], 12, 6
    kw = dict(step_size=0.5, relaxation_tau=0.9)
    key = jax.random.PRNGKey(6)
    joracle, toracle = _oracles(setup)
    rj = jmala.run(jen, jnp.asarray(pop), steps, 2, 17, oracle=joracle,
                   cfg=jmala.MALAConfig(**kw), key=key, log_every=log_every,
                   quiet=True)
    shape = (n, 16, V)

    def per_step(k, mu):
        k_gs, k_noise = jax.random.split(k)
        return [jax.random.gumbel(k_gs, shape),
                jax.random.normal(k_noise, shape)]

    draws = Replay(run_draws(key, steps, log_every, n, per_step,
                             with_mu=False))
    rt = mala_approx.run(ten, pop, steps, 2, 17, oracle=toracle,
                         cfg=mala_approx.MALAConfig(**kw), draws=draws,
                         log_every=log_every, quiet=True, device="cpu")
    assert not draws.queue
    tol = E_TOL if compute_dtype is None else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(rt.random_traj, rj.random_traj)
    np.testing.assert_array_equal(rt.final_x, np.asarray(rj.final_x))
    np.testing.assert_array_equal(rt.best_x.argmax(-1),
                                  rj.best_x.argmax(-1))
    np.testing.assert_allclose(rt.best_x, rj.best_x, atol=1e-6)
    np.testing.assert_allclose(rt.energy_history, rj.energy_history, **tol)
    np.testing.assert_allclose(rt.best_energy, rj.best_energy, **tol)
    assert (rt.final_x[:, :2] == pop[0][None, :2]).all()
    assert (rt.final_x[:, 18:] == pop[0][None, 18:]).all()
    assert (rt.random_traj.argmax(-1) != pop[0].argmax(-1)).any()


# ---------------------------------------------------------------------------
# CMA-ES
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,diag", [(12, False), (12, True),
                                    (cma_core.AUTO_DIAG_DIM + 1, None)])
def test_cma_core_ask_tell_matches_jax(d, diag):
    """The copy of cma_core gives the JAX package's ask() for the same seed,
    generation after generation (full and sep)."""
    x0 = np.linspace(-1.0, 1.0, d)
    ta = cma_core.CMAES(x0, 0.3, popsize=8, seed=4, diag=diag)
    ja = jcma_core.CMAES(x0, 0.3, popsize=8, seed=4, diag=diag)
    assert ta.diag == ja.diag == (diag is not False)
    for _ in range(5):
        X, Xj = ta.ask(), ja.ask()
        np.testing.assert_array_equal(X, Xj)
        f = (X ** 2).sum(-1)
        ta.tell(X, f)
        ja.tell(Xj, f)
    np.testing.assert_array_equal(ta.mean, ja.mean)
    assert ta.sigma == ja.sigma


def test_cma_core_sphere():
    es = cma_core.CMAES(np.full(8, 3.0), sigma=1.0, popsize=16, seed=1)
    for _ in range(200):
        X, f = es.ask_and_eval(lambda X: (X ** 2).sum(-1))
        es.tell(X, f)
    assert (es.mean ** 2).sum() < 1e-3


@pytest.mark.parametrize("cov", ["full", "sep"])
def test_cmaes_run_matches_jax(setup, cov):
    """Both packages keep the same top-K archive: equal sequences, energies
    within float32."""
    jen, ten, pop, _ = setup
    diag = cov == "sep"
    joracle, toracle = _oracles(setup)
    rj = jcmaes.run(jen, jnp.asarray(pop), 30, 2, 17, oracle=joracle,
                    cfg=jcmaes.CMAESConfig(population_size=8, diag=diag),
                    log_every=15, quiet=True, seed=5)
    rt = cmaes.run(ten, pop, 30, 2, 17, oracle=toracle,
                   cfg=cmaes.CMAESConfig(population_size=8, diag=diag),
                   log_every=15, quiet=True, seed=5, device="cpu")
    np.testing.assert_array_equal(rt.best_x, rj.best_x)
    for a, b in ((rt.best_energy, rj.best_energy),
                 (rt.best_fitness, rj.best_fitness),
                 (rt.energy_history, rj.energy_history),
                 (rt.fitness_history, rj.fitness_history),
                 (rt.oracle_history, rj.oracle_history)):
        np.testing.assert_allclose(a, np.asarray(b), **E_TOL)
    assert np.all(np.diff(rt.best_energy) <= 1e-6)
    assert (rt.best_x.argmax(-1) != pop[0].argmax(-1)).any()
    assert (rt.best_x[:, :2] == pop[0][None, :2]).all()
    assert rt.energy_history.shape == (3, 8)
    assert rt.steps_per_sec > 0
