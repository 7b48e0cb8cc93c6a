"""ppde_tpu_torch.samplers.protein.ppde against ppde_tpu's PPDE sampler.

Randomness cannot match bit for bit (jax.random vs torch.Generator), so the
sampler is held three ways: the factored proposal against the dense
specification; the whole slice (energy, kernels' plain versions, sampler,
segmented driver) with the JAX package's own draws replayed into the port;
and the Boltzmann gold tests on the port's own generator. Tolerances:
float32 on the CPU, energies at rtol 1e-5 / atol 1e-4 (sums in another
order than XLA's); with the tiny transformer expert in the energy, rtol 1e-5
/ atol 5e-4 (its pseudo-log-likelihood is a sum of 20 log-probabilities of
size 3 each)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy, utils as jutils
from ppde_tpu.models import cnn as jcnn, esm2 as jesm2, potts as jpotts
from ppde_tpu.samplers import base as jbase
from ppde_tpu.samplers.protein import ppde as jppde
from ppde_tpu_torch import convert, energy, utils
from ppde_tpu_torch.models import esm2, potts
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.protein import ppde

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRSTVWY"  # 20 residues


def make_setup(lam=1.0, seed=0, n=16):
    tp = potts.synthetic(WT, min_pos=2, max_pos=17, seed=seed,
                         coupling_scale=0.1, field_scale=0.5, device="cpu")
    je = jcnn.init_ensemble(jax.random.PRNGKey(seed), 3, input_size=len(WT))
    te = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, je), "cpu")
    wt_oh = torch.from_numpy(jcodec.seqs_to_onehot([WT]))
    en = energy.protein_poe(tp, te, lam, wt_oh)
    oracle = (tp, lambda p, x: potts.score(p, x, delta=True))
    return en, oracle, wt_oh.repeat(n, 1, 1), tp


def run_short(**kw):
    en, oracle, pop, _ = make_setup()
    res = ppde.run(en, pop, num_steps=60, min_pos=2, max_pos=17,
                   oracle=oracle, cfg=ppde.PPDEConfig(**kw),
                   generator=torch.Generator().manual_seed(7), log_every=30,
                   quiet=True, device="cpu")
    return res, en, pop


# ---------------------------------------------------------------------------
# the factored proposal against the dense specification
# ---------------------------------------------------------------------------

def test_factored_proposals_match_dense_spec():
    """The port's factored (position, value) proposal equals the dense
    masked softmax over [L*V] Taylor logits (the JAX package's
    apply_proposal_masks, reference protein ppde.py:86-111): same logZ and
    same per-index log-probs, normal and over-budget (revert-only)."""
    n, L, V, temp, nmut = 6, 9, 20, 2.0, 3
    rng = np.random.default_rng(0)
    grad = (rng.standard_normal((n, L, V)) * 3.0).astype(np.float32)
    wt_tok = rng.integers(0, V, L)
    tok = np.tile(wt_tok[None], (n, 1))
    muts = [(0, 1), (1, 2), (2, 3), (3, 1), (3, 2), (3, 3),
            (4, 1), (4, 2), (4, 4), (5, 1), (5, 2), (5, 5), (5, 6)]
    for c, p in muts:
        tok[c, p] = (wt_tok[p] + 1 + c) % V
    x = np.eye(V, dtype=np.float32)[tok]
    wt = np.eye(V, dtype=np.float32)[wt_tok]
    window_np = np.asarray(jutils.position_window_mask(L, V, 1, L - 2))

    # dense spec (the JAX package's masks)
    score = grad - (grad * x).sum(-1, keepdims=True)
    dense = jutils.apply_proposal_masks(
        jnp.asarray(score.reshape(n, L * V) / temp), jnp.asarray(x),
        jnp.asarray(wt), jnp.asarray(window_np), nmut)
    dense_logZ = np.asarray(jax.nn.logsumexp(dense, axis=-1))
    dense_lp = np.asarray(jax.nn.log_softmax(dense, axis=-1)).reshape(n, L, V)

    # the port's factored quantities
    gx = torch.from_numpy(grad) / temp
    window_ok = utils.position_window_mask(L, V, 1, L - 2)
    v_logits = torch.where(window_ok[None], gx, utils.NEG_INF)
    lA = torch.logsumexp(v_logits, -1)
    wt_t, tok_t = torch.from_numpy(wt_tok), torch.from_numpy(tok)
    g_wt = gx.gather(2, wt_t.expand(n, L)[..., None])[..., 0]
    g_tok = gx.gather(2, tok_t[..., None])[..., 0]
    wt_in_win = window_ok[torch.arange(L), wt_t]
    over = (tok_t != wt_t[None]).sum(-1) >= nmut
    lw = ppde.position_log_weights(lA, g_wt, g_tok,
                                   (tok_t != wt_t[None]) & wt_in_win[None],
                                   over)
    np.testing.assert_allclose(torch.logsumexp(lw, -1).numpy(), dense_logZ,
                               rtol=1e-5)
    lp_pos = torch.log_softmax(lw, -1).numpy()[:, :, None]
    lp_val = torch.log_softmax(v_logits, -1).numpy()
    fact = np.where(over.numpy()[:, None, None], lp_pos, lp_pos + lp_val)
    allowed = dense_lp > -1e20
    np.testing.assert_allclose(fact[allowed], dense_lp[allowed], atol=1e-4)

    # reverse: the -logZ identity against the dense unmasked reverse logits
    grad_y = (rng.standard_normal((n, L, V)) * 2.0).astype(np.float32)
    rev_dense = (grad_y - (grad_y * x).sum(-1, keepdims=True)).reshape(
        n, L * V) / 2.0
    idx_moved = tok[:, 4] + 4 * V  # position 4 at its CURRENT token
    picked = np.asarray(jutils.categorical_log_prob(jnp.asarray(rev_dense),
                                                    jnp.asarray(idx_moved)))
    gy = torch.from_numpy(grad_y) / 2.0
    gy_tok = gy.gather(2, tok_t[..., None])[..., 0]
    fact_rev = -torch.logsumexp(torch.logsumexp(gy, -1) - gy_tok, -1)
    np.testing.assert_allclose(fact_rev.numpy(), picked, rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole, with the JAX package's draws replayed
# ---------------------------------------------------------------------------

class JaxDraws:
    """The draws the JAX package's run makes from ``key``, in the order the
    port's step asks for them: run_segmented's split(key) -> split(seg_key,
    length) -> the step's split(key, 3) -> randint U, then per inner step
    split(k) -> gumbel for the position and for the value (as
    jax.random.categorical draws them), then the accept uniforms."""

    def __init__(self, key, num_steps, log_every, n, L, V, pas_length):
        max_u = max(2 * pas_length - 1, 1)
        self.queue = []
        for length in jbase.segment_lengths(num_steps, log_every):
            key, seg_key = jax.random.split(key)
            for k in jax.random.split(seg_key, length):
                k_u, k_inner, k_acc = jax.random.split(k, 3)
                self.queue.append(
                    jax.random.randint(k_u, (n,), 1, 2 * pas_length))
                for ki in jax.random.split(k_inner, max_u):
                    k1, k2 = jax.random.split(ki)
                    self.queue.append(jax.random.gumbel(k1, (n, L)))
                    self.queue.append(jax.random.gumbel(k2, (n, V)))
                self.queue.append(jax.random.uniform(k_acc, (n,)))
        self.queue.reverse()

    def _next(self):
        return torch.from_numpy(np.array(self.queue.pop()))

    def path_lengths(self, n, high):
        return self._next().long()

    def gumbel(self, shape):
        g = self._next()
        assert tuple(g.shape) == tuple(shape)
        return g

    def uniform(self, n):
        return self._next()


def _slice_energies(jtr=None, ttr=None, chunk_size=None):
    """The same product-of-experts energy in both packages (Potts + CNN
    ensemble, optionally a transformer expert) and the initial population."""
    jp = jpotts.synthetic(WT, min_pos=2, max_pos=17, seed=0,
                          coupling_scale=0.1, field_scale=0.5)
    je = jcnn.init_ensemble(jax.random.PRNGKey(0), 3, input_size=len(WT))
    wt_oh = jcodec.seqs_to_onehot([WT])
    jen = jenergy.protein_poe(jp, je, 1.0, jnp.asarray(wt_oh),
                              transformer=jtr, chunk_size=chunk_size)
    ten = energy.protein_poe(
        convert.potts_from_numpy(
            *jax.tree.map(np.asarray, (jp.W, jp.h, jp.wt_H)), jp.seq_len,
            jp.min_pos, jp.max_pos, device="cpu"),
        convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, je), "cpu"),
        1.0, torch.from_numpy(wt_oh), transformer=ttr,
        chunk_size=chunk_size)
    return jen, ten, wt_oh


def _check_slice(jen, ten, wt_oh, cfg_kw, n, steps, log_every, e_tol):
    """Run both packages' samplers on the JAX package's draws: the same
    tokens, accepts and best states; energy histories within e_tol."""
    pop = np.repeat(wt_oh, n, 0)
    key = jax.random.PRNGKey(7)
    cfg_j, cfg_t = jppde.PPDEConfig(**cfg_kw), ppde.PPDEConfig(**cfg_kw)
    rj = jppde.run(jen, jnp.asarray(pop), steps, 2, 17, cfg=cfg_j, key=key,
                   log_every=log_every, quiet=True)
    draws = JaxDraws(key, steps, log_every, n, len(WT), 20,
                     cfg_kw["pas_length"])
    rt = ppde.run(ten, pop, steps, 2, 17, cfg=cfg_t, draws=draws,
                  log_every=log_every, quiet=True, device="cpu")
    assert not draws.queue  # every JAX draw was consumed
    np.testing.assert_array_equal(rt.n_accepted, rj.n_accepted)
    assert 0 < rt.n_accepted.sum() < steps * n
    np.testing.assert_array_equal(rt.random_traj, rj.random_traj)
    np.testing.assert_array_equal(rt.final_x, rj.final_x)
    np.testing.assert_array_equal(rt.best_x, rj.best_x)
    for a, b in ((rt.energy_history, rj.energy_history),
                 (rt.fitness_history, rj.fitness_history),
                 (rt.best_energy, rj.best_energy)):
        np.testing.assert_allclose(a, np.asarray(b), **e_tol)


@pytest.mark.parametrize("cfg_kw", [
    dict(pas_length=2, nmut_threshold=4),
    dict(pas_length=3, paper_results=True),
])
def test_slice_matches_jax_with_injected_draws(cfg_kw):
    """~20 steps of 8 chains: the same draws give the same tokens, accepts
    and best states; the energy histories agree within float32 tolerance."""
    jen, ten, wt_oh = _slice_energies()
    _check_slice(jen, ten, wt_oh, cfg_kw, n=8, steps=20, log_every=10,
                 e_tol=dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("chunk_size", [None, 3])
def test_slice_matches_jax_with_transformer_expert(chunk_size, tmp_path):
    """The transformer path as a whole (ESM2 with its attention through the
    wrapper's plain version, the chunked gradient, energy, sampler, segments):
    a tiny float32 expert, 8 steps of 6 chains, JAX's draws replayed."""
    tiny = dict(layers=2, dim=32, heads=4, ffn=64)
    jesm2.CONFIGS["tiny"] = tiny
    esm2.CONFIGS["tiny"] = tiny
    path = str(tmp_path / "tiny.npz")
    # weights of scale 0.1: large enough to move the energy, small enough
    # that the sampler accepts some proposals and rejects others
    jesm2.save_npz_checkpoint(path, jesm2.init(
        jax.random.PRNGKey(1), "tiny", dtype=jnp.float32, scale=0.1))
    jtr = jesm2.load_expert("tiny", WT, weights_path=path, dtype=jnp.float32)
    ttr = esm2.load_expert("tiny", WT, weights_path=path,
                           dtype=torch.float32, device="cpu")
    jen, ten, wt_oh = _slice_energies(jtr, ttr, chunk_size)
    _check_slice(jen, ten, wt_oh, dict(pas_length=2, nmut_threshold=4), n=6,
                 steps=8, log_every=4, e_tol=dict(rtol=1e-5, atol=5e-4))


# ---------------------------------------------------------------------------
# Boltzmann gold tests on the port's own generator
# ---------------------------------------------------------------------------

def _boltzmann_gap(pas_length, reference_reverse, seed=11):
    """|empirical mean energy - exact Boltzmann mean| / exact std on a tiny
    quadratic categorical energy with an enumerable (V^L = 256) state space
    (the JAX package's test_ppde_protein.py:156-204)."""
    L, V = 4, 4
    rng = np.random.default_rng(3)
    D = L * V
    J = rng.normal(0, 0.6, (D, D))
    J = (J + J.T) / 2
    for i in range(L):  # no self-interactions within a position
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
    n_chains, n_steps, burn = 64, 2500, 500
    x0 = np.eye(V, dtype=np.float32)[rng.integers(0, V, (n_chains, L))]
    res = ppde.run(en, x0, n_steps, min_pos=0, max_pos=L - 1,
                   cfg=ppde.PPDEConfig(pas_length=pas_length,
                                       reference_reverse=reference_reverse),
                   generator=torch.Generator().manual_seed(seed),
                   log_every=n_steps, quiet=True, device="cpu")

    toks = np.array(np.meshgrid(*([range(V)] * L),
                                indexing="ij")).reshape(L, -1).T
    states = np.eye(V, dtype=np.float32)[toks].reshape(-1, D)
    es = 0.5 * np.einsum("nd,de,ne->n", states, J, states) + states @ h
    p = np.exp(es - es.max())
    p /= p.sum()
    exact_mean = (p * es).sum()
    exact_std = np.sqrt((p * (es - exact_mean) ** 2).sum())
    return (res.energy_history[burn:].mean() - exact_mean) / exact_std


@pytest.mark.parametrize("pas_length", [1, 2])
def test_pas_boltzmann_stationarity(pas_length):
    """The full factored PAS machinery samples pi(x) ~ exp(E(x))."""
    gap = _boltzmann_gap(pas_length, reference_reverse=False)
    assert abs(gap) < 0.12, gap


def test_reference_reverse_mode_is_biased():
    """The reference's reverse estimator biases the chain hot (> 0.3
    exact-std), as in the JAX package."""
    gap = _boltzmann_gap(2, reference_reverse=True)
    assert gap > 0.3, gap


# ---------------------------------------------------------------------------
# window, nmut, paper mode, records
# ---------------------------------------------------------------------------

def test_shapes_and_structure():
    res, en, pop = run_short(pas_length=2, nmut_threshold=4)
    n, L, V = pop.shape
    assert res.best_x.shape == (n, L, V)
    assert res.energy_history.shape == (61, n)
    assert res.fitness_history.shape == (61, n)
    assert res.final_x.shape == (n, L, V)
    assert res.oracle_history.shape == (3, n)
    assert res.random_traj.shape == (61, L, V)
    np.testing.assert_array_equal(res.final_x.sum(-1), np.ones((n, L)))
    np.testing.assert_array_equal(res.best_x.sum(-1), np.ones((n, L)))
    assert res.steps_per_sec > 0 and res.wall_steps_per_sec > 0


def test_best_tracking_consistency():
    res, _, _ = run_short(pas_length=2)
    np.testing.assert_allclose(res.best_energy, res.energy_history.max(0),
                               rtol=1e-6)
    assert np.all(res.best_energy >= res.energy_history[0])


def test_window_respected():
    res, _, pop = run_short(pas_length=3)
    wt = pop[0].numpy()
    for x in (res.final_x, res.best_x):
        assert (x[:, :2] == wt[None, :2]).all()
        assert (x[:, 18:] == wt[None, 18:]).all()


def test_nmut_hard_constraint():
    res, _, pop = run_short(pas_length=3, nmut_threshold=3)
    wt = pop[0]
    d_best = utils.mut_distance(torch.from_numpy(res.best_x), wt)
    assert d_best.max() <= 3  # recorded (pre-reset) states
    d_final = utils.mut_distance(torch.from_numpy(res.final_x), wt)
    assert d_final.max() < 3  # post-reset states


def test_acceptance_not_degenerate():
    res, _, _ = run_short(pas_length=2)
    assert 0 < res.n_accepted.sum() < 60 * 16


def test_paper_mode_resets_to_init():
    res, _, pop = run_short(pas_length=2, paper_results=True)
    assert res.final_x.shape == tuple(pop.shape)
    np.testing.assert_array_equal(res.final_x.sum(-1), 1.0)


def test_paper_mode_carried_state_consistent_with_heterogeneous_init():
    """A rejected chain resets to its PER-CHAIN initial state; the carried
    (e, fit, grad) must match a fresh evaluation of the actual state."""
    en, _, pop, _ = make_setup()
    n, L, V = pop.shape
    x0 = pop.clone()
    rng = np.random.default_rng(0)
    for i in range(1, n):
        p = rng.integers(2, 18)
        x0[i, p] = 0.0
        x0[i, p, rng.integers(0, V)] = 1.0
    cfg = ppde.PPDEConfig(pas_length=2, paper_results=True)
    window_ok = utils.position_window_mask(L, V, 2, 17)
    e0, fit0, grad0 = en.energy_and_grad(en.params, x0)
    ctx = {"energy": en.params, "wt": x0[0], "init_x": x0,
           "wt_e": e0[0], "wt_fit": fit0[0], "wt_grad": grad0[0],
           "init_e": e0, "init_fit": fit0, "init_grad": grad0}
    step = ppde.make_step(en, cfg, window_ok, n, L, V)
    draws = ppde.Draws(torch.Generator().manual_seed(100))
    state = (x0, (e0, fit0, grad0), (e0, fit0, x0))
    saw_reject = False
    for _ in range(12):
        state, ys = step(ctx, state, draws)
        x, (e, fit, g), _ = state
        saw_reject |= not bool(ys["accepted"].all())
        e_chk, fit_chk, g_chk = en.energy_and_grad(en.params, x)
        torch.testing.assert_close(e, e_chk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fit, fit_chk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(g, g_chk, rtol=1e-5, atol=1e-5)
    assert saw_reject


def test_deterministic_given_generator():
    res1, _, _ = run_short(pas_length=2)
    res2, _, _ = run_short(pas_length=2)
    np.testing.assert_array_equal(res1.energy_history, res2.energy_history)
    np.testing.assert_array_equal(res1.best_x, res2.best_x)


def test_segment_lengths_and_update_best():
    assert base.segment_lengths(100, 30) == [30, 30, 30, 10]
    assert base.segment_lengths(60, 30) == [30, 30]
    assert base.segment_lengths(5, 50) == [5]
    # the first max wins: an equal later energy does not replace the best
    x_old, x_new = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    best = (torch.tensor([1.0, 1.0]), torch.tensor([0.1, 0.1]), x_old)
    e, f, bx = base.update_best(best, torch.tensor([1.0, 2.0]),
                                torch.tensor([0.5, 0.6]), x_new)
    torch.testing.assert_close(e, torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(f, torch.tensor([0.1, 0.6]))
    assert (bx[0] == 0).all() and (bx[1] == 1).all()
