"""The port's trainers (ppde_tpu_torch/training.py, esm2.lora_init,
mnist_nets.dae_corrupt, data/mnist.py, extras/lown.py) against the JAX
package's on the CPU, on the same numpy inputs, with the JAX package's
random draws replayed through the port's ``TrainDraws`` methods.

Tolerances (float32 throughout):
  * optimizer chain: rtol 1e-5 / atol 2e-6 of the weights (magnitude
    about 1) after each of 20 updates (a few float32 ulps: products and
    sums in another order); schedules: rtol 1e-6;
  * losses and gradients of one batch: 1e-5 of each leaf's largest
    magnitude; held-out cross-entropies: rtol 1e-5;
  * weights after a few trained steps: atol 2e-5 (1e-4 for the conv
    nets), except the attention key biases. Softmax is invariant to them,
    so their gradient is rounding noise in both packages, and Adam scales
    noise to a step of about lr: they are held to 2 lr a step (tested to
    stay equal to each other in value across q/k/v otherwise);
  * sampled states (dae_corrupt, gwg_flip_step): equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppde_tpu import training as jt
from ppde_tpu.data import mnist as jdm
from ppde_tpu.extras import lown as jlown
from ppde_tpu.models import esm2 as jesm, mnist_nets as jmn
from ppde_tpu.models import msa_transformer as jmsat
from ppde_tpu_torch import convert, io as pio, training
from ppde_tpu_torch.data import mnist as pdm
from ppde_tpu_torch.extras import lown as plown
from ppde_tpu_torch.models import esm2 as pesm, mnist_nets as pmn
from ppde_tpu_torch.models import msa_transformer as pmsat

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GFP_A2M = os.path.join(REPO, "data", "proteins", "synthetic",
                       "GFP_AEQVI_Sarkisyan2016_synth.a2m")
GFP_MSAT = os.path.join(REPO, "results", "esm_family",
                        "GFP_msat_S_ckpt_2000.npz")
TINY = dict(layers=2, dim=32, heads=4, ffn=64)
jesm.CONFIGS["mlm-tiny"] = TINY
pesm.CONFIGS["mlm-tiny"] = dict(TINY)
WT = "ACDEFGHIKLMNPQRS"
AA_LO, AA_HI = jesm.ESM_TOK_TO_IDX["L"], jesm.ESM_TOK_TO_IDX["C"]


def family(n, seed=0):
    """WT plus 1-2 point mutations, fixed length."""
    rng = np.random.default_rng(seed)
    seqs = [WT]
    for _ in range(n - 1):
        s = list(WT)
        for _ in range(rng.integers(1, 3)):
            s[rng.integers(len(WT))] = "ACDEFGHIKLMNPQRSTVWY"[
                rng.integers(20)]
        seqs.append("".join(s))
    return seqs


def _shape(shape):
    return tuple(shape) if isinstance(shape, (tuple, list, torch.Size)) \
        else (shape,)


class Replay:
    """Hands out the JAX package's draws through the port's ``TrainDraws``
    methods, checking each kind and shape."""

    def __init__(self, queue):
        self.queue = [(k, np.array(a)) for k, a in queue]

    def _pop(self, kind, shape):
        k, a = self.queue.pop(0)
        assert k == kind and a.shape == _shape(shape), (k, kind, a.shape,
                                                        shape)
        return torch.from_numpy(a)

    def rows(self, weights, n):
        return self._pop("rows", (n,)).long()

    def uniform(self, shape):
        return self._pop("uniform", shape).float()

    def randint(self, high, shape):
        return self._pop("randint", shape).long()

    def normal(self, shape):
        return self._pop("normal", shape).float()

    def gumbel(self, shape):
        return self._pop("gumbel", shape).float()


def corrupt_draws(key, shape):
    """jt._esm_corrupt's draws from its key."""
    k_mask, k_r, k_rnd = jax.random.split(key, 3)
    return [("uniform", jax.random.uniform(k_mask, shape)),
            ("uniform", jax.random.uniform(k_r, shape)),
            ("randint", jax.random.randint(k_rnd, shape, AA_LO, AA_HI + 1)
             - AA_LO)]


def step_keys(seed, n_iters, chunk, *cadences, start=0):
    """The per-step keys of a JAX trainer: one split a chunk."""
    key = jax.random.PRNGKey(seed)
    for _, size in jt._chunked(n_iters - start, chunk, *cadences,
                               start=start):
        key, k = jax.random.split(key)
        yield from jax.random.split(k, size)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def assert_trees_close(ours, theirs, atol, noise=(), noise_atol=None):
    """Leaves in the JAX flatten order; leaves whose path holds a key of
    ``noise`` are held to ``noise_atol``."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(theirs)[0]]
    for path, a, b in zip(paths, pesm._flatten(ours),
                          jax.tree.leaves(theirs)):
        tol = noise_atol if any(f"'{n}'" in path for n in noise) else atol
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol, err_msg=path)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_schedules_match_optax():
    ours = training.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 20, 1e-3)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 20,
                                                end_value=1e-3)
    cos_o = training.cosine_decay_schedule(0.05, 30, alpha=0.02)
    cos_t = optax.cosine_decay_schedule(0.05, decay_steps=30, alpha=0.02)
    for c in range(40):
        assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-6, abs=1e-12)
        assert cos_o(c) == pytest.approx(float(cos_t(c)), rel=1e-6)
    assert ours(0) == 0.0  # the first update moves no weight


@pytest.mark.parametrize("kind", ["adamw_clip_warmup", "adam_cosine"])
def test_optimizer_chain_matches_optax(kind):
    """20 updates of a small tree from one gradient sequence: the clip
    triggers on the large ones (and not on the small), the warmup's count
    0 moves nothing but fills the moments, weight decay on the 2-D leaf
    only."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    scales = [3.0 if s % 3 == 0 else 0.05 for s in range(20)]
    grads = [{k: (rng.normal(size=v.shape) * sc).astype(np.float32)
              for k, v in tree.items()} for sc in scales]
    if kind == "adamw_clip_warmup":
        sched = (0.0, 1e-2, 5, 20, 1e-3)
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(*sched[:4],
                                               end_value=sched[4]),
            weight_decay=0.01, mask={"a": True, "b": False}))
        leaves = [torch.tensor(tree[k]) for k in ("a", "b")]
        ours = training.Adam(
            leaves, training.warmup_cosine_decay_schedule(*sched),
            weight_decay=0.01, decay_mask=[True, False], clip_norm=1.0)
    else:
        opt = optax.adam(optax.cosine_decay_schedule(0.05, 20, alpha=0.02))
        leaves = [torch.tensor(tree[k]) for k in ("a", "b")]
        ours = training.Adam(leaves,
                             training.cosine_decay_schedule(0.05, 20, 0.02))
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    for step, g in enumerate(grads):
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        ours.step([torch.tensor(g[k]) for k in ("a", "b")])
        for t, k in zip(leaves, ("a", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=2e-6,
                                       err_msg=f"{kind} step {step} {k}")
        if step == 0 and kind == "adamw_clip_warmup":
            assert all(np.array_equal(t.numpy(), tree[k])
                       for t, k in zip(leaves, ("a", "b")))


# ---------------------------------------------------------------------------
# ESM2 masked LM
# ---------------------------------------------------------------------------

def _jax_esm_loss(p_, x, tgt, w):
    logits = jesm.forward_logits(jesm.cast_params(p_, jnp.float32), x, 4,
                                 False)
    ce = -jnp.sum(tgt * jax.nn.log_softmax(logits, -1), -1)
    return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)


def test_esm_mlm_loss_and_grads_match_jax():
    p0 = jesm.init(jax.random.PRNGKey(1), "mlm-tiny", jnp.float32)
    tok = jnp.asarray(jt._esm_tokens(family(6)))
    corrupt, is_sel = jt._esm_corrupt(jax.random.PRNGKey(2), tok, 0.15,
                                      AA_LO, AA_HI)
    loss, g = jax.jit(jax.value_and_grad(_jax_esm_loss))(
        p0, jax.nn.one_hot(corrupt, 33), jax.nn.one_hot(tok, 33),
        is_sel.astype(jnp.float32))

    ours = convert.esm2_from_numpy(np_tree(p0), "cpu")
    leaves = training._trainable(ours)
    logits = pesm.forward_logits(pesm.cast_params(ours, torch.float32),
                                 torch.nn.functional.one_hot(
                                     torch.from_numpy(np.array(corrupt))
                                     .long(), 33).float(), 4)
    num, den = training._masked_ce_sums(
        logits, torch.from_numpy(np.array(tok)),
        torch.from_numpy(np.array(is_sel)))
    our_loss = num / den.clamp_min(1.0)
    assert float(our_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    for a, b in zip(torch.autograd.grad(our_loss, leaves),
                    jax.tree.leaves(g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-3))


def esm_train_draws(seed, n_iters, chunk, B, T, logw, start=0):
    out = []
    for key in step_keys(seed + 3, n_iters, chunk, 100, 1000, start=start):
        k_sel, k_corrupt = jax.random.split(key)
        out.append(("rows", jax.random.categorical(k_sel, logw,
                                                   shape=(B,))))
        out += corrupt_draws(k_corrupt, (B, T))
    return Replay(out)


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_train_esm_mlm_matches_jax_with_replayed_draws(lora_rank,
                                                       monkeypatch):
    """Three steps (one chunk): the full fine-tune, and LoRA at rank 2 with
    sequence weights (adapters from the JAX package's lora_init)."""
    seqs = family(12)
    p0 = jesm.init(jax.random.PRNGKey(1), "mlm-tiny", jnp.float32)
    w = np.linspace(0.2, 1.0, len(seqs)).astype(np.float32) \
        if lora_rank else None
    kw = dict(name="mlm-tiny", n_iters=3, batch_size=4, lr=1e-3, warmup=1,
              seed=0, chunk=3, quiet=True, lora_rank=lora_rank,
              seq_weights=w)
    theirs = jt.train_esm_mlm(seqs, params=p0, compute_dtype=jnp.float32,
                              **kw)
    if lora_rank:
        lora = convert.esm2_from_numpy(np_tree(jesm.lora_init(
            jax.random.PRNGKey(7), "mlm-tiny", lora_rank)), "cpu")
        monkeypatch.setattr(pesm, "lora_init", lambda *a, **k: lora)
    logw = jnp.log(jnp.maximum(jnp.asarray(w), 1e-30)) if w is not None \
        else jnp.zeros(len(seqs))
    draws = esm_train_draws(0, 3, 3, 4, len(WT), logw)
    ours = training.train_esm_mlm(
        seqs, params=convert.esm2_from_numpy(np_tree(p0), "cpu"),
        compute_dtype=torch.float32, device="cpu", draws=draws, **kw)
    assert not draws.queue
    # two steps move weights (the first is at the warmup's count 0)
    assert_trees_close(ours, theirs, 2e-5, noise=("k",),
                       noise_atol=2 * 2 * 1e-3)


def test_first_warmup_step_moves_no_weight():
    p0 = jesm.init(jax.random.PRNGKey(1), "mlm-tiny", jnp.float32)
    draws = esm_train_draws(0, 1, 25, 4, len(WT), jnp.zeros(8))
    ours = training.train_esm_mlm(
        family(8), name="mlm-tiny", params=convert.esm2_from_numpy(
            np_tree(p0), "cpu"), n_iters=1, batch_size=4, warmup=10,
        quiet=True, compute_dtype=torch.float32, device="cpu", draws=draws)
    assert_trees_close(ours, p0, 0.0)


def test_esm_mlm_heldout_ce_matches_jax():
    p0 = jesm.init(jax.random.PRNGKey(4), "mlm-tiny", jnp.float32)
    seqs = family(10, seed=3)
    theirs = jt.esm_mlm_heldout_ce(p0, seqs, name="mlm-tiny", seed=5,
                                   n_repeats=2, compute_dtype=jnp.float32)
    q = []
    for k in jax.random.split(jax.random.PRNGKey(5), 2):
        q += corrupt_draws(k, (len(seqs), len(WT)))
    ours = training.esm_mlm_heldout_ce(
        convert.esm2_from_numpy(np_tree(p0), "cpu"), seqs, name="mlm-tiny",
        seed=5, n_repeats=2, compute_dtype=torch.float32, draws=Replay(q))
    assert ours == pytest.approx(theirs, rel=1e-5)


def test_resume_restarts_the_optimizer_as_jax_does(tmp_path):
    """The port trains 4 steps with a checkpoint at 2; the JAX package
    resumes from the port's step-2 file, the port too; both resumed runs
    (fresh optimizer, schedule at count 0, keys from the resumed offset)
    end at the same weights."""
    seqs = family(8)
    pre = str(tmp_path / "esm")
    kw = dict(name="mlm-tiny", n_iters=4, batch_size=4, lr=1e-3, warmup=1,
              seed=0, quiet=True, chunk=2, ckpt_every=2)
    training.train_esm_mlm(seqs, ckpt_path=pre, compute_dtype=torch.float32,
                           device="cpu", **kw)
    ck = f"{pre}_ckpt_2.npz"
    assert sorted(os.listdir(tmp_path)) == ["esm_ckpt_2.npz",
                                            "esm_ckpt_4.npz"]
    theirs = jt.train_esm_mlm(seqs, resume=ck, compute_dtype=jnp.float32,
                              **kw)
    draws = esm_train_draws(0, 4, 2, 4, len(WT), jnp.zeros(8), start=2)
    ours = training.train_esm_mlm(seqs, resume=ck,
                                  compute_dtype=torch.float32, device="cpu",
                                  draws=draws, **kw)
    assert not draws.queue
    assert_trees_close(ours, theirs, 2e-5, noise=("k",),
                       noise_atol=2 * 1e-3)


def test_lora_init_layout_and_zero_delta():
    ours = pesm.lora_init(torch.Generator().manual_seed(0), "mlm-tiny", 3)
    theirs = jesm.lora_init(jax.random.PRNGKey(0), "mlm-tiny", 3)
    assert [tuple(a.shape) for a in pesm._flatten(ours)] == \
        [a.shape for a in jax.tree.leaves(theirs)]
    assert all(not layer[t]["b"].any() for layer in ours["layers"]
               for t in pesm.LORA_TARGETS)
    a = ours["layers"][0]["fc2"]["a"]
    assert abs(float(a.std()) * np.sqrt(a.shape[0]) - 1.0) < 0.1
    base = pesm.init(torch.Generator().manual_seed(1), "mlm-tiny",
                     torch.float32)
    merged = pesm.lora_merge(base, ours)
    assert all(torch.equal(x, y) for x, y in zip(pesm._flatten(merged),
                                                 pesm._flatten(base)))


# ---------------------------------------------------------------------------
# MSA Transformer masked LM
# ---------------------------------------------------------------------------

def test_msa_mlm_loss_and_grads_match_jax():
    p0 = jmsat.init(jax.random.PRNGKey(0), jnp.float32, name="msa-tiny")
    rows = ["ACDE-FGHIK", "ACDEKFGHIR", "-CDELFGHIK", "ACQE-FGHWK"]
    block = jnp.asarray(jmsat.tokenize_msa(rows))
    corrupt, is_sel = jt._msa_corrupt(jax.random.PRNGKey(3), block, 0.3)
    w = is_sel.astype(jnp.float32)

    def loss_fn(p_):
        lp = jax.nn.log_softmax(jmsat.forward_logits(
            jmsat.cast_params(p_, jnp.float32), corrupt[None], 2)[0], -1)
        ce = -jnp.sum(jax.nn.one_hot(block, 33) * lp, -1)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(p0)
    ours = convert.msa_transformer_from_numpy(np_tree(p0), "cpu")
    leaves = training._trainable(ours)
    num, den = training._masked_ce_sums(
        pmsat.forward_logits(ours, torch.from_numpy(
            np.array(corrupt))[None].long(), 2)[0],
        torch.from_numpy(np.array(block)),
        torch.from_numpy(np.array(is_sel)))
    our_loss = num / den.clamp_min(1.0)
    assert float(our_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    for a, b in zip(torch.autograd.grad(our_loss, leaves),
                    jax.tree.leaves(g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-3))


def test_msa_heldout_ce_of_the_tracked_scorer_matches_jax():
    """The tracked family-trained msa-S scorer on 48 rows of the tracked
    GFP alignment (C + 1 = 238), two blocks of 8 rows, float32."""
    rows = [s for _, s in pio.load_msa(GFP_A2M)[:48]]
    theirs = jt.msa_mlm_heldout_ce(
        jmsat.load(GFP_MSAT, dtype=jnp.float32, name="msa-S"), rows,
        block_rows=8, seed=1, n_repeats=2, compute_dtype=jnp.float32)
    q = []
    for k in jax.random.split(jax.random.PRNGKey(1), 2):
        k_sel, k_corrupt = jax.random.split(k)
        q.append(("randint", jax.random.randint(k_sel, (8,), 0, len(rows))))
        q += corrupt_draws(k_corrupt, (8, len(rows[0]) + 1))
    ours = training.msa_mlm_heldout_ce(
        pmsat.load(GFP_MSAT, dtype=torch.float32, name="msa-S",
                   device="cpu"), rows, block_rows=8, seed=1, n_repeats=2,
        compute_dtype=torch.float32, draws=Replay(q))
    assert ours == pytest.approx(theirs, rel=1e-5)


def test_train_msa_mlm_matches_jax_with_replayed_draws():
    rows = ["ACDE-FGHIK", "ACDEKFGHIR", "-CDELFGHIK", "ACQE-FGHWK",
            "ACDEMFGHIK"]
    p0 = jmsat.init(jax.random.PRNGKey(0), jnp.float32, name="msa-tiny")
    kw = dict(name="msa-tiny", n_iters=3, block_rows=4, lr=1e-3, warmup=1,
              seed=2, chunk=3, quiet=True)
    theirs = jt.train_msa_mlm(rows, params=p0, compute_dtype=jnp.float32,
                              **kw)
    q = []
    for key in step_keys(2 + 3, 3, 3, 100, 1000):
        k_sel, k_corrupt = jax.random.split(key)
        q.append(("rows", jax.random.categorical(k_sel, jnp.zeros(5),
                                                 shape=(4,))))
        q += corrupt_draws(k_corrupt, (4, 11))
    draws = Replay(q)
    ours = training.train_msa_mlm(
        rows, params=convert.msa_transformer_from_numpy(np_tree(p0), "cpu"),
        compute_dtype=torch.float32, device="cpu", draws=draws, **kw)
    assert not draws.queue
    assert_trees_close(ours, theirs, 2e-5, noise=("k",),
                       noise_atol=2 * 2 * 1e-3)


# ---------------------------------------------------------------------------
# MNIST
# ---------------------------------------------------------------------------

def test_dae_corrupt_matches_jax():
    x = (np.random.default_rng(0).random((6, 784)) < 0.2).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    theirs = jmn.dae_corrupt(key, jnp.asarray(x), 40)
    k1, k2 = jax.random.split(key)
    ours = pmn.dae_corrupt(Replay([
        ("randint", jax.random.randint(k1, (), 0, 41)),
        ("uniform", jax.random.uniform(k2, x.shape))]),
        torch.from_numpy(x), 40)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # one flip rate for the whole batch
    assert np.asarray(theirs != x).mean() > 0


def _ebm(nc=4):
    imgs = jdm.load_static_binary_mnist("synthetic")[:64]
    mean = imgs.mean(0).clip(1e-2, 1 - 1e-2)
    return imgs, mean, jmn.ebm_init(jax.random.PRNGKey(0), nc, mean=mean)


def gwg_draws(key, B, D):
    k1, k2 = jax.random.split(key)
    return [("gumbel", jax.random.gumbel(k1, (B, D))),
            ("uniform", jax.random.uniform(k2, (B,)))]


def test_gwg_flip_step_matches_jax():
    imgs, _, p = _ebm()
    x = jnp.asarray(imgs[:8])
    ours_p = convert.ebm_from_numpy(np_tree(p), "cpu")
    ours_x = torch.from_numpy(imgs[:8])
    step = jax.jit(jt.gwg_flip_step)
    for key in jax.random.split(jax.random.PRNGKey(1), 3):
        x = step(p, x, key)
        ours_x = training.gwg_flip_step(ours_p, ours_x,
                                        Replay(gwg_draws(key, 8, 784)))
        np.testing.assert_array_equal(ours_x.numpy(), np.asarray(x))


def test_train_regression_matches_jax(monkeypatch):
    ds_j = jdm.MNISTSumPairs("synthetic", None, "train")
    ds_p = pdm.MNISTSumPairs("synthetic", None, "train")
    kw = dict(nc=4, n_iters=3, batch_size=8, seed=0, chunk=3, quiet=True)
    theirs = jt.train_regression(ds_j, **kw)
    init = convert.mnist_from_numpy(np_tree(jmn.regression_init(
        jax.random.PRNGKey(0), nc=4)), "cpu")
    monkeypatch.setattr(pmn, "regression_init", lambda *a, **k: init)
    q = []
    for key in step_keys(1, 3, 3, 1000, 5000):
        ks = jax.random.split(key, 8)
        q += [("randint", jax.random.randint(ks[0], (8,), 0,
                                             len(ds_j.pairs))),
              ("uniform", jax.random.uniform(ks[1], (8, 784))),
              ("uniform", jax.random.uniform(ks[2], (8, 784))),
              ("normal", jax.random.normal(ks[7], (8,)))]
    draws = Replay(q)
    ours = training.train_regression(ds_p, device="cpu", draws=draws, **kw)
    assert not draws.queue
    for a, b in zip(pesm._flatten(convert.mnist_to_numpy(ours)),
                    jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    acc_j = jt.eval_regression_accuracy(
        theirs, jdm.MNISTSumPairs("synthetic", None, "val", seed=1,
                                  train_noise=False), n_batches=2)
    acc_p = training.eval_regression_accuracy(
        ours, pdm.MNISTSumPairs("synthetic", None, "val", seed=1,
                                train_noise=False), n_batches=2)
    assert acc_p == pytest.approx(acc_j, abs=1 / 512 + 1e-9)


def test_train_dae_matches_jax(monkeypatch):
    imgs = jdm.load_static_binary_mnist("synthetic")[:64]
    kw = dict(latent_dim=4, n_channels=4, max_p=15, n_iters=3, batch_size=8,
              seed=0, chunk=3, quiet=True)
    theirs = jt.train_dae(imgs, **kw)
    init = convert.dae_from_numpy(np_tree(jmn.dae_init(
        jax.random.PRNGKey(0), 4, 4)), "cpu")
    monkeypatch.setattr(pmn, "dae_init", lambda *a, **k: init)
    q = []
    for key in step_keys(1, 3, 3, 1000, 10000):
        k_sel, k_corrupt = jax.random.split(key)
        k1, k2 = jax.random.split(k_corrupt)
        q += [("randint", jax.random.randint(k_sel, (8,), 0, 64)),
              ("randint", jax.random.randint(k1, (), 0, 16)),
              ("uniform", jax.random.uniform(k2, (8, 784)))]
    draws = Replay(q)
    ours = training.train_dae(imgs, device="cpu", draws=draws, **kw)
    assert not draws.queue
    for a, b in zip(pesm._flatten(convert.mnist_to_numpy(ours)),
                    jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_train_ebm_matches_jax(monkeypatch):
    imgs, mean, p0 = _ebm()
    kw = dict(n_channels=4, n_iters=2, batch_size=8, buffer_size=32,
              sampling_steps=2, seed=0, chunk=2, quiet=True,
              p_control=0.05, data_noise_p=0.03)
    theirs = jt.train_ebm(imgs, **kw)
    init = convert.ebm_from_numpy(np_tree(p0), "cpu")
    monkeypatch.setattr(pmn, "ebm_init", lambda *a, **k: init)
    q = []
    for key in step_keys(7, 2, 2, 200, 2000):
        ks = jax.random.split(key, 7)  # data, bin, buf, chain, re, bin, noise
        q += [("randint", jax.random.randint(ks[0], (8,), 0, 64)),
              ("uniform", jax.random.uniform(ks[1], (8, 784))),
              ("uniform", jax.random.uniform(ks[6], (8, 784))),
              ("randint", jax.random.randint(ks[2], (8,), 0, 32)),
              ("uniform", jax.random.uniform(ks[4], (8, 1))),
              ("uniform", jax.random.uniform(ks[5], (8, 784)))]
        for kc in jax.random.split(ks[3], 2):
            q += gwg_draws(kc, 8, 784)
    draws = Replay(q)
    ours = training.train_ebm(imgs, device="cpu", draws=draws, **kw)
    assert not draws.queue
    for a, b in zip(pesm._flatten(convert.mnist_to_numpy(ours)),
                    jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_mnist_data_copy_gives_the_jax_arrays(tmp_path):
    for split in ("train", "val"):
        a, la = jdm.load_raw_mnist("synthetic", split)
        b, lb = pdm.load_raw_mnist("synthetic", split)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(jdm.load_static_binary_mnist("synthetic"),
                                  pdm.load_static_binary_mnist("synthetic"))
    bj = jdm.MNISTSumPairs("synthetic", None, "train", seed=3,
                           flip_maxp=20)
    bp = pdm.MNISTSumPairs("synthetic", None, "train", seed=3,
                           flip_maxp=20)
    np.testing.assert_array_equal(bj.pairs, bp.pairs)
    for u, v in zip(bj.batches(4, steps=2), bp.batches(4, steps=2)):
        for x, y in zip(u, v):
            np.testing.assert_array_equal(x, y)
    # the augmented source on seeded stand-in digits
    from ppde_tpu_torch.scripts import seeded_mnist

    d = seeded_mnist.write_data_dir(str(tmp_path))
    np.testing.assert_array_equal(
        jdm.augmented_real_mnist(d, 5, seed=2, heldout=True),
        pdm.augmented_real_mnist(d, 5, seed=2, heldout=True))
    assert pdm.load_real_seed_images(d).shape == (10, 28, 28)


def test_lown_copy_gives_equal_outputs():
    seqs = ["ACDEFG", "ACDQFG", "WCDEF", "ACDEFGH"]
    np.testing.assert_array_equal(jlown.levenshtein_matrix(seqs),
                                  plown.levenshtein_matrix(seqs))
    np.testing.assert_array_equal(jlown.onehot_alt(seqs, "ACDEFGHQW"),
                                  plown.onehot_alt(seqs, "ACDEFGHQW"))
    assert jlown.aa_to_dna("ACDW") == plown.aa_to_dna("ACDW")
    e = plown.edit_string("ACDQFG", "ACDEFG")
    assert e == jlown.edit_string("ACDQFG", "ACDEFG") == "E4Q"
    assert plown.apply_edit_string(e, "ACDEFG") == "ACDQFG"
    assert plown.hamming("ACD", "ACE") == jlown.hamming("ACD", "ACE")
    assert plown.AVGFP_WT == jlown.AVGFP_WT


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_esm_and_msa_checkpoints_cross_both_ways(tmp_path):
    p_j = jesm.init(jax.random.PRNGKey(2), "mlm-tiny", jnp.float32)
    p_p = convert.esm2_from_numpy(np_tree(p_j), "cpu")
    training.save_ckpt(str(tmp_path / "p.npz"), p_p, 7)
    back = jesm.load_npz_checkpoint(str(tmp_path / "p.npz"), "mlm-tiny",
                                    jnp.float32)
    assert_trees_close(p_p, back, 0.0)
    assert jt.load_ckpt(str(tmp_path / "p.npz"), p_j)[1] == 7
    jt.save_ckpt(str(tmp_path / "j.npz"), p_j, 3)
    ours, step = training.load_ckpt(str(tmp_path / "j.npz"), p_p)
    assert step == 3
    assert_trees_close(ours, p_j, 0.0)
    assert_trees_close(pesm.load_npz_checkpoint(
        str(tmp_path / "j.npz"), "mlm-tiny", torch.float32, "cpu"), p_j, 0.0)

    m_j = jmsat.init(jax.random.PRNGKey(1), jnp.float32, name="msa-tiny")
    training.save_ckpt(str(tmp_path / "m.npz"),
                       convert.msa_transformer_from_numpy(np_tree(m_j),
                                                          "cpu"), 1)
    assert_trees_close(pmsat.load(str(tmp_path / "m.npz"), dtype=torch.float32,
                                  name="msa-tiny", device="cpu"),
                       jmsat.load(str(tmp_path / "m.npz"), dtype=jnp.float32,
                                  name="msa-tiny"), 0.0)


def test_mnist_checkpoints_are_written_in_the_jax_layout(tmp_path):
    """A port EBM or DAE written by save_ckpt loads in the JAX trainer's
    load_ckpt (what the JAX mnist_sum reads) with equal leaves, and a JAX
    one loads in the port's."""
    _, _, ebm = _ebm(nc=6)
    dae = jmn.dae_init(jax.random.PRNGKey(1), 4, 6)
    for name, tree, conv in (("ebm", ebm, convert.ebm_from_numpy),
                             ("dae", dae, convert.dae_from_numpy)):
        ours = conv(np_tree(tree), "cpu")
        path = str(tmp_path / f"{name}.npz")
        training.save_ckpt(path, convert.mnist_to_numpy(ours), 5)
        back, step = jt.load_ckpt(path, tree)
        assert step == 5
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jpath = str(tmp_path / f"{name}_j.npz")
        jt.save_ckpt(jpath, tree, 6)
        arrays, step = pmn.load_npz(jpath, ours)
        assert step == 6
        for a, b in zip(pesm._flatten(conv(arrays, "cpu")),
                        pesm._flatten(ours)):
            assert torch.equal(a, b)
