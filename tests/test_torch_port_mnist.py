"""ppde_tpu_torch's MNIST domain (models/mnist_nets.py, the MNIST parts of
layers.py, convert.py, torch_convert.py and energy.py, samplers/mnist/)
against ppde_tpu's.

* The tracked EBM and DAE checkpoints: ``mnist_nets.load_npz`` and
  ``convert.*_from_numpy`` give the JAX package's ``training.load_ckpt``
  leaves bit for bit.
* The nets and energies at full width (64 channels, the tracked weights)
  on a few images, float32: values and input gradients within 1e-5 of the
  largest magnitude (sums in another order than XLA's).
* The reference ``.pt`` layouts: both packages' converters read the same
  state dicts into the same arrays; seeded torch modules of the reference
  architecture give the port's outputs.
* The samplers at the JAX sampler tests' tiny config (nc = 4, 4 channels;
  tests/test_mnist_samplers.py), with the JAX package's draws replayed
  through the port's ``Draws`` methods: the same images after every step;
  energies at rtol 1e-5 / atol 1e-3. CMA-ES (numpy-seeded in both) gives
  the JAX package's top-K.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import energy as jenergy, training
from ppde_tpu.models import layers as jlayers, mnist_nets as jnets
from ppde_tpu.models import torch_convert as jtc
from ppde_tpu.samplers import base as jbase
from ppde_tpu.samplers.mnist import cmaes as jcmaes, mala_approx as jmala
from ppde_tpu.samplers.mnist import ppde as jppde, pt as jpt, sa as jsa
from ppde_tpu_torch import convert, energy, utils
from ppde_tpu_torch.models import layers, mnist_nets, torch_convert
from ppde_tpu_torch.samplers.mnist import cmaes, mala_approx, ppde, pt, sa

torch.set_num_threads(2)
EBM_NPZ = "weights/mnist_models/mnist_ebm_ckpt_20000.npz"
DAE_NPZ = "weights/mnist_models/mnist_binary_dae_ckpt_40000.npz"
REL = 1e-5   # of the largest magnitude, float32 at full width
E_TOL = dict(rtol=1e-5, atol=1e-3)
MEAN = 0.3 * np.ones(784, np.float32)


def _close(a, b, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


def _images(n, seed, density=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 784)) < density).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tracked():
    """The tracked EBM and DAE in both packages, and a 3-member regression
    ensemble (nc = 16, the reference width) from a JAX seed."""
    jebm, _ = training.load_ckpt(EBM_NPZ, jnets.ebm_init(
        jax.random.PRNGKey(0), 64, mean=MEAN))
    jdae, _ = training.load_ckpt(DAE_NPZ, jnets.dae_init(
        jax.random.PRNGKey(0), 16, 64))
    g = torch.Generator().manual_seed(0)
    tebm_np, ebm_step = mnist_nets.load_npz(EBM_NPZ, mnist_nets.ebm_init(
        g, 64, mean=MEAN))
    tdae_np, dae_step = mnist_nets.load_npz(DAE_NPZ, mnist_nets.dae_init(
        g, 16, 64))
    assert (ebm_step, dae_step) == (20000, 40000)
    jens = jnets.regression_init_ensemble(jax.random.PRNGKey(3), 3, nc=16)
    return {"jebm": jebm, "jdae": jdae, "jens": jens,
            "tebm": convert.ebm_from_numpy(tebm_np, "cpu"),
            "tdae": convert.dae_from_numpy(tdae_np, "cpu"),
            "tens": convert.mnist_regression_from_numpy(_np(jens), "cpu")}


# ---------------------------------------------------------------------------
# checkpoints and converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,kind,n_leaves", [(EBM_NPZ, "ebm", 41),
                                                (DAE_NPZ, "dae", 88)])
def test_load_npz_gives_the_jax_leaves(tracked, path, kind, n_leaves):
    """load_npz + *_from_numpy == training.load_ckpt's leaves, carried by
    the same converter, bit for bit; the EBM's p38 is its mean."""
    j = tracked["j" + kind]
    t = tracked["t" + kind]
    from_numpy = convert.ebm_from_numpy if kind == "ebm" \
        else convert.dae_from_numpy
    want = from_numpy(_np(j), "cpu")
    jl, tl = jax.tree.leaves(want), jax.tree.leaves(t)
    assert len(jl) == len(tl) == n_leaves
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if kind == "ebm":
        np.testing.assert_array_equal(t["mean"].numpy(),
                                      np.load(path)["p38"])
        # the shortcut blocks: 0 and 1 (stride 2)
        assert ["shortcut" in b for b in t["blocks"]] == [True] * 2 + \
            [False] * 6


def test_load_npz_rejects_another_model(tmp_path):
    with pytest.raises(ValueError, match="88 leaves.*41"):
        mnist_nets.load_npz(DAE_NPZ, mnist_nets.ebm_init(
            torch.Generator(), 64, mean=MEAN))
    with pytest.raises(ValueError, match="leaf p0.*fit"):
        mnist_nets.load_npz(EBM_NPZ, mnist_nets.ebm_init(
            torch.Generator(), 32, mean=MEAN))


@pytest.mark.parametrize("stride,pad,out_pad,k,hw", [
    (2, 1, 1, 3, 7), (2, 1, 1, 3, 14), (2, 0, 1, 1, 7), (2, 0, 1, 1, 14)])
def test_conv_transpose_matches_jax_at_the_dae_shapes(stride, pad, out_pad,
                                                      k, hw):
    """The DAE decoder's transposed convs (7 -> 14 -> 28, the 3x3 conv and
    the 1x1 shortcut): JAX's [kh,kw,out,in] kernel, flipped at call time,
    against torch's [in,out,kh,kw] after the (3, 2, 0, 1) permutation with
    no flip."""
    c_in, c_out = 5, 6
    jp = jlayers.init_conv_transpose2d(jax.random.PRNGKey(hw + k), k, k,
                                       c_in, c_out)
    x = np.random.default_rng(k).normal(size=(2, hw, hw, c_in)).astype(
        np.float32)
    want = jlayers.conv_transpose2d(jp, jnp.asarray(x), stride=stride,
                                    padding=pad, output_padding=out_pad)
    tp = convert.dae_from_numpy({"c": _np(jp)}, "cpu")["c"]
    got = layers.conv_transpose2d(tp, torch.from_numpy(x).permute(0, 3, 1, 2),
                                  stride=stride, padding=pad,
                                  output_padding=out_pad)
    assert got.shape == (2, c_out, 2 * hw, 2 * hw)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 9, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    jc = jlayers.init_conv2d(jax.random.PRNGKey(0), 3, 3, 4, 5)
    tc = convert.ebm_from_numpy({"c": _np(jc)}, "cpu")["c"]
    for stride, pad in ((1, 1), (2, 1), (2, 0)):
        _close(layers.conv2d(tc, xt, stride, pad).permute(0, 2, 3, 1),
               jlayers.conv2d(jc, jnp.asarray(x), stride, pad))
    bn = {"gamma": rng.normal(size=4).astype(np.float32),
          "beta": rng.normal(size=4).astype(np.float32),
          "mean": rng.normal(size=4).astype(np.float32),
          "var": rng.uniform(0.5, 2, size=4).astype(np.float32)}
    _close(layers.batchnorm2d(convert.ebm_from_numpy(bn, "cpu"), xt)
           .permute(0, 2, 3, 1), jlayers.batchnorm2d(bn, jnp.asarray(x)))
    _close(layers.swish(torch.from_numpy(x)), jlayers.swish(jnp.asarray(x)))
    _close(utils.flip_bits(torch.tensor([[0.0, 1, 0, 1]]),
                           torch.tensor([[1.0, 1, 0, 0]])),
           np.array([[1.0, 0, 0, 1]]))
    g = torch.Generator().manual_seed(0)
    assert layers.init_conv2d(g, 3, 3, 4, 5)["w"].shape == (5, 4, 3, 3)
    assert layers.init_conv_transpose2d(g, 3, 3, 4, 5)["w"].shape == \
        (4, 5, 3, 3)


class _RefRegression(torch.nn.Module):
    """The reference MNISTRegressionNet (ppde/nets.py:14-37)."""

    def __init__(self, nc):
        super().__init__()
        c = torch.nn.Conv2d
        self.net = torch.nn.Sequential(
            c(1, nc, 4, 2, 1), torch.nn.SiLU(), c(nc, nc, 4, 2, 1),
            torch.nn.SiLU(), c(nc, nc, 4, 2, 1), torch.nn.SiLU(),
            c(nc, nc, 3, 1, 0), torch.nn.SiLU())
        self.out = torch.nn.Linear(nc, 1)

    def forward(self, x1, x2):
        h = (self.net(x1.view(-1, 1, 28, 28)).flatten(1)
             + self.net(x2.view(-1, 1, 28, 28)).flatten(1))
        return self.out(h)[:, 0]


def test_regression_pt_roundtrip_and_reference_module(tmp_path):
    """A seeded reference module's state dict: both packages' converters
    read the same arrays, the port's net gives the module's output; the
    port's writer round-trips its own parameters."""
    torch.manual_seed(0)
    mods = [_RefRegression(16) for _ in range(3)]
    paths = []
    for i, m in enumerate(mods):
        paths.append(str(tmp_path / f"ensemble_{i}_ckpt_25000.pt"))
        torch.save(m.state_dict(), paths[-1])
    mine = torch_convert.mnist_regression_ensemble(paths)
    theirs = jtc.mnist_regression_ensemble(paths)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(_np(theirs))):
        np.testing.assert_array_equal(a, b)
    x1, x2 = _images(4, 0), _images(4, 1)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    ens = convert.mnist_regression_from_numpy(mine, "cpu")
    with torch.no_grad():
        want = torch.stack([m(t1, t2) for m in mods]).mean(0)
        single = mnist_nets.regression_apply(
            convert.mnist_regression_from_numpy(
                torch_convert.mnist_regression(paths[0]), "cpu"), t1, t2)
        _close(single, mods[0](t1, t2).numpy())
    _close(mnist_nets.regression_ensemble_apply(ens, t1, t2), want.numpy())
    _close(jnets.regression_ensemble_apply(theirs, jnp.asarray(x1),
                                           jnp.asarray(x2)), want.numpy())
    member = mnist_nets.regression_init(torch.Generator().manual_seed(1), 16)
    torch_convert.save_mnist_regression(str(tmp_path / "m.pt"), member)
    back = convert.mnist_regression_from_numpy(
        torch_convert.mnist_regression(str(tmp_path / "m.pt")), "cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(member)):
        assert torch.equal(a, b)


def _sd_block(sd, prefix, p, up):
    for conv, name in (("conv1", "conv1"), ("conv2", "conv2"),
                       ("shortcut", "shortcut_conv")):
        if conv in p:
            sd[f"{prefix}.{name}.weight"] = p[conv]["w"]
            sd[f"{prefix}.{name}.bias"] = p[conv]["b"]
    for norm in ("norm1", "norm2"):
        if norm in p:
            for k, v in (("weight", "gamma"), ("bias", "beta"),
                         ("running_mean", "mean"), ("running_var", "var")):
                sd[f"{prefix}.{norm}.{k}"] = p[norm][v]


def test_ebm_and_dae_pt_loaders_match_jax(tmp_path, tracked):
    """State dicts in the reference module layouts, written from the
    tracked weights: both packages' loaders give the same arrays, and the
    port's carry gives back the port's parameters."""
    ebm, dae = tracked["tebm"], tracked["tdae"]
    sd = {"net.proj.weight": ebm["proj"]["w"], "net.proj.bias":
          ebm["proj"]["b"], "net.energy_linear.weight":
          ebm["energy_linear"]["w"].T, "net.energy_linear.bias":
          ebm["energy_linear"]["b"], "mean": ebm["mean"]}
    for i, b in enumerate(ebm["blocks"]):
        _sd_block(sd, f"net.net.{i}", b, False)
    torch.save({"model": sd}, tmp_path / "ebm.pt")
    sd = {"encoder.0.weight": dae["enc_proj"]["w"],
          "encoder.0.bias": dae["enc_proj"]["b"],
          "fc.weight": dae["fc"]["w"].T, "fc.bias": dae["fc"]["b"],
          "decoder.0.weight": dae["dec_proj"]["w"].T,
          "decoder.0.bias": dae["dec_proj"]["b"],
          "final_layer.weight": dae["final"]["w"],
          "final_layer.bias": dae["final"]["b"]}
    for i, b in zip((1, 2, 3), dae["enc_blocks"]):
        _sd_block(sd, f"encoder.{i}", b, False)
    for i, b in zip((2, 3, 4), dae["dec_blocks"]):
        _sd_block(sd, f"decoder.{i}", b, i in (2, 3))
    torch.save(sd, tmp_path / "dae.pt")
    for name, load, jload, from_numpy, params in (
            ("ebm", torch_convert.resnet_ebm, jtc.resnet_ebm,
             convert.ebm_from_numpy, ebm),
            ("dae", torch_convert.dae, jtc.dae, convert.dae_from_numpy,
             dae)):
        mine = load(str(tmp_path / f"{name}.pt"))
        theirs = jload(str(tmp_path / f"{name}.pt"))
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(from_numpy(mine, "cpu")),
                        jax.tree.leaves(params)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# nets and energies at full width
# ---------------------------------------------------------------------------

def test_nets_match_jax_at_full_width(tracked):
    x1, x2 = _images(3, 0), _images(3, 1)
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    _close(mnist_nets.ebm_log_prob(tracked["tebm"], t2),
           jnets.ebm_log_prob(tracked["jebm"], j2))
    _close(mnist_nets.dae_log_prob(tracked["tdae"], t2),
           jnets.dae_log_prob(tracked["jdae"], j2))
    _close(mnist_nets.dae_logits(tracked["tdae"], t2),
           jnets.dae_logits(tracked["jdae"], j2))
    _close(mnist_nets.regression_ensemble_apply(tracked["tens"], t1, t2),
           jnets.regression_ensemble_apply(tracked["jens"], j1, j2))
    single = jax.tree.map(lambda a: a[1], tracked["jens"])
    _close(mnist_nets.regression_apply(
        convert.mnist_regression_from_numpy(_np(single), "cpu"), t1, t2),
        jnets.regression_apply(single, j1, j2))


@pytest.mark.parametrize("kind", ["ebm", "dae", "supervised"])
def test_energies_and_gradients_match_jax(tracked, kind):
    """Both MNIST energies (and the supervised one) with their gradients
    with respect to x2, at lambda 10 (the CLI's default)."""
    if kind == "supervised":
        jen = jenergy.mnist_supervised(tracked["jens"])
        ten = energy.mnist_supervised(tracked["tens"])
    else:
        jen = jenergy.mnist_poe(tracked["j" + kind], tracked["jens"], 10.0,
                                kind)
        ten = energy.mnist_poe(tracked["t" + kind], tracked["tens"], 10.0,
                               kind)
    x1, x2 = _images(3, 2), _images(3, 3)
    je, jf, jg = jax.jit(jen.energy_and_grad)(jen.params, jnp.asarray(x2),
                                              jnp.asarray(x1))
    with torch.no_grad():
        te, tf, tg = ten.energy_and_grad(ten.params, torch.from_numpy(x2),
                                         torch.from_numpy(x1))
        e2, f2 = ten.energy(ten.params, torch.from_numpy(x2),
                            torch.from_numpy(x1))
    assert not tg.requires_grad
    _close(te, je)
    _close(tf, jf)
    _close(tg, jg)
    np.testing.assert_array_equal(e2.numpy(), te.numpy())
    _close(ten.fitness(ten.params, torch.from_numpy(x2),
                       torch.from_numpy(x1)), jf)


# ---------------------------------------------------------------------------
# samplers with the JAX package's draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """tests/test_mnist_samplers.py's config in both packages: a 2-member
    ensemble and an oracle at nc = 4, an EBM at 4 channels with mean 0.3,
    6 chains sharing one x1 (PT's replica columns)."""
    jens = jnets.regression_init_ensemble(jax.random.PRNGKey(0), 2, nc=4)
    jebm = jnets.ebm_init(jax.random.PRNGKey(1), n_channels=4, mean=MEAN)
    jor = jnets.regression_init(jax.random.PRNGKey(2), nc=4)
    jen = jenergy.mnist_poe(jebm, jens, lam=1.0, unsup_kind="ebm")
    ten = energy.mnist_poe(convert.ebm_from_numpy(_np(jebm), "cpu"),
                           convert.mnist_regression_from_numpy(_np(jens),
                                                               "cpu"),
                           lam=1.0, unsup_kind="ebm")
    tor = convert.mnist_regression_from_numpy(_np(jor), "cpu")
    rng = np.random.default_rng(0)
    x1 = np.repeat((rng.random((1, 784)) > 0.7).astype(np.float32), 6, 0)
    x2 = (rng.random((6, 784)) > 0.7).astype(np.float32)
    pop = np.concatenate([x1, x2], 1)
    return {"jen": jen, "ten": ten, "pop": pop,
            "jorc": (jor, lambda p, a, b: jnets.regression_apply(p, b, a)),
            "torc": (tor, lambda p, a, b: mnist_nets.regression_apply(p, b,
                                                                      a))}


class Replay:
    """Hands out a queue of the JAX package's draws through the port's
    ``Draws`` methods, checking each shape."""

    def __init__(self, queue):
        self.queue = [np.array(a) for a in queue][::-1]

    def _next(self, shape):
        a = torch.from_numpy(self.queue.pop())
        assert a.numel() == int(np.prod(np.atleast_1d(shape))), a.shape
        return a.reshape(tuple(np.atleast_1d(shape)))

    def path_lengths(self, n, high):
        return self._next((n,)).long()

    def gumbel(self, shape):
        return self._next(shape)

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)

    def poisson(self, rate):
        return self._next(rate.shape).float()


def pas_draws(k, n, D, pas_length):
    k_u, k_inner, k_acc = jax.random.split(k, 3)
    out = [jax.random.randint(k_u, (n,), 1, 2 * pas_length)]
    out += [jax.random.gumbel(ki, (n, D))
            for ki in jax.random.split(k_inner, max(2 * pas_length - 1, 1))]
    return out + [jax.random.uniform(k_acc, (n,))]


def gwg_draws(k, n, D, gwg):
    k_n, k_s, k_acc = jax.random.split(k, 3)
    max_s = max(2 * gwg - 1, 1)
    return [jax.random.randint(k_n, (), 1, 2 * gwg),
            jax.random.gumbel(k_s, (max_s, n, D)),
            jax.random.uniform(k_acc, (n,))]


def run_queue(key, num_steps, log_every, per_step):
    """run_segmented's key splits; per step ``per_step(step_key)``."""
    queue = []
    for length in jbase.segment_lengths(num_steps, log_every):
        key, seg_key = jax.random.split(key)
        for k in jax.random.split(seg_key, length):
            queue += per_step(k)
    return queue


def _same_states(rt, rj):
    for k in ("final_x", "best_x", "random_traj"):
        np.testing.assert_array_equal(getattr(rt, k),
                                      np.asarray(getattr(rj, k)), err_msg=k)
    for k in ("energy_history", "fitness_history", "best_energy",
              "oracle_history"):
        np.testing.assert_allclose(getattr(rt, k),
                                   np.asarray(getattr(rj, k)), **E_TOL,
                                   err_msg=k)
    if rj.n_accepted is not None:
        np.testing.assert_array_equal(rt.n_accepted, rj.n_accepted)


N_STEPS, LOG_EVERY = 6, 3


@pytest.mark.parametrize("pas_length,gwg", [(3, 1), (1, 1), (0, 1), (0, 3)])
def test_ppde_matches_jax_with_replayed_draws(tiny, pas_length, gwg):
    """PAS (path lengths 5 and 1) and GWG (single flips and unions of up
    to 5): the JAX package's images after every step."""
    key = jax.random.PRNGKey(pas_length * 10 + gwg)
    jcfg = jppde.MNISTPPDEConfig(pas_length=pas_length, gwg_samples=gwg)
    rj = jppde.run(tiny["jen"], jnp.asarray(tiny["pop"]), N_STEPS,
                   oracle=tiny["jorc"], cfg=jcfg, key=key,
                   log_every=LOG_EVERY, quiet=True)
    n, D = 6, 784
    per = ((lambda k: pas_draws(k, n, D, pas_length)) if pas_length
           else (lambda k: gwg_draws(k, n, D, gwg)))
    rt = ppde.run(tiny["ten"], tiny["pop"], N_STEPS, oracle=tiny["torc"],
                  cfg=ppde.MNISTPPDEConfig(pas_length=pas_length,
                                           gwg_samples=gwg),
                  draws=Replay(run_queue(key, N_STEPS, LOG_EVERY, per)),
                  log_every=LOG_EVERY, quiet=True, device="cpu")
    _same_states(rt, rj)
    assert rt.n_accepted.sum() > 0


def test_pt_matches_jax_with_replayed_draws(tiny):
    key = jax.random.PRNGKey(7)
    K, n, D = 2, 6, 784
    rj = jpt.run(tiny["jen"], jnp.asarray(tiny["pop"]), N_STEPS,
                 oracle=tiny["jorc"],
                 cfg=jpt.MNISTPTConfig(pas_length=2, n_levels=K), key=key,
                 log_every=LOG_EVERY, quiet=True)

    def per(k):
        k_move, k_swap = jax.random.split(k)
        return pas_draws(k_move, n, D, 2) + [
            jax.random.uniform(k_swap, (K, n // K))]
    rt = pt.run(tiny["ten"], tiny["pop"], N_STEPS, oracle=tiny["torc"],
                cfg=pt.MNISTPTConfig(pas_length=2, n_levels=K),
                draws=Replay(run_queue(key, N_STEPS, LOG_EVERY, per)),
                log_every=LOG_EVERY, quiet=True, device="cpu")
    _same_states(rt, rj)


def test_pt_refuses_mixed_x1_columns(tiny):
    pop = tiny["pop"].copy()
    pop[0, :784] = 1 - pop[0, :784]
    with pytest.raises(ValueError, match="replica column"):
        pt.run(tiny["ten"], pop, 1, cfg=pt.MNISTPTConfig(n_levels=2),
               quiet=True, device="cpu")


def test_sa_matches_jax_with_replayed_draws(tiny):
    key = jax.random.PRNGKey(3)
    n, D = 6, 784
    cfg = dict(temp=10.0, muts_per_seq_param=5.0, max_edits=24)
    rj = jsa.run(tiny["jen"], jnp.asarray(tiny["pop"]), N_STEPS,
                 oracle=tiny["jorc"], cfg=jsa.MNISTSAConfig(**cfg), key=key,
                 log_every=LOG_EVERY, quiet=True)
    key, k_mu = jax.random.split(key)
    u = jax.random.uniform(k_mu, (n,))
    mu = 5.0 * u + 1.0

    def per(k):
        k_prop, k_acc = jax.random.split(k)
        k_pois, k_pos = jax.random.split(k_prop)
        return [jax.random.poisson(k_pois, mu - 1.0),
                jax.random.gumbel(k_pos, (n, D)),
                jax.random.uniform(k_acc, (n,))]
    rt = sa.run(tiny["ten"], tiny["pop"], N_STEPS, oracle=tiny["torc"],
                cfg=sa.MNISTSAConfig(**cfg),
                draws=Replay([u] + run_queue(key, N_STEPS, LOG_EVERY, per)),
                log_every=LOG_EVERY, quiet=True, device="cpu")
    _same_states(rt, rj)


def test_sa_propose_flips_distinct_pixels():
    """Poisson(mu - 1) + 1 distinct flips, clipped to max_edits: the flip
    count per chain equals the replayed count."""
    x = torch.from_numpy(_images(4, 5))
    counts = torch.tensor([0.0, 3.0, 30.0, 1.0])
    g = torch.from_numpy(np.random.default_rng(0).gumbel(size=(4, 784))
                         .astype(np.float32))
    y = sa.propose_flips(Replay([counts, g]), x, torch.ones(4), 24)
    assert (y != x).sum(-1).tolist() == [1, 4, 24, 2]
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}


def test_mala_matches_jax_with_replayed_draws(tiny):
    key = jax.random.PRNGKey(4)
    shape = (6, 784)
    rj = jmala.run(tiny["jen"], jnp.asarray(tiny["pop"]), N_STEPS,
                   oracle=tiny["jorc"],
                   cfg=jmala.MNISTMALAConfig(step_size=0.1), key=key,
                   log_every=LOG_EVERY, quiet=True)

    def per(k):
        k_s, k_noise = jax.random.split(k)
        return [jax.random.uniform(k_s, shape, minval=1e-6,
                                   maxval=1 - 1e-6),
                jax.random.normal(k_noise, shape)]
    rt = mala_approx.run(tiny["ten"], tiny["pop"], N_STEPS,
                         oracle=tiny["torc"],
                         cfg=mala_approx.MNISTMALAConfig(step_size=0.1),
                         draws=Replay(run_queue(key, N_STEPS, LOG_EVERY,
                                                per)),
                         log_every=LOG_EVERY, quiet=True, device="cpu")
    _same_states(rt, rj)


def test_cmaes_matches_jax(tiny):
    """Numpy-seeded in both packages: the same final population, its
    energies (the top-K order) and histories."""
    kw = dict(num_steps=8, log_every=4, quiet=True, seed=5)
    rj = jcmaes.run(tiny["jen"], jnp.asarray(tiny["pop"]),
                    oracle=tiny["jorc"],
                    cfg=jcmaes.MNISTCMAESConfig(population_size=4), **kw)
    rt = cmaes.run(tiny["ten"], tiny["pop"], oracle=tiny["torc"],
                   cfg=cmaes.MNISTCMAESConfig(population_size=4),
                   device="cpu", **kw)
    np.testing.assert_array_equal(rt.final_x, rj.final_x)
    np.testing.assert_array_equal(rt.best_x, rj.best_x)
    for k in ("best_energy", "best_fitness", "energy_history",
              "fitness_history", "oracle_history"):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), **E_TOL,
                                   err_msg=k)
    assert rt.energy_history.shape == (3, 6)
