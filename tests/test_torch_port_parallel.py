"""ppde_tpu_torch.parallel.mesh and runtime.apply_mesh on the CPU, under gloo.

The port runs one process per device; these tests spawn 2-4 ranks (one
thread each, a process group over a file under ``tmp_path``) and group the
checks of one world size into one spawn. Each rank returns numpy arrays;
the sharded runs are held against the unsharded port in the same rank and
against the JAX package (``tests/test_parallel.py``'s cases, run here on
the conftest's 8-device virtual mesh), with JAX's tolerances: tp Potts and
the ep ensemble rtol 1e-4 / atol 1e-5; full runs best_x equal, energies
within 2e-5; tp and sp ESM logits within 1e-5 (tp PLL 2e-5, as JAX), dE/dx
rtol 1e-4 / atol 1e-5. dp equals single device bit for bit. The module's
top level imports no JAX: the spawned ranks import it.
"""
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ppde_tpu_torch import codec, energy as energy_mod, runtime
from ppde_tpu_torch.models import cnn, esm2, potts
from ppde_tpu_torch.parallel import mesh as pmesh
from ppde_tpu_torch.samplers.protein import mala_approx, ppde, pt

WT = "ACDEFGHIKLMNPQRSTVWYACDEFGHIKLMN"  # 32 residues: P = 640
TINY = dict(layers=4, dim=64, heads=4, ffn=128)


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; their returns."""
    out = str(tmp_path)
    torch.multiprocessing.spawn(
        _entry, args=(world, f"file://{out}/pg", out, fn, args),
        nprocs=world, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, init, out, fn, args):
    torch.set_num_threads(1)
    # a collective that one rank never joins fails after this, not hangs
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        torch.save(fn(rank, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def build(n_chains=8, transformer=None, ens=None):
    """Potts (seed 0) + a 4-member CNN ensemble (seed 0, or ``ens``),
    lambda 1, as ``tests/test_parallel.py::build`` makes them."""
    pp = potts.synthetic(WT, seed=0, device="cpu")
    if ens is None:
        ens = cnn.init_ensemble(torch.Generator().manual_seed(0), 4,
                                input_size=len(WT))
    wt = torch.from_numpy(codec.seqs_to_onehot([WT]))
    en = energy_mod.protein_poe(pp, ens, 1.0, wt, transformer=transformer)
    return en, pp, ens, wt.repeat(n_chains, 1, 1)


def mixed_pop(n, seed=1):
    """The wild type with 0-5 random mutations a row."""
    rng = np.random.default_rng(seed)
    x = np.repeat(codec.seqs_to_onehot([WT]), n, 0)
    for i in range(n):
        for p in rng.choice(len(WT), size=i % 6, replace=False):
            x[i, p] = np.eye(20, dtype=np.float32)[rng.integers(20)]
    return torch.from_numpy(x)


def tiny_expert(dtype=torch.float32):
    esm2.CONFIGS["_tiny"] = dict(TINY)
    try:
        return esm2.load_expert("_tiny", WT, allow_random=True, dtype=dtype,
                                device="cpu")
    finally:
        del esm2.CONFIGS["_tiny"]


def np_(t):
    return t.detach().numpy().copy()


def run_fields(res):
    return {"best_x": res.best_x, "best_energy": res.best_energy,
            "energy_history": res.energy_history}


# ---------------------------------------------------------------------------
# 4 ranks: the mesh, tp Potts, the ep ensemble, full runs
# ---------------------------------------------------------------------------

def _ranks_mesh_potts_ensemble(rank):
    got = {}
    mesh = pmesh.make_mesh(dp=2, tp=2, device="cpu")
    got["shape"] = pmesh.mesh_shape(mesh)
    got["default_dp"] = pmesh.mesh_shape(pmesh.make_mesh(tp=2,
                                                         device="cpu"))
    for bad in (dict(dp=3), dict(dp=2, tp=4), dict(ep=3)):
        try:
            pmesh.make_mesh(device="cpu", **bad)
            got[f"err{bad}"] = None
        except ValueError as e:
            got[f"err{bad}"] = str(e)
    try:
        pmesh.make_mesh(dp=4, device="cuda")
        got["backend"] = None
    except RuntimeError as e:
        got["backend"] = str(e)

    en, pp, ens, pop = build()
    x = mixed_pop(8)
    got["chains"] = tuple(pmesh.shard_chains(pop, mesh).local.shape)
    e0, g0 = potts.score_and_grad(pp, x)
    xg = x.clone().requires_grad_(True)
    (d0,) = torch.autograd.grad(potts.score(pp, xg).sum(), xg)
    for tp in (2, 4):
        m = pmesh.make_mesh(dp=4 // tp, tp=tp, device="cpu")
        blk = pmesh.shard_potts(pp, m)
        got[f"tp{tp}_block"] = (tuple(blk.W.shape), blk.col0)
        e, g = potts.score_and_grad(blk, x)
        xg = x.clone().requires_grad_(True)
        s = potts.score(blk, xg)
        (d,) = torch.autograd.grad(s.sum(), xg)
        got[f"tp{tp}"] = [np_(a) for a in (e, e0, g, g0, s, d, d0)]
    # a sum over 4 ranks (all_reduce) gives every rank the same bits
    parts = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        n).astype(np.float32)) for r, n in ((rank, 4099), (rank + 4, 7))]
    got["all_sum"] = [np_(pmesh.all_sum(parts[0], pmesh.axis(m, "tp")))] \
        + [np_(t) for t in pmesh.all_sum_list(parts, pmesh.axis(m, "tp"))]

    m = pmesh.make_mesh(dp=2, ep=2, device="cpu")
    sh = pmesh.shard_ensemble(ens, m)
    got["ep_members"] = sh.local["encoder"]["w"].shape[0]
    three = pmesh.shard_ensemble(
        cnn.init_ensemble(torch.Generator().manual_seed(1), 3,
                          input_size=len(WT)), m)
    got["ep_three"] = (three.axis, three.local["encoder"]["w"].shape[0])
    p_sh = dict(en.params, sup=sh)
    f, fd, g = en.energy_and_grad(en.params, x)
    f1, fd1, g1 = en.energy_and_grad(p_sh, x)
    fit, fit1 = en.fitness(en.params, x), en.fitness(p_sh, x)
    got["ep"] = [np_(a) for a in (f, f1, fd, fd1, g, g1, fit, fit1)]
    return got


def test_mesh_potts_and_ensemble_shards(tmp_path):
    """make_mesh, its errors, the shard shapes; tp Potts (tp = 2 and 4, on
    a P = 640 that both re-pad) and the ep ensemble against replicated
    (``test_tp_potts_matches_replicated``,
    ``test_ep_ensemble_matches_replicated``, ``test_shard_placement``);
    the tp Potts scores and gradients also against the JAX package's on its
    dp 4 x tp 2 mesh."""
    import jax

    from ppde_tpu.models import potts as jpotts
    from ppde_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    jm = jmesh.make_mesh(dp=4, ep=1, tp=2)
    with jm:
        je, jg = jax.jit(lambda p, x: jpotts.score_and_grad(p, x))(
            jmesh.shard_potts(jpotts.synthetic(WT, seed=0), jm),
            mixed_pop(8).numpy())
    runs = spawn(_ranks_mesh_potts_ensemble, 4, tmp_path)
    want = [sum(np.random.default_rng(r + k).standard_normal(n).astype(
        np.float64) for r in range(4)) for k, n in ((0, 4099), (4, 7))]
    for got in runs:
        for a, b in zip(got["all_sum"], runs[0]["all_sum"]):
            np.testing.assert_array_equal(a, b)
        for a, w in zip(got["all_sum"], want[:1] + want):
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5)
    for rank, got in enumerate(runs):
        assert got["shape"] == {"dp": 2, "ep": 1, "tp": 2, "sp": 1, "pp": 1}
        assert got["default_dp"]["dp"] == 2
        for bad, msg in got.items():
            if bad.startswith("err"):
                assert "differs from the world size 4" in msg \
                    or "not a multiple" in msg, (bad, msg)
        assert "nccl" in got["backend"] and "gloo" in got["backend"]
        assert got["chains"] == (4, 32, 20)
        assert got["tp2_block"] == ((768, 384), 384 * (rank % 2))
        assert got["tp4_block"] == ((1024, 256), 256 * rank)
        for tp in (2, 4):
            e, e0, g, g0, s, d, d0 = got[f"tp{tp}"]
            np.testing.assert_allclose(e, e0, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, g0, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(s, e0, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(d, d0, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(e, np.asarray(je), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4,
                                       atol=1e-5)
        assert got["ep_members"] == 2
        assert got["ep_three"] == (None, 3)   # 3 members on ep = 2: whole
        f, f1, fd, fd1, g, g1, fit, fit1 = got["ep"]
        for a, b in ((f, f1), (fd, fd1), (g, g1), (fit, fit1)):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def _ranks_full_runs(rank, n_steps):
    got = {}
    en, pp, ens, pop = build()
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=5)

    def run(sampler, energy, cfg, seed):
        return sampler.run(energy, pop, num_steps=n_steps, min_pos=0,
                           max_pos=31, cfg=cfg, log_every=n_steps // 2,
                           quiet=True, device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    for name, kw in (("dp2_tp2", dict(dp=2, tp=2)),
                     ("dp1_ep2_tp2", dict(dp=1, ep=2, tp=2)),
                     ("dp2_ep2", dict(dp=2, ep=2)),
                     ("dp4", dict(dp=4))):
        mesh, en_sh, pop_sh = runtime.apply_mesh(en, pop, **kw)
        got[name] = (pmesh.mesh_shape(mesh), kw,
                     run_fields(run(ppde, en_sh, cfg, 7)))
    got["single"] = run_fields(run(ppde, en, cfg, 7))
    ptc = pt.PTConfig(pas_length=2, nmut_threshold=5, n_levels=4,
                      beta_min=0.3)
    mesh, en_sh, _ = runtime.apply_mesh(en, pop, dp=2, tp=2)
    got["pt"] = (run_fields(run(pt, en_sh, ptc, 13)),
                 run_fields(run(pt, en, ptc, 13)))
    # MALA-approx differentiates energy.energy: dx over dp = 4 and over
    # dp = 2 x tp = 2 against one device (no factor of the group's size)
    x = mixed_pop(8).requires_grad_(True)
    (dx0,) = torch.autograd.grad(en.energy(en.params, x)[0].sum(), x)
    for name, kw in (("mala_dp4", dict(dp=4)),
                     ("mala_dp2_tp2", dict(dp=2, tp=2))):
        _, en_sh, _ = runtime.apply_mesh(en, pop, **kw)
        (dx,) = torch.autograd.grad(en_sh.energy(en_sh.params, x)[0].sum(),
                                    x)
        mc = mala_approx.MALAConfig()
        got[name] = (np_(dx), np_(dx0),
                     run_fields(run(mala_approx, en_sh, mc, 5)),
                     run_fields(run(mala_approx, en, mc, 5)))
    return got


def test_apply_mesh_full_runs_match_single_device(tmp_path):
    """runtime.apply_mesh + full sampler runs == the unsharded run: PPDE on
    dp x tp, ep x tp, dp x ep and dp alone; PPDE-PT (its exchange across
    level blocks) on dp x tp; MALA-approx's dx and run on dp and dp x tp
    (``test_apply_mesh_full_run_matches_single_device``, ``..._dp_ep_tp_
    ...``, ``..._pt_...``)."""
    for got in spawn(_ranks_full_runs, 4, tmp_path, 12):
        single = got["single"]
        for name in ("dp2_tp2", "dp1_ep2_tp2", "dp2_ep2", "dp4"):
            shape, kw, res = got[name]
            assert shape == {"dp": 1, "ep": 1, "tp": 1, "sp": 1, "pp": 1,
                             **kw}
            np.testing.assert_array_equal(res["best_x"], single["best_x"])
            np.testing.assert_allclose(res["best_energy"],
                                       single["best_energy"], rtol=2e-5,
                                       atol=2e-5)
        # dp alone: every row's numbers are the single device's
        for k in single:
            np.testing.assert_array_equal(got["dp4"][2][k], single[k])
        a, b = got["pt"]
        np.testing.assert_array_equal(a["best_x"], b["best_x"])
        np.testing.assert_allclose(a["best_energy"], b["best_energy"],
                                   rtol=2e-5, atol=2e-5)
        for name in ("mala_dp4", "mala_dp2_tp2"):
            dx, dx0, a, b = got[name]
            np.testing.assert_allclose(dx, dx0, rtol=1e-5, atol=1e-6)
            assert np.abs(dx0).max() > 0.1
            np.testing.assert_array_equal(a["best_x"], b["best_x"])
            np.testing.assert_allclose(a["best_energy"], b["best_energy"],
                                       rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(got["mala_dp4"][0], got["mala_dp4"][1])


def _ranks_dp_ep_tp(rank, n_steps):
    en, pp, ens, pop = build()
    cfg = ppde.PPDEConfig(pas_length=2, nmut_threshold=5)

    def run(energy):
        return run_fields(ppde.run(
            energy, pop, num_steps=n_steps, min_pos=0, max_pos=31, cfg=cfg,
            log_every=n_steps // 2, quiet=True, device="cpu",
            generator=torch.Generator().manual_seed(11)))

    mesh, en_sh, _ = runtime.apply_mesh(en, pop, dp=2, tp=2, ep=2)
    return {"shape": pmesh.mesh_shape(mesh),
            "members": en_sh.params["sup"].local["encoder"]["w"].shape[0],
            "sharded": run(en_sh), "single": run(en)}


def test_apply_mesh_dp_ep_tp_on_eight_ranks(tmp_path):
    """All three axes in one run on 8 ranks: chains over dp, the 4-member
    ensemble over ep (2 members a rank), the couplings over tp; equal to
    the single device (``test_apply_mesh_dp_ep_tp_full_run_matches_single_
    device``: best_x equal, energies within 2e-5)."""
    for got in spawn(_ranks_dp_ep_tp, 8, tmp_path, 10):
        assert got["shape"] == {"dp": 2, "ep": 2, "tp": 2, "sp": 1, "pp": 1}
        assert got["members"] == 2
        a, b = got["sharded"], got["single"]
        np.testing.assert_array_equal(a["best_x"], b["best_x"])
        np.testing.assert_allclose(a["best_energy"], b["best_energy"],
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# 4 ranks: tensor- and sequence-parallel ESM2
# ---------------------------------------------------------------------------

def _ranks_esm(rank, jax_s):
    from ppde_tpu_torch import convert

    got = {}
    esm2.CONFIGS["_tiny"] = dict(TINY)
    try:
        tiny = esm2.init(torch.Generator().manual_seed(0), "_tiny",
                         torch.float32)
    finally:
        del esm2.CONFIGS["_tiny"]
    rng = np.random.default_rng(0)

    def onehot(B, T):
        return torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(4, 24, (B, T))),
            esm2.ESM_VOCAB).float()

    # tp over transformer-S (20 heads, tp = 4: 5 heads a rank; the JAX
    # test's weights and batch) and the 650M shapes (transformer-L cut to 2
    # layers, remat)
    for name, layers, T, remat in (("transformer-S", None, 24, False),
                                   ("transformer-L", 2, 16, True)):
        if name == "transformer-S":
            params = convert.esm2_from_numpy(jax_s[0], "cpu")
            x = torch.from_numpy(jax_s[1])
        else:
            params = esm2.init(torch.Generator().manual_seed(1), name,
                               torch.float32)
            params["layers"] = params["layers"][:layers]
            x = onehot(4, T)
        heads = esm2.CONFIGS[name]["heads"]
        ref = esm2.pseudo_log_likelihood(params, x, heads, remat)
        mesh = pmesh.make_mesh(dp=1, tp=4, device="cpu")
        p_sh = pmesh.shard_esm(params, mesh, heads)
        xg = x.clone().requires_grad_(True)
        out = esm2.pseudo_log_likelihood(p_sh, xg, heads, remat)
        (g,) = torch.autograd.grad(out.sum(), xg)
        xg = x.clone().requires_grad_(True)
        (g0,) = torch.autograd.grad(
            esm2.pseudo_log_likelihood(params, xg, heads, remat).sum(), xg)
        got[f"tp_{name}"] = [np_(a) for a in (out, ref, g, g0)]
        got[f"tp_{name}_q"] = tuple(p_sh["layers"][0]["q"]["w"].shape)
    try:
        pmesh.shard_esm(tiny, pmesh.make_mesh(dp=1, tp=4, device="cpu"),
                        heads=6)
    except ValueError as e:
        got["heads_err"] = str(e)

    # sp over 4 ranks on T = 16 and on T = 14 (padded to 16)
    for T in (16, 14):
        x = onehot(4, T)
        mesh = pmesh.make_mesh(dp=1, sp=4, device="cpu")
        c = pmesh.sp_constraint(mesh)
        ref = esm2.forward_logits(tiny, x, 4)
        got_l = esm2.forward_logits(tiny, x, 4, constrain=c)
        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(esm2.pseudo_log_likelihood(
            tiny, xg, 4, constrain=c).sum(), xg)
        xg = x.clone().requires_grad_(True)
        (g0,) = torch.autograd.grad(
            esm2.pseudo_log_likelihood(tiny, xg, 4).sum(), xg)
        got[f"sp{T}"] = [np_(a) for a in (got_l, ref, g, g0)]

    # apply_mesh(sp=2) on a transformer PoE energy; then a mesh without
    # sp clears the hook
    tr = tiny_expert()
    en, *_ = build(transformer=tr)
    x = mixed_pop(8)
    ref = en.energy_and_grad(en.params, x)
    got["hook_before"] = esm2.SP_CONSTRAIN is None
    _, en_sh, _ = runtime.apply_mesh(en, x, dp=2, sp=2)
    got["hook_set"] = esm2.SP_CONSTRAIN is not None
    got["sp_energy"] = ([np_(a) for a in en_sh.energy_and_grad(en_sh.params,
                                                                x)],
                        [np_(a) for a in ref])
    _, en_tp, _ = runtime.apply_mesh(en, x, dp=1, tp=2, sp=2)
    got["tp_sp_energy"] = [np_(a) for a in en_tp.energy_and_grad(
        en_tp.params, x)]
    runtime.apply_mesh(en, x, dp=4)
    got["hook_cleared"] = esm2.SP_CONSTRAIN is None
    return got


def test_tp_and_sp_esm_match_replicated(tmp_path):
    """Megatron tp (transformer-S at tp = 4; the 650M shapes with remat)
    and sp (T = 16 and a T = 14 that sp pads) against replicated, their
    dE/dx too; apply_mesh(sp=2) and (tp=2, sp=2) on a transformer PoE
    energy, and the hook set and cleared (``test_tp_esm_matches_
    replicated``, ``test_tp_esm_650m_shapes_...``, ``test_sp_constraint_
    matches_replicated``, ``test_apply_mesh_sp_transformer_energy_...``,
    ``test_apply_mesh_without_sp_clears_stale_hook``); transformer-S's tp
    PLL also against the JAX package's on its dp 2 x tp 4 mesh."""
    import jax
    import jax.numpy as jnp

    from ppde_tpu.models import esm2 as jesm2
    from ppde_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    jparams = jesm2.init(jax.random.PRNGKey(0), "transformer-S",
                         dtype=jnp.float32)
    x = np.asarray(jax.nn.one_hot(
        np.random.default_rng(0).integers(0, 33, (4, 24)), 33,
        dtype=jnp.float32))
    jm = jmesh.make_mesh(dp=2, ep=1, tp=4)
    with jm:
        jpll = np.asarray(jax.jit(jesm2.pseudo_log_likelihood)(
            jmesh.shard_esm(jparams, jm), jmesh.shard_chains(x, jm)))
    jax_s = (jax.tree.map(np.asarray, jparams), x)
    for got in spawn(_ranks_esm, 4, tmp_path, jax_s):
        np.testing.assert_allclose(got["tp_transformer-S"][0], jpll,
                                   rtol=2e-5, atol=2e-5)
        for name in ("transformer-S", "transformer-L"):
            out, ref, g, g0 = got[f"tp_{name}"]
            np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(g, g0, rtol=1e-4, atol=1e-5)
        assert got["tp_transformer-S_q"] == (480, 120)
        assert got["tp_transformer-L_q"] == (1280, 320)
        assert "does not divide the 6 attention heads" in got["heads_err"]
        for T in (16, 14):
            logits, ref, g, g0 = got[f"sp{T}"]
            assert logits.shape == (4, T, esm2.ESM_VOCAB)
            np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, g0, rtol=1e-4, atol=1e-5)
        assert got["hook_before"] and got["hook_set"] and got["hook_cleared"]
        (e, f, g), (e0, f0, g0) = got["sp_energy"]
        np.testing.assert_allclose(e, e0, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(f, f0, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g, g0, rtol=2e-4, atol=2e-5)
        e, f, g = got["tp_sp_energy"]
        np.testing.assert_allclose(e, e0, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g, g0, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# the JAX package's draws replayed through the port's sharded run
# ---------------------------------------------------------------------------

class Replay:
    """A ``samplers.base.Draws`` stand-in handing out arrays in order."""

    def __init__(self, arrays):
        self.queue = list(reversed(arrays))

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


def _ranks_replay(rank, ens_np, arrays, steps, log_every):
    from ppde_tpu_torch import convert

    en, pp, ens, pop = build(ens=convert.cnn_ensemble_from_numpy(ens_np,
                                                                 "cpu"))
    mesh, en_sh, pop_sh = runtime.apply_mesh(en, pop, dp=2, tp=2)
    draws = Replay(arrays)
    res = ppde.run(en_sh, pop_sh, num_steps=steps, min_pos=0, max_pos=31,
                   cfg=ppde.PPDEConfig(pas_length=2, nmut_threshold=5),
                   draws=draws, log_every=log_every, quiet=True,
                   device="cpu")
    return {"left": len(draws.queue), **run_fields(res),
            "n_accepted": res.n_accepted}


def jax_draws(key, num_steps, log_every, n, L, V, pas_length):
    """The draws of the JAX package's PPDE run from ``key``, in the order
    the port's step asks for them (``test_torch_port_ppde.JaxDraws``)."""
    import jax

    from ppde_tpu.samplers import base as jbase

    out = []
    for length in jbase.segment_lengths(num_steps, log_every):
        key, seg_key = jax.random.split(key)
        for k in jax.random.split(seg_key, length):
            k_u, k_inner, k_acc = jax.random.split(k, 3)
            out.append(np.asarray(jax.random.randint(k_u, (n,), 1,
                                                     2 * pas_length)))
            for ki in jax.random.split(k_inner, max(2 * pas_length - 1, 1)):
                k1, k2 = jax.random.split(ki)
                out.append(np.asarray(jax.random.gumbel(k1, (n, L))))
                out.append(np.asarray(jax.random.gumbel(k2, (n, V))))
            out.append(np.asarray(jax.random.uniform(k_acc, (n,))))
    return out


def test_replayed_draws_match_jax_apply_mesh(tmp_path):
    """The port's apply_mesh PPDE run at dp = 2 x tp = 2 on JAX's draws
    equals JAX's runtime.apply_mesh run at dp = 4 x tp = 2 on the same
    synthetic inputs: best_x and accepts equal, energies within 2e-5."""
    import jax
    import jax.numpy as jnp

    from ppde_tpu import codec as jcodec, energy as jenergy
    from ppde_tpu import runtime as jruntime
    from ppde_tpu.models import cnn as jcnn, potts as jpotts
    from ppde_tpu.samplers.protein import ppde as jppde

    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    jp = jpotts.synthetic(WT, seed=0)
    je = jcnn.init_ensemble(jax.random.PRNGKey(0), 4, input_size=len(WT))
    wt = jnp.asarray(jcodec.seqs_to_onehot([WT]))
    jen = jenergy.protein_poe(jp, je, 1.0, wt)
    pop = jnp.repeat(wt, 8, axis=0)
    key = jax.random.PRNGKey(7)
    steps, log_every = 12, 6
    mesh, jen_sh, pop_sh = jruntime.apply_mesh(jen, pop, dp=4, tp=2)
    with mesh:
        rj = jppde.run(jen_sh, pop_sh, num_steps=steps, min_pos=0,
                       max_pos=31, cfg=jppde.PPDEConfig(pas_length=2,
                                                        nmut_threshold=5),
                       key=key, log_every=log_every, quiet=True)
    arrays = jax_draws(key, steps, log_every, 8, len(WT), 20, 2)
    ens_np = jax.tree.map(np.asarray, je)
    for got in spawn(_ranks_replay, 4, tmp_path, ens_np, arrays, steps,
                     log_every):
        assert got["left"] == 0
        np.testing.assert_array_equal(got["n_accepted"],
                                      np.asarray(rj.n_accepted))
        assert 0 < got["n_accepted"].sum()
        np.testing.assert_array_equal(got["best_x"], np.asarray(rj.best_x))
        np.testing.assert_allclose(got["best_energy"],
                                   np.asarray(rj.best_energy),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["energy_history"],
                                   np.asarray(rj.energy_history),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

MLM_TINY = dict(layers=2, dim=32, heads=4, ffn=64)


def family(n=16, seed=0, wt="MKTAYIAKQRQISFVKSHFSRQ"):
    """Synthetic family: the wild type plus 1-2 point mutations a row
    (``tests/test_esm_train.py::family``'s recipe)."""
    rng = np.random.default_rng(seed)
    seqs = [wt]
    for _ in range(n - 1):
        s = list(wt)
        for _ in range(rng.integers(1, 3)):
            s[rng.integers(len(wt))] = WT[rng.integers(20)]
        seqs.append("".join(s))
    return seqs


def train_leaves(mesh=None, **kw):
    from ppde_tpu_torch import training

    esm2.CONFIGS["mlm-tiny"] = dict(MLM_TINY)
    try:
        p = training.train_esm_mlm(
            family(), name="mlm-tiny", n_iters=6, batch_size=8, lr=1e-3,
            warmup=2, seed=3, quiet=True, compute_dtype=torch.float32,
            device="cpu", mesh=mesh, **kw)
    finally:
        del esm2.CONFIGS["mlm-tiny"]
    return [np_(a) for a in esm2._flatten(p)]


def _ranks_train(rank):
    mesh = pmesh.make_mesh(dp=4, device="cpu")
    return {lora: train_leaves(mesh, lora_rank=lora) for lora in (0, 2)}


def test_train_esm_mlm_dp4_matches_single_device(tmp_path):
    """train_esm_mlm over dp = 4 (the batch's rows split, the loss's
    normalisation over the whole batch, the gradients summed before the
    clip) equals the single-device run, LoRA rank 0 and 2 (rtol 2e-4, atol
    1e-5, as ``tests/test_esm_train.py::test_dp_mesh_training_matches_
    single_device``)."""
    single = {lora: train_leaves(lora_rank=lora) for lora in (0, 2)}
    for got in spawn(_ranks_train, 4, tmp_path):
        for lora in (0, 2):
            assert len(got[lora]) == len(single[lora])
            for a, b in zip(got[lora], single[lora]):
                np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


def ranks_finetune(rank, argv):
    """``finetune_esm.main`` on this rank (the tiny config registered)."""
    from ppde_tpu_torch.scripts import finetune_esm

    esm2.CONFIGS["mlm-tiny"] = dict(MLM_TINY)
    try:
        p = finetune_esm.main(finetune_esm.build_parser().parse_args(argv))
    finally:
        del esm2.CONFIGS["mlm-tiny"]
    return [np_(a) for a in esm2._flatten(p)]
