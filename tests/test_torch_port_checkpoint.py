"""ppde_tpu_torch's checkpoint/resume (checkpoint.py, samplers/base.py's
checkpoint_dir, the CMA-ES host state) and profiling.py, mirroring
tests/test_checkpoint.py.

Resume is held bit for bit inside the port: a run cut at a segment boundary
and resumed equals the uncut run (tokens or images, histories, bests, final
population, oracle history), for every protein and MNIST sampler, at tiny
sizes on the CPU. Against the JAX package: the leaf paths equal
``jax.tree_util.keystr``'s, ``validate_records`` raises where the JAX
package's does, and a checkpoint the JAX package wrote is refused by name.
"""
import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import checkpoint as jckpt
from ppde_tpu_torch import checkpoint as ckpt
from ppde_tpu_torch import codec, energy, profiling
from ppde_tpu_torch.models import cnn, mnist_nets, potts
from ppde_tpu_torch.samplers import base
from ppde_tpu_torch.samplers.mnist import cmaes as mcmaes
from ppde_tpu_torch.samplers.mnist import mala_approx as mmala
from ppde_tpu_torch.samplers.mnist import ppde as mppde
from ppde_tpu_torch.samplers.mnist import pt as mpt, sa as msa
from ppde_tpu_torch.samplers.protein import (cmaes, mala_approx, ppde, pt,
                                             random_search, sa)

torch.set_num_threads(1)
WT = "ACDEFGHIKLMNPQRSTVWY"
RESULT_FIELDS = ("best_x", "best_energy", "best_fitness", "final_x",
                 "energy_history", "fitness_history", "oracle_history",
                 "random_traj", "n_accepted")


def _protein():
    """A Potts + CNN product of experts (L = 20), its oracle and a
    wild-type population of 8 chains, on the CPU."""
    pp = potts.synthetic(WT, min_pos=2, max_pos=17, seed=0, device="cpu")
    ens = cnn.init_ensemble(torch.Generator().manual_seed(0), 3,
                            input_size=len(WT))
    wt = torch.from_numpy(codec.seqs_to_onehot([WT]))
    en = energy.protein_poe(pp, ens, 1.0, wt)
    oracle = (pp, lambda p, x: potts.score(p, x, delta=True))
    return en, oracle, wt.repeat(8, 1, 1)


def _mnist():
    """The JAX MNIST sampler tests' tiny config (nc = 4, 4 channels), and
    8 chains with one shared x1 (PT needs each replica column's x1 the same
    across levels)."""
    g = torch.Generator().manual_seed(0)
    ens = mnist_nets.regression_init_ensemble(g, 2, nc=4)
    ebm = mnist_nets.ebm_init(g, n_channels=4,
                              mean=0.3 * np.ones(784, np.float32))
    en = energy.mnist_poe(ebm, ens, lam=1.0, unsup_kind="ebm")
    orc = (mnist_nets.regression_init(g, nc=4),
           lambda p, x2, x1: mnist_nets.regression_apply(p, x1, x2))
    rng = np.random.default_rng(0)
    x1 = np.repeat((rng.random((1, 784)) > 0.7).astype(np.float32), 8, 0)
    x2 = (rng.random((8, 784)) > 0.7).astype(np.float32)
    return en, orc, np.concatenate([x1, x2], 1)


def _assert_same(a, b):
    for k in RESULT_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert np.shape(x) == np.shape(y), k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _cut_and_resume(run, tmp_path, cut=4, total=8):
    """run(n_steps, checkpoint_dir) -> SamplerResult; cut at ``cut`` and
    resumed to ``total`` must equal an uncut ``total``-step run."""
    ref = run(total, None)
    ck = str(tmp_path / "ck")
    partial = run(cut, ck)
    assert ckpt.exists(ck) or os.path.exists(os.path.join(ck,
                                                           "cmaes_state.npz"))
    resumed = run(total, ck)
    _assert_same(resumed, ref)
    return partial, resumed


def _gen():
    return torch.Generator().manual_seed(11)


PROTEIN_RUNS = {
    "PPDE": lambda en, o, pop, n, ck: ppde.run(
        en, pop, n, 2, 17, oracle=o, cfg=ppde.PPDEConfig(pas_length=2,
                                                         nmut_threshold=3),
        generator=_gen(), log_every=2, quiet=True, device="cpu",
        checkpoint_dir=ck),
    "PPDE-PT": lambda en, o, pop, n, ck: pt.run(
        en, pop, n, 2, 17, oracle=o,
        cfg=pt.PTConfig(n_levels=4, swap_every=1), generator=_gen(),
        log_every=2, quiet=True, device="cpu", checkpoint_dir=ck),
    "SA": lambda en, o, pop, n, ck: sa.run(
        en, pop, n, 2, 17, oracle=o, cfg=sa.SAConfig(nmut_threshold=4),
        generator=_gen(), log_every=2, quiet=True, device="cpu",
        checkpoint_dir=ck),
    "Random": lambda en, o, pop, n, ck: random_search.run(
        en, pop, n, 2, 17, oracle=o, generator=_gen(), log_every=2,
        quiet=True, device="cpu", checkpoint_dir=ck),
    "MALA-approx": lambda en, o, pop, n, ck: mala_approx.run(
        en, pop, n, 2, 17, oracle=o, generator=_gen(), log_every=2,
        quiet=True, device="cpu", checkpoint_dir=ck),
    "CMAES": lambda en, o, pop, n, ck: cmaes.run(
        en, pop, n, 2, 17, oracle=o,
        cfg=cmaes.CMAESConfig(population_size=8), log_every=2, quiet=True,
        seed=5, device="cpu", checkpoint_dir=ck),
}


@pytest.mark.parametrize("sampler", sorted(PROTEIN_RUNS))
def test_protein_resume_is_bit_exact(tmp_path, sampler):
    """Cut after 4 of 8 steps (generations) and resumed: the uncut run bit
    for bit; the first half ran 4 steps, the resumed run the other 4."""
    en, oracle, pop = _protein()
    partial, resumed = _cut_and_resume(
        lambda n, ck: PROTEIN_RUNS[sampler](en, oracle, pop, n, ck),
        tmp_path)
    if sampler != "CMAES":
        assert partial.energy_history.shape == (5, 8)
        assert resumed.energy_history.shape == (9, 8)
        assert resumed.oracle_history.shape == (5, 8)


MNIST_RUNS = {
    "PPDE-PAS": lambda en, o, pop, n, ck: mppde.run(
        en, pop, n, oracle=o, cfg=mppde.MNISTPPDEConfig(pas_length=3),
        generator=_gen(), log_every=2, quiet=True, device="cpu",
        checkpoint_dir=ck),
    "PPDE-GWG": lambda en, o, pop, n, ck: mppde.run(
        en, pop, n, oracle=o,
        cfg=mppde.MNISTPPDEConfig(pas_length=0, gwg_samples=3),
        generator=_gen(), log_every=2, quiet=True, device="cpu",
        checkpoint_dir=ck),
    "PPDE-PT": lambda en, o, pop, n, ck: mpt.run(
        en, pop, n, oracle=o,
        cfg=mpt.MNISTPTConfig(pas_length=2, n_levels=2), generator=_gen(),
        log_every=2, quiet=True, device="cpu", checkpoint_dir=ck),
    "SA": lambda en, o, pop, n, ck: msa.run(
        en, pop, n, oracle=o, generator=_gen(), log_every=2, quiet=True,
        device="cpu", checkpoint_dir=ck),
    "MALA-approx": lambda en, o, pop, n, ck: mmala.run(
        en, pop, n, oracle=o, cfg=mmala.MNISTMALAConfig(step_size=0.1),
        generator=_gen(), log_every=2, quiet=True, device="cpu",
        checkpoint_dir=ck),
    "CMAES": lambda en, o, pop, n, ck: mcmaes.run(
        en, pop, n, oracle=o, cfg=mcmaes.MNISTCMAESConfig(population_size=4),
        log_every=2, quiet=True, seed=5, device="cpu", checkpoint_dir=ck),
}


@pytest.mark.parametrize("sampler", sorted(MNIST_RUNS))
def test_mnist_resume_is_bit_exact(tmp_path, sampler):
    en, oracle, pop = _mnist()
    _cut_and_resume(
        lambda n, ck: MNIST_RUNS[sampler](en, oracle, pop, n, ck), tmp_path)


def test_resume_prints_and_skips_the_step0_oracle(tmp_path, capsys):
    """The resumed process prints [resume] and evaluates no oracle at step
    0: the oracle history of steps 0-4 comes from the checkpoint."""
    en, oracle, pop = _protein()
    calls = []

    def counting(p, x):
        calls.append(x.shape[0])
        return oracle[1](p, x)

    def run(n, ck):
        return ppde.run(en, pop, n, 2, 17, oracle=(oracle[0], counting),
                        generator=_gen(), log_every=2, quiet=False,
                        device="cpu", checkpoint_dir=ck)
    ck = str(tmp_path / "ck")
    run(4, ck)
    assert len(calls) == 3            # step 0 and two segment boundaries
    capsys.readouterr()
    res = run(8, ck)
    out = capsys.readouterr().out
    assert f"[resume] restored checkpoint at step 4 from {ck}" in out
    assert len(calls) == 5            # only the two new boundaries
    assert res.oracle_history.shape == (5, 8)
    assert res.wall_steps_per_sec > 0


def test_checkpoint_roundtrip_structures(tmp_path):
    state = {"a": torch.arange(4.0), "b": (torch.zeros((2, 2)),
                                           torch.ones(3))}
    gen = torch.Generator().manual_seed(5)
    ckpt.save(str(tmp_path), state, gen.get_state(), 17,
              {"energy": np.ones((3, 2)), "oracle": np.zeros((1, 2))})
    assert ckpt.exists(str(tmp_path))
    s2, g2, done, rec = ckpt.load(str(tmp_path), state)
    assert done == 17
    assert torch.equal(g2, gen.get_state())
    assert torch.equal(s2["a"], torch.arange(4.0))
    assert isinstance(s2["b"], tuple) and torch.equal(s2["b"][1],
                                                      torch.ones(3))
    np.testing.assert_array_equal(rec["energy"], np.ones((3, 2)))


@dataclasses.dataclass(frozen=True)
class _Carry:
    x: torch.Tensor
    count: int


def test_host_int_and_bf16_leaves_roundtrip(tmp_path):
    """A host step counter comes back an int (SA's step_i, PT's count), a
    float a float, a bf16 tensor bit for bit as bf16, a dataclass as
    itself; a leaf of another type does not save."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    state = (_Carry(x.bfloat16(), 7), 0.25, [x, None, 3])
    ckpt.save(str(tmp_path), state, torch.Generator().get_state(), 2, None)
    like = (_Carry(torch.zeros(3, 5, dtype=torch.bfloat16), 0), 0.0,
            [torch.zeros(3, 5), None, 0])
    (c, f, (t, none, i)), _, _, rec = ckpt.load(str(tmp_path), like)
    assert rec == {}
    assert isinstance(c, _Carry) and c.count == 7 and type(c.count) is int
    assert c.x.dtype == torch.bfloat16
    assert torch.equal(c.x.view(torch.int16), x.bfloat16().view(torch.int16))
    assert f == 0.25 and type(f) is float
    assert none is None and i == 3 and type(i) is int
    assert torch.equal(t, x)
    with pytest.raises(ValueError, match=r"\[2\].*dtype int != configured "
                                         r"float32"):
        ckpt.load(str(tmp_path), (like[0], like[1], [like[2][0], None,
                                                     torch.zeros(())]))
    with pytest.raises(TypeError, match="str"):
        ckpt.save(str(tmp_path), {"a": "text"}, torch.Generator().get_state(),
                  1, None)


def test_leaf_paths_match_jax_keystr():
    tree = {"z": [1.0, (2.0, {"b": 3.0, "a": 4.0})], "a": (5.0,), "m": 6.0}
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in ckpt.flatten_with_paths(tree)] == jpaths
    assert [v for _, v in ckpt.flatten_with_paths(tree)] == \
        jax.tree.leaves(tree)


def test_load_rejects_config_mismatch(tmp_path):
    """A changed run config with the SAME leaf count fails at load time
    with an error naming the offending leaf."""
    state = {"a": torch.arange(4.0), "b": torch.zeros((2, 3))}
    ckpt.save(str(tmp_path), state, torch.Generator().get_state(), 5, None)
    with pytest.raises(ValueError, match=r"\['b'\].*shape"):
        ckpt.load(str(tmp_path), {"a": torch.arange(4.0),
                                  "b": torch.zeros((3, 3))})
    with pytest.raises(ValueError, match=r"\['a'\].*dtype"):
        ckpt.load(str(tmp_path), {"a": torch.arange(4),
                                  "b": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load(str(tmp_path), {"a": torch.arange(4.0)})
    s2, _, done, _ = ckpt.load(str(tmp_path), state)
    assert done == 5
    assert torch.equal(s2["b"], torch.zeros((2, 3)))


def test_jax_written_checkpoint_is_refused(tmp_path):
    """Checkpoints are not read across packages: a state.npz with a JAX
    PRNG key and no generator state is refused by name, directly and
    through run_segmented."""
    jckpt.save(str(tmp_path), {"a": jnp.arange(4.0)},
               jax.random.PRNGKey(0), 5, None)
    with pytest.raises(ValueError, match="JAX PRNG key.*JAX package"):
        ckpt.load(str(tmp_path), {"a": torch.arange(4.0)})
    with pytest.raises(ValueError, match="not read across packages"):
        base.run_segmented(
            step_fn=lambda c, s, d: (s, {"energy": s}), ctx={},
            init_state=torch.zeros(4),
            draws=base.Draws(torch.Generator()), num_steps=4, log_every=2,
            quiet=True, checkpoint_dir=str(tmp_path))


def test_draws_without_state_cannot_be_checkpointed(tmp_path):
    class Replay:
        pass

    with pytest.raises(TypeError, match="Replay.*cannot be checkpointed"):
        base.run_segmented(
            step_fn=lambda c, s, d: (s, {"energy": s}), ctx={},
            init_state=torch.zeros(4), draws=Replay(), num_steps=4,
            log_every=2, quiet=True, checkpoint_dir=str(tmp_path))


def test_records_scalars_roundtrip_and_object_rejected(tmp_path):
    state = {"a": torch.arange(3.0)}
    g = torch.Generator().get_state()
    ckpt.save(str(tmp_path), state, g, 7,
              {"energy": np.ones((4, 2)), "steps_per_sec": 123.4,
               "n_levels": 8})
    _, _, _, rec = ckpt.load(str(tmp_path), state)
    assert rec["steps_per_sec"] == 123.4 and isinstance(
        rec["steps_per_sec"], float)
    assert rec["n_levels"] == 8
    np.testing.assert_array_equal(rec["energy"], np.ones((4, 2)))
    with pytest.raises(TypeError, match="'bad_key'"):
        ckpt.save(str(tmp_path), state, g, 7, {"bad_key": object()})


@pytest.mark.parametrize("fresh,match", [
    ({"energy": np.ones((5, 4))}, r"\['traj'\].*no longer produces"),
    ({"energy": np.ones((5, 4)), "traj": np.zeros((5, 7), np.int8),
      "extra": np.ones((5, 2))}, r"\['extra'\].*absent"),
    ({"energy": np.ones((5, 8)), "traj": np.zeros((5, 7), np.int8)},
     "'energy'.*per-step shape"),
])
def test_records_validation_names_offending_key(fresh, match):
    """The same inputs raise in both packages, naming the same key."""
    prior = {"energy": np.ones((10, 4)), "traj": np.zeros((10, 7), np.int8),
             "steps_per_sec": 5.0}
    ok = {"energy": np.ones((5, 4)), "traj": np.zeros((5, 7), np.int8)}
    ckpt.validate_records(prior, ok)
    jckpt.validate_records(prior, ok)
    for module in (ckpt, jckpt):
        with pytest.raises(ValueError, match=match):
            module.validate_records(prior, fresh)


def test_load_rejects_corrupt_records_file(tmp_path):
    state = {"a": torch.arange(3.0)}
    ckpt.save(str(tmp_path), state, torch.Generator().get_state(), 7,
              {"energy": np.ones((4, 2))})
    with open(tmp_path / "records.npz", "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(ValueError, match="records.*unreadable"):
        ckpt.load(str(tmp_path), state)


def test_load_rejects_corrupt_records_member(tmp_path):
    """A zip with an intact directory but a garbled member fails at
    extraction; that still surfaces as the 'unreadable' ValueError."""
    state = {"a": torch.arange(3.0)}
    ckpt.save(str(tmp_path), state, torch.Generator().get_state(), 7,
              {"energy": np.ones((4, 2))})
    with zipfile.ZipFile(tmp_path / "records.npz", "w") as z:
        z.writestr("energy.npy", b"garbage, not an npy stream")
    with pytest.raises(ValueError, match="records.*unreadable"):
        ckpt.load(str(tmp_path), state)


def _counter_run(width, n, ckpt_dir):
    def step(ctx, s, draws):
        s = s + ctx["inc"]
        return s, {"energy": s[:width], "fitness": s[:width] * 2}
    return base.run_segmented(
        step_fn=step, ctx={"inc": torch.ones(8)}, init_state=torch.zeros(8),
        draws=base.Draws(torch.Generator()), num_steps=n, log_every=10,
        oracle_fn=lambda c, s: s + 100.0, quiet=True,
        checkpoint_dir=ckpt_dir)


def test_resume_with_changed_record_shape_fails_named(tmp_path):
    """A run resumed with a different chain count fails with the named-key
    record error, not an opaque concat error."""
    ck = str(tmp_path / "ck")
    _counter_run(8, 20, ck)
    with pytest.raises(ValueError, match="'energy'.*per-step shape"):
        _counter_run(4, 40, ck)


def test_segmented_runner_records_shapes(tmp_path):
    """Records concatenate across segments, the oracle at boundaries,
    steps_per_sec present; with checkpoint_every 2 the state is saved at
    every second segment."""
    state, rec = _counter_run(4, 25, None)
    assert rec["energy"].shape == (25, 4)
    assert rec["oracle"].shape == (4, 8)  # initial + 3 segment boundaries
    assert rec["steps_per_sec"] > 0
    np.testing.assert_allclose(state.numpy(), 25.0)
    np.testing.assert_allclose(rec["oracle"][-1], 125.0)
    ck = str(tmp_path / "ck")
    base.run_segmented(
        step_fn=lambda c, s, d: (s + 1, {"energy": s}), ctx={},
        init_state=torch.zeros(2), draws=base.Draws(torch.Generator()),
        num_steps=30, log_every=10, quiet=True, checkpoint_dir=ck,
        checkpoint_every=2)
    assert ckpt.load(ck, torch.zeros(2))[2] == 20


def test_cmaes_state_roundtrip_matches_jax():
    """get_state / set_state carry the whole ES, its numpy generator too:
    the restored ES asks what the original asks next, and the JAX
    package's ES restored from the same state asks the same."""
    from ppde_tpu.samplers import cma_core as jcma
    from ppde_tpu_torch.samplers import cma_core

    for diag in (False, True):
        a = cma_core.CMAES(np.zeros(6), 0.3, popsize=5, seed=1, diag=diag)
        for _ in range(3):
            X = a.ask()
            a.tell(X, (X ** 2).sum(1))
        st = a.get_state()
        b = cma_core.CMAES(np.zeros(6), 0.3, popsize=5, seed=9, diag=diag)
        b.set_state(st)
        j = jcma.CMAES(np.zeros(6), 0.3, popsize=5, seed=9, diag=diag)
        j.set_state(st)
        want = a.ask()
        np.testing.assert_array_equal(b.ask(), want)
        np.testing.assert_array_equal(j.ask(), want)
        with pytest.raises(ValueError, match="covariance model"):
            cma_core.CMAES(np.zeros(6), 0.3, popsize=5,
                           diag=not diag).set_state(st)


def test_segment_timer_and_trace_on_cpu(tmp_path):
    """``profiling.trace`` writes a Chrome trace holding the spans opened
    inside it (``SegmentTimer`` and ``annotate`` are gone: ``span`` took
    their place); outside a profiler a span is the shared no-op."""
    assert profiling.span("my_region") is profiling.span("other")
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("my_region"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"]
             if e.get("name") == "my_region" and e.get("ph") == "X"]
    assert len(spans) == 1 and spans[0]["cat"] == "user_annotation"
    assert not hasattr(profiling, "SegmentTimer")
    assert not hasattr(profiling, "annotate")
