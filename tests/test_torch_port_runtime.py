"""ppde_tpu_torch's run assembly against ppde_tpu's: io.read_fasta, the
reference .pt / .pkl loaders, potts.load_pickle, the oracle, metrics and
runtime (build_protein_energy, resolve_esm_chunk, cell_summary).

Both packages read the same protein directory, written to ``tmp_path`` from
seeds (``scripts/seeded_protein.py``: wt.fasta, three OnehotCNN state dicts,
20 oracle pickles). Tolerances: file contents equal; Potts parameters from a
pickle at 1e-6; the oracle at rtol / atol 1e-5; float32 energies at rtol
1e-5 / atol 1e-4 and gradients at atol 1e-5 (sums in another order than
XLA's); bf16 within the JAX package's own bf16 bound (fitness rtol / atol
3e-2, gradient cosine > 0.99)."""
import os
import pickle
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import io as jio, metrics as jmetrics, runtime as jruntime
from ppde_tpu.models import esm2 as jesm2, oracle as joracle, potts as jpotts
from ppde_tpu.models import torch_convert as jtc
from ppde_tpu_torch import codec, convert, io, metrics, runtime
from ppde_tpu_torch.models import esm2, oracle, potts, torch_convert
from ppde_tpu_torch.scripts import seeded_protein

torch.set_num_threads(1)
WT = "MKTAYIAKQRQISFVKSHFS"  # 20 residues
PROTEIN = "TOY_PROTEIN"
E_TOL = dict(rtol=1e-5, atol=1e-4)
G_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def protein_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("weights"))
    seeded_protein.write_protein_dir(root, PROTEIN, WT, seed=3)
    return root


def _args(root, **kw):
    base = dict(protein_weights=root, protein=PROTEIN,
                energy_function="product_of_experts",
                unsupervised_expert="potts", energy_lamda=2.0, n_chains=4,
                compute_dtype="f32", potts_npz=None, cnn_chunk=0,
                pool_bwd="split", esm_chunk=0, fused_cnn=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    return codec.ints_to_onehot(rng.integers(0, 20, (n, len(WT))))


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def test_read_fasta_matches_jax(tmp_path):
    path = str(tmp_path / "two.fasta")
    with open(path, "w") as f:
        f.write(">first/3-22 some text\nMKTAY\nIAKQR\n\n>second\nACDE\n")
    assert io.read_fasta(path) == jio.read_fasta(path) == ["MKTAYIAKQR",
                                                           "ACDE"]
    assert (io.read_fasta(path, return_ids=True)
            == jio.read_fasta(path, return_ids=True))


def test_reference_loaders_match_jax(protein_root):
    """The .pt checkpoints and the oracle pickles load to the same arrays
    in both packages; the state dicts are in the reference layout."""
    d = os.path.join(protein_root, PROTEIN)
    paths = [os.path.join(d, f"onehot_cnn_seed={i}.pt") for i in range(3)]
    sd = torch.load(paths[0], weights_only=True)
    C = len(WT)
    assert sd["encoder.weight"].shape == (C, 20, 5)
    assert sd["embedding.0.weight"].shape == (2 * C, C)
    assert sd["decoder.weight"].shape == (1, 2 * C)
    _tree_equal(torch_convert.onehot_cnn_ensemble(paths),
                jtc.onehot_cnn_ensemble(paths))
    heads = oracle.head_paths(d)
    _tree_equal(torch_convert.linear_oracle(heads), jtc.linear_oracle(heads))
    assert torch_convert.linear_oracle(heads)["coef"].shape == (20, 1 + C * 20)


def test_cnn_writer_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    member = {"encoder": {"w": rng.normal(size=(5, 20, 7)).astype(np.float32),
                          "b": rng.normal(size=7).astype(np.float32)},
              "embed": {"w": rng.normal(size=(7, 14)).astype(np.float32),
                        "b": rng.normal(size=14).astype(np.float32)},
              "decoder": {"w": rng.normal(size=(14, 1)).astype(np.float32),
                          "b": rng.normal(size=1).astype(np.float32)}}
    path = str(tmp_path / "m.pt")
    torch_convert.save_onehot_cnn(path, member)
    _tree_equal(torch_convert.onehot_cnn(path), member)
    _tree_equal(jtc.onehot_cnn(path), member)


def _write_potts_pkl(d, L_win, offset, seed=0):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 0.05, (L_win, L_win, 20, 20)).astype(np.float32)
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    J[np.arange(L_win), np.arange(L_win)] = 0.0
    h = rng.normal(0, 0.5, (L_win, 20)).astype(np.float32)
    with open(os.path.join(d, "potts.pkl"), "wb") as f:
        pickle.dump({"J_ij": J, "h_i": h, "reg_coef": 0.7,
                     "index_list": np.arange(L_win) + offset + 2}, f)


def test_load_pickle_matches_jax(tmp_path):
    """potts.pkl with a '>NAME/START-END' FASTA id: the window comes from
    index_list minus START; W, h and the wild type's H agree to 1e-6."""
    d = str(tmp_path)
    with open(os.path.join(d, "wt.fasta"), "w") as f:
        f.write(f">TOY/5-24\n{WT}\n")
    _write_potts_pkl(d, 15, offset=5)
    tp = potts.load_pickle(d, device="cpu")
    jp = jpotts.load_pickle(d)
    assert (tp.seq_len, tp.min_pos, tp.max_pos) == (jp.seq_len, 2, 16)
    assert (jp.min_pos, jp.max_pos) == (2, 16)
    assert tp.reg_coef == pytest.approx(jp.reg_coef)
    np.testing.assert_allclose(tp.W.numpy(), np.asarray(jp.W), atol=1e-6)
    np.testing.assert_allclose(tp.h.numpy(), np.asarray(jp.h), atol=1e-6)
    np.testing.assert_allclose(float(tp.wt_H), float(jp.wt_H), rtol=1e-6,
                               atol=1e-6)
    # load_potts prefers the pickle, and records its provenance
    assert runtime.potts_provenance(d) == jruntime.potts_provenance(d) \
        == "reference-pkl"
    np.testing.assert_array_equal(
        runtime.load_potts(d, device="cpu").W.numpy(), tp.W.numpy())


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def _potts_pair(wt, seed=0, min_pos=0, max_pos=None):
    return (potts.synthetic(wt, min_pos=min_pos, max_pos=max_pos, seed=seed,
                            device="cpu"),
            jpotts.synthetic(wt, min_pos=min_pos, max_pos=max_pos, seed=seed))


def test_oracle_synthetic_and_apply_match_jax():
    tp, jp = _potts_pair(WT, min_pos=2, max_pos=17)
    to = oracle.synthetic(tp, len(WT), seed=4, device="cpu")
    jo = joracle.synthetic(jp, len(WT), seed=4)
    for name in ("coef", "intercept", "inv_sqrt_reg"):
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)))
    x = _x(6)
    np.testing.assert_allclose(
        oracle.apply(to, torch.from_numpy(x)).numpy(),
        np.asarray(joracle.apply(jo, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # the JAX package's arrays carried across give the same values
    co = convert.oracle_from_numpy(
        *(np.asarray(getattr(jo, k)) for k in ("coef", "intercept",
                                               "inv_sqrt_reg")), tp, "cpu")
    np.testing.assert_array_equal(oracle.apply(co, torch.from_numpy(x)),
                                  oracle.apply(to, torch.from_numpy(x)))


def test_oracle_load_matches_jax(protein_root):
    d = os.path.join(protein_root, PROTEIN)
    tp, jp = _potts_pair(WT)
    to = oracle.load(d, potts_params=tp, device="cpu")
    jo = joracle.load(d, potts_params=jp)
    for name in ("coef", "intercept", "inv_sqrt_reg"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)), rtol=1e-7)
    x = _x(5, seed=2)
    np.testing.assert_allclose(
        oracle.apply(to, torch.from_numpy(x)).numpy(),
        np.asarray(joracle.apply(jo, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def _jax_energy(root, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jruntime.build_protein_energy(_args(root, **kw))


def _port_energy(root, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return runtime.build_protein_energy(_args(root, **kw), "cpu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(energy_function="supervised"),
    dict(pool_bwd="first", energy_lamda=0.5),
])
def test_build_protein_energy_f32_matches_jax(protein_root, kw):
    """The same directory builds the same energy in both packages (the
    synthetic Potts fallback, the loaded ensemble, the oracle)."""
    jen, jorc, jpp, _ = _jax_energy(protein_root, **kw)
    ten, torc, tpp, _ = _port_energy(protein_root, **kw)
    assert (tpp.min_pos, tpp.max_pos) == (jpp.min_pos, jpp.max_pos)
    x = _x(4, seed=5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    e, fit = ten.energy(ten.params, xt)
    ej, fj = jen.energy(jen.params, xj)
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **E_TOL)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), **E_TOL)
    e, fit, g = ten.energy_and_grad(ten.params, xt)
    ej, fj, gj = jen.energy_and_grad(jen.params, xj)
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **E_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **G_TOL)
    np.testing.assert_allclose(torc[1](torc[0], xt).numpy(),
                               np.asarray(jorc[1](jorc[0], xj)),
                               rtol=1e-5, atol=1e-5)


def test_build_protein_energy_bf16_close_to_jax(protein_root):
    jen, _, _, _ = _jax_energy(protein_root, compute_dtype="bf16")
    ten, _, _, _ = _port_energy(protein_root, compute_dtype="bf16")
    x = _x(8, seed=6)
    e, fit, g = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), rtol=3e-2,
                               atol=3e-2)
    # energy = Potts (float32 in both) + lam * fitness
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=3e-2,
                               atol=2 * 3e-2)
    a, b = g.numpy().ravel(), np.asarray(gj).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


def test_build_protein_energy_potts_npz_and_transformer(protein_root,
                                                        tmp_path,
                                                        monkeypatch):
    """--potts_npz (the JAX package's save_npz layout) overrides the
    directory's Potts for the energy and the oracle; a transformer expert
    composes through esm2.load_expert from an npz checkpoint."""
    L_win = 14
    rng = np.random.default_rng(7)
    J = rng.normal(0, 0.05, (L_win, L_win, 20, 20)).astype(np.float32)
    J = 0.5 * (J + J.transpose(1, 0, 3, 2))
    npz = str(tmp_path / "fit.npz")
    jpotts.save_npz(npz, J, rng.normal(0, 0.5, (L_win, 20)),
                    np.arange(L_win) + 4, 0.8, 1)
    tiny = dict(layers=2, dim=32, heads=4, ffn=64)
    monkeypatch.setitem(jesm2.CONFIGS, "transformer-tiny", tiny)
    monkeypatch.setitem(esm2.CONFIGS, "transformer-tiny", tiny)
    ck = str(tmp_path / "tiny.npz")
    jesm2.save_npz_checkpoint(ck, jesm2.init(
        jax.random.PRNGKey(1), "transformer-tiny", dtype=jnp.float32,
        scale=0.1))
    kw = dict(potts_npz=npz, unsupervised_expert="potts+transformer-tiny",
              esm_weights=ck)
    # the JAX default expert type is bf16: load both in float32 to compare
    monkeypatch.setattr(esm2, "load_expert", _f32(esm2.load_expert))
    monkeypatch.setattr(jesm2, "load_expert", _f32(jesm2.load_expert))
    jen, jorc, jpp, _ = _jax_energy(protein_root, **kw)
    ten, torc, tpp, _ = _port_energy(protein_root, **kw)
    assert (tpp.min_pos, tpp.max_pos) == (jpp.min_pos, jpp.max_pos) == (3, 16)
    assert "tr" in ten.params and "potts" in ten.params
    x = _x(4, seed=8)
    e, _, g = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    ej, _, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=5e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-4)
    np.testing.assert_allclose(torc[1](torc[0], torch.from_numpy(x)).numpy(),
                               np.asarray(jorc[1](jorc[0], jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def _f32(load_expert):
    def load(name, wt_seq, **kw):
        dtype = torch.float32 if "device" in kw else jnp.float32
        return load_expert(name, wt_seq, dtype=dtype, **kw)
    return load


def test_load_potts_fallback_warns_and_cuda_refused(protein_root):
    d = os.path.join(protein_root, PROTEIN)
    with pytest.warns(UserWarning, match="synthetic"):
        tp = runtime.load_potts(d, device="cpu")
    _, jp = _potts_pair(WT)
    np.testing.assert_array_equal(tp.W.numpy(), np.asarray(jp.W))
    assert runtime.potts_provenance(d) == jruntime.potts_provenance(d) \
        == "synthetic"
    with pytest.raises(FileNotFoundError):
        runtime.load_potts(d, allow_synthetic=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            runtime.build_protein_energy(_args(protein_root))


def test_initial_population_matches_jax(protein_root):
    d = os.path.join(protein_root, PROTEIN)
    np.testing.assert_array_equal(
        runtime.make_initial_protein_population(d, 3, "cpu").numpy(),
        np.asarray(jruntime.make_initial_protein_population(d, 3)))


@pytest.mark.parametrize("esm_chunk", [-1, 0, 8])
@pytest.mark.parametrize("has_tr", [False, True])
@pytest.mark.parametrize("n", [8, 128])
def test_resolve_esm_chunk_matches_jax(esm_chunk, has_tr, n):
    """-1 and explicit chunks as in the JAX package; auto (0) from the
    card's memory (the port's rule, ROADMAP Queue 3): one piece where the
    one-piece gradient's predicted peak fits, on an 80 GB card, at GFP's
    length, for transformer-S; one piece with no card (the CPU) and
    without a transformer."""
    if esm_chunk:
        assert (runtime.resolve_esm_chunk(esm_chunk, has_tr, n)
                == jruntime.resolve_esm_chunk(esm_chunk, has_tr, n))
        return
    h100 = 80 * 2**30
    assert runtime.resolve_esm_chunk(0, has_tr, n, "transformer-S", 237,
                                     h100) is None
    assert runtime.resolve_esm_chunk(0, has_tr, n, "transformer-S", 237,
                                     None) is None


@pytest.mark.parametrize("name", ["transformer-S", "transformer-M",
                                  "transformer-L", "transformer"])
def test_auto_esm_chunk_is_the_largest_that_fits(name):
    """Auto (0) chunks only past the card's memory, and then takes the
    largest chunk whose predicted peak fits in ESM_MEMORY_SHARE of it."""
    base, per = runtime.ESM_GRAD_MEMORY[name]
    assert base > 0 and per > 0
    T, card = 237, 80 * 2**30
    budget = runtime.ESM_MEMORY_SHARE * card
    fits = int((budget - base) // (per * T))
    assert runtime.resolve_esm_chunk(0, True, fits, name, T, card) is None
    c = runtime.resolve_esm_chunk(0, True, fits + 1, name, T, card)
    assert c == fits
    assert base + per * T * c <= budget < base + per * T * (c + 1)
    small = base + per * T * 24 + 1     # a card that holds 24 chains
    assert runtime.resolve_esm_chunk(0, True, 128, name, T,
                                     small / runtime.ESM_MEMORY_SHARE) == 24


def test_metrics_and_cell_summary_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    wt = codec.seqs_to_onehot([WT])
    pop = np.repeat(wt, 10, 0)
    for i in range(1, 10):
        for p in rng.choice(len(WT), size=i % 4, replace=False):
            pop[i, p] = np.eye(20)[(pop[i, p].argmax() + 1 + i) % 20]
    pop[9] = pop[8]
    assert metrics.diversity_pct(pop) == jmetrics.diversity_pct(pop)
    assert metrics.exploration(pop, wt) == pytest.approx(
        jmetrics.exploration(pop, wt), rel=1e-12)
    args = types.SimpleNamespace(
        protein=PROTEIN, sampler="PPDE", seed=1, n_iters=10, n_chains=10,
        energy_function="product_of_experts", unsupervised_expert="potts",
        energy_lamda=5.0, nmut_threshold=4, ppde_reference_reverse=False,
        run_signature="sig", summary_json="",
        msa_transformer_model="msa-S", msa_transformer_weights="w.npz")
    scores = {k: rng.normal(size=10) for k in ("o", "f", "e", "p", "t")}
    kw = dict(population=pop, wt_onehot=wt, oracle_scores=scores["o"],
              fitness=scores["f"], energy=scores["e"],
              potts_scores=scores["p"], steps_per_sec=12.345,
              wall_steps_per_sec=10.0, potts_provenance="synthetic")
    for t in (None, scores["t"]):
        got = runtime.cell_summary(args, tmp_path, transformer_scores=t, **kw)
        assert got == jruntime.cell_summary(args, tmp_path,
                                            transformer_scores=t, **kw)
        assert ("evolutionary_density" in got) == (t is not None)
    runtime.dump_config(args, tmp_path / "a.txt")
    jruntime.dump_config(args, tmp_path / "b.txt")
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
