"""Protein evaluation in ppde_tpu_torch against the JAX package: the rest of
io.py, utils.n_hops, the Potts artifact writer, the two protein scorers of
metrics.py, and the five evaluation entry points (eval_proteins,
select_lambda, calibrate_oracle_scale, eval_expert_correlation,
make_figures), each package's ``main`` on the same inputs, on the CPU.

Inputs: the tracked synthetic alignments and UBE4B Potts fit, and protein
directories of seeded stand-ins (scripts/seeded_protein.py). The transformer
and MSA-Transformer weights are JAX-written files (esm2.save_npz_checkpoint,
training.save_ckpt) that both packages read: their random inits differ.

Tolerances: lambda and the calibration record's numbers at rtol 1e-4 (or
one unit of the place they are rounded to); Potts, CNN and oracle scores at
rtol 1e-4 / atol 1e-4 (float32 sums in another order; a Potts score is the
difference of two Hamiltonians some 30x larger); the MSA Transformer's
scores at float32 within 1e-4 absolute, the ESM2 expert's within 1e-3 (a
delta PLL is the difference of two sums of 237 log-probabilities, about
-700); Spearman rho within 1e-3, and the calibration record's rho of a
mutation-count group (about 50 mutants) within 5e-3: one swap of two
near-equal dH moves such a rho by up to 12 * 61 / (62 * (62**2 - 1)) =
3e-3 (measured: 0.0029, dH equal to 1.1e-6). The MSA Transformer's bf16
scores (``load``'s default type, which eval_proteins runs) within
BF16_SCORE_TOL = 0.3 absolute on scores of magnitude 1-6: measured up to
0.206 with these weights (init scale 0.3), where the two frameworks round
bf16 intermediates at different places, as for ESM2
(test_torch_port_esm2.py: 0.15 on logits). eval_expert_correlation is
compared at float32 (both packages' loaders patched to it), so that its
rho are held to 1e-3."""
import functools
import importlib
import json
import os
import subprocess
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import io as jio, metrics as jmetrics, training as jtraining
from ppde_tpu import utils as jutils
from ppde_tpu.models import esm2 as jesm2, msa_transformer as jmsat
from ppde_tpu.models import potts as jpotts
from ppde_tpu_torch import codec, io as pio, metrics, utils
from ppde_tpu_torch.models import esm2, msa_transformer as msat, potts
from ppde_tpu_torch.scripts import (calibrate_oracle_scale,
                                    eval_expert_correlation, eval_proteins,
                                    make_figures, seeded_protein,
                                    select_lambda)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GFP_A2M = os.path.join(REPO, "data/proteins/synthetic/"
                       "GFP_AEQVI_Sarkisyan2016_synth.a2m")
PABP_A2M = os.path.join(REPO, "data/proteins/synthetic/"
                        "PABP_YEAST_Fields2013_synth.a2m")
UBE4B = "UBE4B_MOUSE_Klevit2013-nscor_log2_ratio"
UBE4B_NPZ = os.path.join(REPO, "weights", UBE4B, "potts.npz")
GFP = "GFP_AEQVI_Sarkisyan2016"
TOY = "TOY_PROTEIN"
WT = "MKTAYIAKQRQISFVKSHFS"  # 20 residues
TINY_ESM = dict(layers=1, dim=32, heads=4, ffn=64)
BF16_SCORE_TOL = 0.3
HAND_A2M = """>FOCUS/5-14 a hand-written alignment
ACdeFG-HIK
LM
>row_1
ACDEFGHIKLMNPQ
>row_2 lower-case and dots in the inserts
AC..FGaHIK.LM
>row_3 has an X in a focus column
ACDEXG-HIKLMNP
>row_4
-CDE.G-HIKLM.Q
"""


def _jax_script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    return importlib.import_module(name)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the synthetic Potts
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def gfp_wt():
    return pio.load_msa(GFP_A2M)[0][1]


@pytest.fixture(scope="module")
def root(tmp_path_factory, gfp_wt):
    """Seeded protein directories: GFP width, a 20-residue toy, and a UBE4B
    layout whose wild type covers the tracked fit's window (23-98)."""
    root = str(tmp_path_factory.mktemp("weights"))
    seeded_protein.write_protein_dir(root, GFP, gfp_wt, seed=0)
    seeded_protein.write_protein_dir(root, TOY, WT, seed=1)
    rng = np.random.default_rng(5)
    seeded_protein.write_protein_dir(
        root, UBE4B, "".join(rng.choice(list(codec.ALPHABET), 104)), seed=2)
    return root


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 20-column alignment for the toy protein and JAX-written weights:
    msa-tiny (training.save_ckpt) and a one-layer ESM2
    (esm2.save_npz_checkpoint)."""
    d = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(3)
    lines = [f">{TOY}/1-20", WT]
    for i in range(12):
        row = np.array(list(WT))
        flip = rng.random(20) < 0.3
        row[flip] = rng.choice(list(codec.ALPHABET + "-"), flip.sum())
        lines += [f">r{i}", "".join(row)]
    (d / "toy.a2m").write_text("\n".join(lines) + "\n")
    jtraining.save_ckpt(str(d / "msat.npz"), jmsat.init(
        jax.random.PRNGKey(2), jnp.float32, scale=0.3, name="msa-tiny"), 0)
    with pytest.MonkeyPatch.context() as m:
        m.setitem(jesm2.CONFIGS, "transformer-tiny", TINY_ESM)
        jesm2.save_npz_checkpoint(str(d / "esm.npz"), jesm2.init(
            jax.random.PRNGKey(3), "transformer-tiny", dtype=jnp.float32,
            scale=0.3))
    return types.SimpleNamespace(a2m=str(d / "toy.a2m"),
                                 msat=str(d / "msat.npz"),
                                 esm=str(d / "esm.npz"))


@pytest.fixture
def tiny_esm(monkeypatch):
    monkeypatch.setitem(jesm2.CONFIGS, "transformer-tiny", TINY_ESM)
    monkeypatch.setitem(esm2.CONFIGS, "transformer-tiny", TINY_ESM)


def population(wt, n, seed, max_mut=3):
    """n one-hot variants of wt with 0..max_mut substitutions (row 0 = WT,
    two repeated rows)."""
    rng = np.random.default_rng(seed)
    ints = np.repeat(codec.seqs_to_ints([wt]), n, 0)
    for i in range(1, n):
        pos = rng.choice(len(wt), size=rng.integers(1, max_mut + 1),
                         replace=False)
        ints[i, pos] = (ints[i, pos] + rng.integers(1, 20, len(pos))) % 20
    ints[-1] = ints[-2]
    return codec.ints_to_onehot(ints)


# ---------------------------------------------------------------------------
# io, utils, the Potts artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["gfp", "pabp", "hand"])
def test_alignment_readers_match_jax(tmp_path, which):
    path = {"gfp": GFP_A2M, "pabp": PABP_A2M}.get(which)
    if path is None:
        path = str(tmp_path / "hand.a2m")
        with open(path, "w") as f:
            f.write(HAND_A2M)
    got = pio.load_msa(path)
    assert got == jio.load_msa(path)
    assert pio.focus_columns(path) == jio.focus_columns(path)
    assert pio.msa_region(path) == jio.msa_region(path)
    if which == "hand":
        # focus = the upper case of the first record; '.' -> '-'; the row
        # with an X in a focus column is dropped
        assert pio.msa_region(path) == ("FOCUS", 5, 14)
        assert [(n.split()[0], s) for n, s in got] == [
            (">FOCUS/5-14", "ACFG-HIKLM"), (">row_1", "ACFGHIKLMN"),
            (">row_2", "ACFGAHIK-L"), (">row_4", "-C-G-HIKLM")]
    else:
        assert len(got) > 1000 and len({len(s) for _, s in got}) == 1


def test_txt_shards_roundtrip_as_jax(tmp_path):
    lines = [f"line {i}" for i in range(11)]
    got = pio.save_txt_sharded(lines, str(tmp_path / "a" / "s"), 3)
    want = jio.save_txt_sharded(lines, str(tmp_path / "b" / "s"), 3)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
    assert pio.load_txt_sharded(str(tmp_path / "a" / "s")) == lines
    assert pio.load_txt_sharded(str(tmp_path / "b" / "s")) == lines
    assert pio.ensure_dir(str(tmp_path / "c")) == str(tmp_path / "c")
    with pytest.raises(FileNotFoundError, match="no shards"):
        pio.load_txt_sharded(str(tmp_path / "none"))


def test_n_hops_and_quantiles_match_jax():
    pop = population(WT, 16, 7)
    wt = codec.seqs_to_onehot([WT])[0]
    m, s = utils.n_hops(torch.from_numpy(pop), torch.from_numpy(wt))
    jm, js = jutils.n_hops(jnp.asarray(pop), jnp.asarray(wt))
    assert float(m) == pytest.approx(float(jm), rel=1e-6)
    assert float(s) == pytest.approx(float(js), rel=1e-6)
    v = np.random.default_rng(0).normal(size=33)
    np.testing.assert_array_equal(utils.quantiles(torch.from_numpy(v)),
                                  jutils.quantiles(v))
    np.testing.assert_array_equal(utils.quantiles(v, (0.1, 1.0)),
                                  jutils.quantiles(v, (0.1, 1.0)))


def test_potts_save_npz_round_trips_the_ube4b_fit(tmp_path, root):
    """as_dense_J of the tracked fit equals its J in float32 and the JAX
    package's as_dense_J; save_npz writes the JAX package's arrays, and
    the file loads back to the same W, h and wt_H bit for bit."""
    wt = pio.read_fasta(os.path.join(root, UBE4B, "wt.fasta"))[0]
    z = np.load(UBE4B_NPZ)
    pp = potts.load_npz(UBE4B_NPZ, wt, device="cpu")
    J = potts.as_dense_J(pp)
    assert J.dtype == np.float64 and J.shape == (76, 76, 20, 20)
    np.testing.assert_array_equal(J, z["J"].astype(np.float32))
    np.testing.assert_array_equal(
        J, jpotts.as_dense_J(jpotts.load_npz(UBE4B_NPZ, wt)))
    args = (J, z["h"], z["index_list"], float(z["reg_coef"]),
            int(z["offset"]))
    potts.save_npz(str(tmp_path / "a.npz"), *args)
    jpotts.save_npz(str(tmp_path / "b.npz"), *args)
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    pp2 = potts.load_npz(str(tmp_path / "a.npz"), wt, device="cpu")
    for f in ("W", "h", "wt_H"):
        assert torch.equal(getattr(pp2, f), getattr(pp, f)), f
    assert (pp2.min_pos, pp2.max_pos, pp2.reg_coef) == (23, 98,
                                                        pp.reg_coef)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_proteins_potts_score_matches_jax(root):
    pop = population(pio.read_fasta(os.path.join(root, TOY,
                                                  "wt.fasta"))[0], 12, 1)
    d = os.path.join(root, TOY)
    got = _quiet(metrics.proteins_potts_score, pop, d, device="cpu")
    want = _quiet(jmetrics.proteins_potts_score, pop, d)
    assert got.shape == (12,) and got[0] == pytest.approx(0.0, abs=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _density(pkg_metrics, pkg_msat, dtype, monkeypatch, *args, **kw):
    monkeypatch.setattr(pkg_msat, "load", functools.partial(
        pkg_msat.load, dtype=dtype))
    return _quiet(pkg_metrics.proteins_transformer_score, *args, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proteins_transformer_score_matches_jax(root, files, monkeypatch,
                                                dtype):
    """Both packages on one population, the same alignment rows (the seeded
    draw of 9 of 13) and the same msa-tiny file; the WT row scores 0.0."""
    pop = population(WT, 12, 2)
    args = (pop, os.path.join(root, TOY), files.a2m, 10)
    kw = dict(weights_path=files.msat, msa_model="msa-tiny", seed=4)
    with monkeypatch.context() as m:
        want = _density(jmetrics, jmsat, getattr(jnp, dtype), m, *args, **kw)
    got = _density(metrics, msat, getattr(torch, dtype), monkeypatch, *args,
                   device="cpu", **kw)
    assert got.shape == (12,) and got[0] == 0.0
    assert np.abs(got[1:]).max() > 0
    tol = 1e-4 if dtype == "float32" else BF16_SCORE_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_transformer_score_is_additive(tmp_path, monkeypatch):
    """The JAX package's test_masked_marginal_metric_additivity, mirrored:
    the WT scores 0.0, a double mutant its two single mutants' sum."""
    wt = "ACDEFGHIKL"
    d = tmp_path / "prot"
    d.mkdir()
    (d / "wt.fasta").write_text(f">wt/1-{len(wt)}\n{wt}\n")
    msa = tmp_path / "m.a2m"
    msa.write_text(f">wt/1-{len(wt)}\n{wt}\n>o1\nACDEFGHIKV\n"
                   ">o2\nACDEFGWIKL\n")
    pop = codec.seqs_to_onehot([wt, "YCDEFGHIKV", "YCDEFGHIKL",
                                "ACDEFGHIKV"])
    kw = dict(allow_random=True, msa_model="msa-tiny")
    got = _density(metrics, msat, torch.float32, monkeypatch, pop, str(d),
                   str(msa), 3, device="cpu", **kw)
    assert got.shape == (4,) and got[0] == 0.0 and got[1] != 0.0
    assert got[1] == pytest.approx(got[2] + got[3], abs=1e-6)
    want = _quiet(jmetrics.proteins_transformer_score, pop[:2], str(d),
                  str(msa), msa_size=3, **kw)
    assert want[0] == 0.0 and want[1] != 0.0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _args(mod, *argv):
    return mod.build_parser().parse_args([*argv, "--device", "cpu"])


def assert_record_close(got, want, key="record", rho_abs=None):
    """Records of rounded numbers: each float at rtol 1e-4, or within one
    unit of the last place it was rounded to; the values of a key holding
    "spearman" within ``rho_abs`` when given."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), key
        for k in want:
            assert_record_close(got[k], want[k], f"{key}.{k}", rho_abs)
    elif isinstance(want, float):
        unit = 10.0 ** -len(repr(want).partition(".")[2])
        if rho_abs is not None and "spearman" in key:
            unit = rho_abs
        assert got == pytest.approx(want, rel=1e-4, abs=unit), key
    else:
        assert got == want, key


def test_select_lambda_matches_jax(root, tmp_path, capsys):
    argv = ["--protein_weights", root, "--protein", GFP, "--n_mutants",
            "256"]
    a = _args(select_lambda, *argv, "--out_json", str(tmp_path / "a.jsonl"))
    lam = _quiet(select_lambda.main, a)
    got_line = capsys.readouterr().out
    a.out_json = str(tmp_path / "b.jsonl")
    _quiet(_jax_script("select_lambda").main, a)
    want_line = capsys.readouterr().out
    assert got_line.split(":")[0] == want_line.split(":")[0] == GFP
    got = json.loads((tmp_path / "a.jsonl").read_text())
    want = json.loads((tmp_path / "b.jsonl").read_text())
    assert_record_close(got, want)
    assert lam == pytest.approx(want["lambda"], abs=1e-3) and lam > 0


def test_calibrate_oracle_scale_matches_jax(root, tmp_path):
    """The UBE4B-layout directory with the tracked fit: the same record
    (numbers at rtol 1e-4), the same --out_npz arrays, and the round-trip
    assertions pass in both."""
    argv = ["--protein_weights", root, "--protein", UBE4B, "--potts_npz",
            UBE4B_NPZ, "--n_mutants", "512"]
    a = _args(calibrate_oracle_scale, *argv, "--out_npz",
              str(tmp_path / "a.npz"), "--out_json", str(tmp_path / "a.jsonl"))
    rec = calibrate_oracle_scale.main(a)
    a.out_npz, a.out_json = str(tmp_path / "b.npz"), str(tmp_path / "b.jsonl")
    _jax_script("calibrate_oracle_scale").main(a)
    got = json.loads((tmp_path / "a.jsonl").read_text())
    want = json.loads((tmp_path / "b.jsonl").read_text())
    assert json.loads(json.dumps(rec)) == got
    assert got["verified_std_dH_single"] == pytest.approx(
        got["target_std"], rel=0.02)
    assert got.pop("out_npz") != want.pop("out_npz")
    assert_record_close(got, want, rho_abs=5e-3)
    za, zb = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_allclose(za[k], zb[k], rtol=1e-4, err_msg=k)


def test_eval_expert_correlation_matches_jax(root, files, tiny_esm, capsys,
                                            monkeypatch):
    """GFP width, 40 mutants: potts, CNN, a one-layer transformer (JAX's
    file, chunks of 16 with a ragged last one) and the msa-tiny density
    column over 12 context rows of the GFP synthetic alignment, both
    transformers in float32; every expert's scores and every rho against
    the JAX package's."""
    for mod, f32 in ((jesm2, jnp.float32), (esm2, torch.float32)):
        monkeypatch.setattr(mod, "load_expert", functools.partial(
            mod.load_expert, dtype=f32))
    for mod, f32 in ((jmsat, jnp.float32), (msat, torch.float32)):
        monkeypatch.setattr(mod, "load", functools.partial(mod.load,
                                                            dtype=f32))
    argv = ["--protein_weights", root, "--protein", GFP, "--n_mutants",
            "40", "--max_mutations", "3", "--esm_model", "transformer-tiny",
            "--esm_weights", files.esm, "--esm_chunk", "16",
            "--msat_model", "msa-tiny", "--msat_weights", files.msat,
            "--msa_path", GFP_A2M, "--msa_size", "12"]
    a = _args(eval_expert_correlation, *argv)
    jmod = _jax_script("eval_expert_correlation")
    calls = {}

    def recording(mod):
        orig, seen = mod.spearman, calls.setdefault(mod.__name__, [])

        def spearman(x, y):
            seen.append(np.asarray(x))
            return orig(x, y)
        return spearman

    with pytest.MonkeyPatch.context() as m:
        for mod in (eval_expert_correlation, jmod):
            m.setattr(mod, "spearman", recording(mod))
        got = _quiet(eval_expert_correlation.main, a)
        want = _quiet(jmod.main, a)
    capsys.readouterr()
    keys = ["potts", "cnn_ensemble", "transformer_finetuned", "msat_trained"]
    assert list(got["spearman_vs_oracle"])[:4] == keys
    assert got["spearman_vs_oracle"].keys() == \
        want["spearman_vs_oracle"].keys()
    # each expert's scores: the first whole-population argument of each
    # expert's spearman calls, in the order of keys
    g_all, w_all = ([x for x in calls[mod.__name__] if len(x) == 40][:4]
                    for mod in (eval_expert_correlation, jmod))
    for k, g, w in zip(keys, g_all, w_all):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3 if k.startswith(
            "transformer") else 1e-4, err_msg=k)
    for k, w in want["spearman_vs_oracle"].items():
        assert got["spearman_vs_oracle"][k] == pytest.approx(w, abs=1e-3), k
    for k, w in want["spearman_by_n_mut"].items():
        assert got["spearman_by_n_mut"][k].keys() == w.keys(), k
        for m_, r in w.items():
            assert got["spearman_by_n_mut"][k][m_] == pytest.approx(
                r, abs=1e-3), (k, m_)


def test_eval_expert_correlation_helpers_are_the_jax_packages():
    jmod = _jax_script("eval_expert_correlation")
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=50), rng.normal(size=50)
    assert eval_expert_correlation.spearman(a, b) == jmod.spearman(a, b)
    assert eval_expert_correlation.spearman(a, a) == pytest.approx(1.0)
    wt = codec.seqs_to_ints([WT])[0]
    np.testing.assert_array_equal(
        eval_expert_correlation.sample_mutants(wt, 2, 17, 30, 4, 3),
        jmod.sample_mutants(wt, 2, 17, 30, 4, 3))
    np.testing.assert_array_equal(
        calibrate_oracle_scale.sample_mutants(
            np.random.default_rng(1), wt, 2, 17, 30, 5)[0],
        _jax_script("calibrate_oracle_scale").sample_mutants(
            np.random.default_rng(1), wt, 2, 17, 30, 5)[0])


def _run_dirs(root, base, files):
    """Two run directories of the toy protein (population + summary.json)
    and a third with no population; run 1's stable copy is current, run
    2's belongs to another run."""
    out = []
    for i in range(3):
        rd = base / "runs" / f"run{i}"
        rd.mkdir(parents=True)
        if i == 2:
            out.append(rd)
            continue
        np.save(rd / "population.npy", population(WT, 10, 10 + i))
        np.save(rd / "oracle_fitness_scores.npy",
                np.random.default_rng(i).normal(size=10))
        np.save(rd / "energy_scores.npy",
                np.random.default_rng(i + 5).normal(size=10))
        stable = base / f"stable{i}.json"
        summary = {"protein": TOY, "run_dir": str(rd),
                   "summary_json": str(stable)}
        (rd / "summary.json").write_text(json.dumps(summary))
        stable.write_text(json.dumps(
            summary if i == 0 else dict(summary, run_dir="newer")))
        out.append(rd)
    return out


def test_eval_proteins_matches_jax(root, files, tmp_path, capsys):
    """Both packages' eval_proteins on copies of the same run directories
    with --update_summary: transformer_scores.npy, the folded summary.json
    and its stable copy; a stable copy that another run owns is skipped."""
    for pkg in ("a", "b"):
        _run_dirs(root, tmp_path / pkg, files)
    argv = ["--protein_weights", root, "--protein", TOY, "--msa_path",
            files.a2m, "--msa_size", "8", "--msa_transformer_weights",
            files.msat, "--msa_transformer_model", "msa-tiny",
            "--update_summary"]
    a = _args(eval_proteins, *argv, "--runs_glob",
              str(tmp_path / "a" / "runs" / "*"))
    _quiet(eval_proteins.main, a)
    got_out = capsys.readouterr().out
    a.runs_glob = str(tmp_path / "b" / "runs" / "*")
    _quiet(_jax_script("eval_proteins").main, a)
    want_out = capsys.readouterr().out
    assert got_out.count("SKIPPED stale stable copy") == 1
    assert want_out.count("SKIPPED stale stable copy") == 1
    assert got_out.count("  updated ") == want_out.count("  updated ") == 3
    for i in range(2):
        ga, wa = (tmp_path / p / "runs" / f"run{i}" for p in "ab")
        g, w = (np.load(d / "transformer_scores.npy") for d in (ga, wa))
        assert g.shape == (10,) and g[0] == 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_SCORE_TOL)
        gs, ws = (json.loads((d / "summary.json").read_text())
                  for d in (ga, wa))
        assert gs.keys() == ws.keys()
        assert gs["evolutionary_density"].keys() == \
            ws["evolutionary_density"].keys()
        for k in ("msa_transformer_model", "density_msa_size"):
            assert gs[k] == ws[k]
        stable = json.loads((tmp_path / "a" / f"stable{i}.json").read_text())
        assert (stable == gs) == (i == 0)
    assert not (tmp_path / "a" / "runs" / "run2" /
                "transformer_scores.npy").exists()
    a.runs_glob = str(tmp_path / "none" / "*")
    eval_proteins.main(a)
    assert "no runs match" in capsys.readouterr().out


def test_make_figures_matches_jax(root, files, tmp_path, capsys):
    for pkg in ("a", "b"):
        _run_dirs(root, tmp_path / pkg, files)
    np.save(tmp_path / "a" / "runs" / "run0" / "transformer_scores.npy",
            np.arange(10.0))
    np.save(tmp_path / "b" / "runs" / "run0" / "transformer_scores.npy",
            np.arange(10.0))
    rows = []
    for pkg, main in (("a", make_figures.main),
                      ("b", _jax_script("make_figures").main)):
        a = _args(make_figures, "--protein_weights", root, "--protein", TOY,
                  "--runs_glob", str(tmp_path / pkg / "runs" / "*"),
                  "--out_json", str(tmp_path / f"{pkg}.json"))
        main(a)
        rows.append(json.loads((tmp_path / f"{pkg}.json").read_text()))
    capsys.readouterr()
    got, want = rows
    assert len(got) == 2 and got[0]["evolutionary_density_p100"] == 9.0
    for g, w in zip(got, want):
        assert g.pop("run").replace("/a/", "/b/") == w.pop("run")
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12), k


@pytest.mark.parametrize("mod", [eval_proteins, select_lambda,
                                 calibrate_oracle_scale,
                                 eval_expert_correlation, make_figures])
def test_default_device_needs_a_gpu(mod, root, tmp_path):
    """Every evaluation entry point takes --device, cuda by default: without
    a GPU the default raises (no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    argv = ["--protein_weights", root, "--protein", TOY]
    if mod is eval_proteins or mod is make_figures:
        argv += ["--runs_glob", str(tmp_path / "*")]
    a = mod.build_parser().parse_args(argv)
    assert a.device == "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(a)


def test_module_entry_points(root, tmp_path):
    """``python -m`` runs the evaluation entry points (select_lambda on the
    toy protein; the others parse --help)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-W", "ignore", "-m",
         "ppde_tpu_torch.scripts.select_lambda", "--protein_weights", root,
         "--protein", TOY, "--n_mutants", "16", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, check=True)
    assert out.stdout.startswith(f"{TOY}: std(unsup)=")
    for name in ("eval_proteins", "calibrate_oracle_scale",
                 "eval_expert_correlation", "make_figures"):
        out = subprocess.run(
            [sys.executable, "-m", f"ppde_tpu_torch.scripts.{name}",
             "--help"], capture_output=True, text=True, env=env,
            cwd=tmp_path, check=True)
        assert "--device" in out.stdout, name
