"""ppde_tpu_torch.models.msa_transformer against ppde_tpu.models.
msa_transformer: the weights made by the JAX package's seeded init (or read
from the same file) and carried over with convert.msa_transformer_from_numpy.

Tolerances, on the CPU: float32 logits within 1e-4 of the largest logit
magnitude (sums in another order than XLA's; measured 1e-7 at msa-tiny and
8e-7 at msa-S). bfloat16: log-probabilities within 0.025 (measured 0.0021 at
msa-tiny and 0.0080 at msa-S: the frameworks round bf16 intermediates at
different places). Masked marginals at float32 within 1e-5, rows summing to
1 within 1e-5. Loaders: leaves equal bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import training as jtraining
from ppde_tpu.models import msa_transformer as jmsat
from ppde_tpu_torch import convert
from ppde_tpu_torch.models import esm2, msa_transformer as msat

torch.set_num_threads(1)
ALPHABET = list("ACDEFGHIKLMNPQRSTVWY-")
R, C = 8, 20  # 8 alignment rows of 20 columns: C = 21 tokens with <cls>
BF16_LOGP_TOL = 0.025
SCORER_S = "results/esm_family/GFP_msat_S_ckpt_2000.npz"


def rows(seed=0, n=R, width=C):
    """Alignment rows from a numpy seed; row 3 is short, so that its tail
    is <pad> tokens."""
    rng = np.random.default_rng(seed)
    out = ["".join(rng.choice(ALPHABET, width)) for _ in range(n)]
    out[3] = out[3][: width - 5]
    return out


def jax_params(name, dtype=jnp.float32, seed=1):
    return jmsat.init(jax.random.PRNGKey(seed), dtype, name=name)


def carry(jparams):
    return convert.msa_transformer_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def leaves(tree):
    return esm2._flatten(tree)


def assert_same_leaves(tparams, jparams):
    jl = jax.tree.leaves(jparams)
    tl = leaves(tparams)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32))


def logits_both(name, dtype, tdtype):
    jp = jax_params(name, dtype)
    toks = jmsat.tokenize_msa(rows())
    jl = np.asarray(jmsat.forward_logits(jp, jnp.asarray(toks)[None],
                                         jmsat.heads_of(name)), np.float32)
    with torch.no_grad():
        tl = msat.forward_logits(carry(jp), torch.from_numpy(toks)[None],
                                 msat.heads_of(name)).numpy()
    assert tl.dtype == np.float32 and tl.shape == (1, R, C + 1, 33)
    return jl, tl


def test_configs_and_constants_equal_the_jax_package():
    assert msat.CONFIGS == jmsat.CONFIGS
    assert msat.CFG == jmsat.CFG
    for name in msat.CONFIGS:
        assert msat.heads_of(name) == jmsat.heads_of(name)
    for name in ("CLS_IDX", "MASK_IDX", "PAD_IDX", "ESM_VOCAB"):
        assert getattr(msat, name) == getattr(jmsat, name), name
    assert msat.ESM_TOK_TO_IDX == jmsat.ESM_TOK_TO_IDX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_has_the_jax_layout_and_dtypes(dtype):
    """init's tree, leaf order, shapes and dtypes equal the JAX package's
    (the values come from another generator)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.eval_shape(lambda: jax_params("msa-tiny", jdt))
    tp = msat.init(torch.Generator().manual_seed(0), dtype, name="msa-tiny")
    jl, tl = jax.tree.leaves(jp), leaves(tp)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [str(t.dtype).removeprefix("torch.") for t in tl] == \
        [j.dtype.name for j in jl]
    assert tp["msa_pos_embed"].float().std() < tp["embed"].float().std()


def test_cast_params_keeps_the_jax_packages_float32_leaves():
    jp = jmsat.cast_params(jax_params("msa-tiny"), jnp.bfloat16)
    tp = msat.cast_params(carry(jax_params("msa-tiny")), torch.bfloat16)
    assert_same_leaves(tp, jp)


def test_tokenize_msa_is_bit_for_bit():
    rs = rows(2) + ["AC.X*BZ", "a-c"]
    np.testing.assert_array_equal(msat.tokenize_msa(rs),
                                  jmsat.tokenize_msa(rs))


@pytest.mark.parametrize("name", ["msa-tiny", "msa-S"])
def test_forward_logits_f32_matches_jax(name):
    jl, tl = logits_both(name, jnp.float32, torch.float32)
    scale = float(np.abs(jl).max())
    assert np.abs(tl - jl).max() <= 1e-4 * scale


@pytest.mark.parametrize("name", ["msa-tiny", "msa-S"])
def test_bf16_close_to_jax(name):
    jl, tl = logits_both(name, jnp.bfloat16, torch.bfloat16)
    jlp = np.asarray(jax.nn.log_softmax(jl, -1))
    tlp = torch.log_softmax(torch.from_numpy(tl), -1).numpy()
    assert np.isfinite(tlp).all()
    assert np.abs(tlp - jlp).max() <= BF16_LOGP_TOL


@pytest.mark.parametrize("batch_cols", [2, 4])
def test_masked_marginals_match_jax(batch_cols):
    """Seven columns (one repeated) in batches of 2 and 4: a ragged last
    batch either way; log-softmax rows summing to 1."""
    jp = jax_params("msa-S")
    rs = rows(3)
    cols = [0, 4, 9, 9, 13, 17, C - 1]
    want = jmsat.masked_marginals(jp, rs[0], rs[1:], cols, batch_cols,
                                  jmsat.heads_of("msa-S"))
    got = msat.masked_marginals(carry(jp), rs[0], rs[1:], cols, batch_cols,
                                msat.heads_of("msa-S"))
    assert got.shape == (len(cols), 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got[2], got[3])


def test_load_npz_checkpoint_matches_jax(tmp_path):
    """training.save_ckpt of msat.init(msa-tiny): both loaders give the
    same leaves, at float32 and bf16, and ``load`` reads it by suffix."""
    path = str(tmp_path / "msat.npz")
    jtraining.save_ckpt(path, jax_params("msa-tiny", seed=4), 7)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        assert_same_leaves(
            msat.load_npz_checkpoint(path, "msa-tiny", tdt, "cpu"),
            jmsat.load_npz_checkpoint(path, "msa-tiny", jdt))
    assert_same_leaves(msat.load(path, name="msa-tiny", device="cpu"),
                       jmsat.load(path, name="msa-tiny"))


def test_load_npz_checkpoint_refuses_what_jax_refuses(tmp_path):
    """A checkpoint of another architecture, and one with a leaf of the
    wrong shape, raise the JAX package's messages."""
    path = str(tmp_path / "msat.npz")
    jtraining.save_ckpt(path, jax_params("msa-tiny"), 0)
    with pytest.raises(ValueError) as want:
        jmsat.load_npz_checkpoint(path, "msa-S")
    with pytest.raises(ValueError, match="wrong architecture") as got:
        msat.load_npz_checkpoint(path, "msa-S", device="cpu")
    assert str(got.value) == str(want.value)

    z = dict(np.load(path))
    z["p0"] = z["p0"][:, :16]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **z)
    with pytest.raises(ValueError) as want:
        jmsat.load_npz_checkpoint(bad, "msa-tiny")
    with pytest.raises(ValueError, match="leaf p0 has shape") as got:
        msat.load_npz_checkpoint(bad, "msa-tiny", device="cpu")
    assert str(got.value) == str(want.value)


def test_tracked_family_scorer_loads_as_in_jax():
    """The repository's family-trained msa-S scorer (GFP) loads to the
    JAX package's leaves, and both give the same logits on a GFP-width
    alignment."""
    want = jmsat.load_npz_checkpoint(SCORER_S, "msa-S", jnp.float32)
    got = msat.load_npz_checkpoint(SCORER_S, "msa-S", torch.float32, "cpu")
    assert_same_leaves(got, want)
    toks = jmsat.tokenize_msa(rows(5, n=4, width=237))
    jl = np.asarray(jmsat.forward_logits(want, jnp.asarray(toks)[None], 8))
    with torch.no_grad():
        tl = msat.forward_logits(got, torch.from_numpy(toks)[None],
                                 8).numpy()
    assert np.abs(tl - jl).max() <= 1e-4 * float(np.abs(jl).max())


def test_load_without_weights_raises_the_jax_message():
    with pytest.raises(FileNotFoundError) as want:
        jmsat.load(None)
    with pytest.raises(FileNotFoundError) as got:
        msat.load(None, device="cpu")
    assert str(got.value) == str(want.value)


def _fair_esm_positions(jparams):
    """The JAX package's loaded leaves with the column positions' table
    read as fair-esm reads it (column c at row c + 2): the JAX loader keeps
    fair-esm's whole 1,026-row table, the port's loader its rows 2.."""
    return dict(jparams, pos_embed=jparams["pos_embed"][2:])


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """A fair-esm msa1b state dict (the exact key manifest, both key
    prefixes): the converted leaves equal the JAX package's (the column
    positions' table from its row 2 on, as fair-esm reads it), and one
    forward over a 3-row MSA matches at float32."""
    from tests.test_weight_manifests import make_msa1b_state_dict

    toks = msat.tokenize_msa(["MKTAYI", "MKTAYI", "MRTAYI"])
    for prefix in ("encoder.sentence_encoder.", "sentence_encoder."):
        path = tmp_path / "msa1b.pt"
        torch.save({"args": {"arch": "msa_transformer"},
                    "model": make_msa1b_state_dict(prefix=prefix)}, path)
        want = _fair_esm_positions(
            jmsat.load_torch_checkpoint(str(path), dtype=jnp.float32))
        got = msat.load_torch_checkpoint(str(path), torch.float32, "cpu")
        assert_same_leaves(got, want)
        del want
    jl = np.asarray(jmsat.forward_logits(_fair_esm_positions(
        jmsat.load_torch_checkpoint(str(path), dtype=jnp.float32)),
        jnp.asarray(toks)[None]))
    with torch.no_grad():
        tl = msat.forward_logits(got, torch.from_numpy(toks)[None]).numpy()
    assert np.isfinite(tl).all()
    assert np.abs(tl - jl).max() <= 1e-4 * float(np.abs(jl).max())


def test_random_load_is_seeded():
    """allow_random gives the same weights on every call (seed 0)."""
    load = functools.partial(msat.load, None, allow_random=True,
                             name="msa-tiny", device="cpu")
    for a, b in zip(leaves(load()), leaves(load())):
        assert torch.equal(a, b)
