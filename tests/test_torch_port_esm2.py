"""ppde_tpu_torch.models.esm2 against ppde_tpu.models.esm2 on a tiny config
(2 layers, dim 32, 4 heads, ffn 64), the weights made by the JAX package's
seeded init and carried over through convert.esm2_from_numpy.

Tolerances: float32 on the CPU at rtol 1e-4 / atol 1e-4 (sums in another
order than XLA's; the port's layer norm is torch's fused one). bfloat16:
logits (of size about 2) at rtol 5e-2 / atol 0.15 with a mean absolute error
below 0.03, and the pseudo-log-likelihood (about -80) at 0.5 absolute: the
two frameworks round bf16 intermediates at different places (XLA fuses
elementwise chains in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec
from ppde_tpu.models import esm2 as jesm2
from ppde_tpu.ops import attention_pallas
from ppde_tpu_torch import convert
from ppde_tpu_torch.models import esm2

torch.set_num_threads(1)
TINY = dict(layers=2, dim=32, heads=4, ffn=64)
HEADS = TINY["heads"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
SEQS = ["ACDEFGHIKLMNPQRSTVWYAC", "WYACDEFGHIKLMNPQRSTVAC",
        "MMKLVACDEFGHIKLNPQRSTV"]


@pytest.fixture(autouse=True)
def tiny_config():
    jesm2.CONFIGS["tiny"] = TINY
    esm2.CONFIGS["tiny"] = TINY
    yield


def jax_params(dtype=jnp.float32, seed=0, scale=0.3):
    return jesm2.init(jax.random.PRNGKey(seed), "tiny", dtype=dtype,
                      scale=scale)


def carry(jparams):
    return convert.esm2_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def onehots(seqs=SEQS):
    return np.stack([jesm2.seq_to_esm_onehot(s) for s in seqs])


def leaves(tree):
    return esm2._flatten(tree)


def test_vocabulary_and_helpers_equal_the_jax_package():
    assert esm2.ESM_TOKS == jesm2.ESM_TOKS
    for name in ("ESM_VOCAB", "MASK_IDX", "CLS_IDX", "EOS_IDX", "PAD_IDX",
                 "MASK_RATIO_TRAIN"):
        assert getattr(esm2, name) == getattr(jesm2, name), name
    for name in ("transformer-S", "transformer-M", "transformer",
                 "transformer-L"):
        assert esm2.CONFIGS[name] == jesm2.CONFIGS[name]
    np.testing.assert_array_equal(esm2.potts_to_esm_perm(),
                                  jesm2.potts_to_esm_perm())
    np.testing.assert_array_equal(esm2.seq_to_esm_onehot("ACDXZ?"),
                                  jesm2.seq_to_esm_onehot("ACDXZ?"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_the_jax_tree(dtype):
    """Same keys, shapes and types as the JAX init, leaf by leaf in the JAX
    flatten order; seeded and repeatable."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jp = jax_params(jdt)
    tp = esm2.init(torch.Generator().manual_seed(0), "tiny", dtype=tdt)
    jflat, _ = jax.tree.flatten(jp)
    tflat = leaves(tp)
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
    assert list(tp) == list(jp) and list(tp["layers"][0]) == list(
        jp["layers"][0])
    tp2 = esm2.init(torch.Generator().manual_seed(0), "tiny", dtype=tdt)
    assert all(torch.equal(a, b) for a, b in zip(tflat, leaves(tp2)))
    w = tp["layers"][1]["fc1"]["w"].float()
    assert 0.01 < w.std() < 0.03 and tp["layers"][0]["q"]["b"].abs().sum() == 0


def test_forward_logits_match_jax_f32():
    jp = jax_params()
    x = onehots()
    ref = jesm2.forward_logits(jp, jnp.asarray(x), heads=HEADS)
    out = esm2.forward_logits(carry(jp), torch.from_numpy(x), heads=HEADS)
    assert out.shape == (3, len(SEQS[0]), 33) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_pll_and_input_gradient_match_jax_f32():
    jp = jax_params(seed=1)
    x = onehots()
    ref = jesm2.pseudo_log_likelihood(jp, jnp.asarray(x), HEADS)
    gref = jax.grad(lambda v: jesm2.pseudo_log_likelihood(
        jp, v, HEADS).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = esm2.pseudo_log_likelihood(carry(jp), xt, HEADS)
    (g,) = torch.autograd.grad(out.sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **F32_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), **F32_TOL)
    assert np.abs(g.numpy()).max() > 1e-2  # the comparison is not of zeros


def test_pll_matches_jax_with_the_pallas_kernel_in_interpret_mode(
        monkeypatch):
    """The JAX package's flash path (its Pallas kernels, interpret mode,
    monkeypatched in as its own tests do) against the port, value and
    gradient."""
    orig = attention_pallas.flash_attention
    monkeypatch.setattr(jesm2.attention_pallas, "flash_attention",
                        lambda q, k, v, zb=8, interpret=False: orig(
                            q, k, v, zb, True))
    monkeypatch.setattr(jesm2, "ATTENTION_IMPL", "flash")
    jp = jax_params(seed=2)
    x = onehots(SEQS[:2])
    ref, gref = jax.value_and_grad(lambda v: jesm2.pseudo_log_likelihood(
        jp, v, HEADS).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = esm2.pseudo_log_likelihood(carry(jp), xt, HEADS).sum()
    (g,) = torch.autograd.grad(out, xt)
    np.testing.assert_allclose(out.item(), float(ref), **F32_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), **F32_TOL)


def test_bf16_close_to_jax():
    jp = jax_params(jnp.bfloat16)
    tp = carry(jp)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_ln"]["g"].dtype == torch.float32
    x = onehots()
    ref = jesm2.forward_logits(jp, jnp.asarray(x), heads=HEADS)
    out = esm2.forward_logits(tp, torch.from_numpy(x), heads=HEADS)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-2,
                               atol=0.15)
    assert np.abs(out.numpy() - np.asarray(ref)).mean() < 0.03
    pll_ref = jesm2.pseudo_log_likelihood(jp, jnp.asarray(x), HEADS)
    pll = esm2.pseudo_log_likelihood(tp, torch.from_numpy(x), HEADS)
    np.testing.assert_allclose(pll.numpy(), np.asarray(pll_ref), atol=0.5)


def test_embed_tokens_mask_rescale_matches_jax():
    """The token-dropout rescale reads the soft mask weight x[..., 32]."""
    jp = jax_params()
    x = onehots(SEQS[:2])
    x[0, 3] = 0.0
    x[0, 3, esm2.MASK_IDX] = 1.0          # a hard mask token
    x[1, 5] *= 0.5
    x[1, 5, esm2.MASK_IDX] = 0.5          # a soft one
    ref = jesm2.embed_tokens(jp, jnp.asarray(x))
    out = esm2.embed_tokens(carry(jp), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(out.numpy()[0, 3]).max() == 0.0


def test_remat_gives_the_same_value_and_gradient():
    tp = carry(jax_params())
    x = onehots()

    def run(remat):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = esm2.pseudo_log_likelihood(tp, xt, HEADS, remat=remat)
        return y.detach(), torch.autograd.grad(y.sum(), xt)[0]

    (y0, g0), (y1, g1) = run(False), run(True)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)


def _state_dict(rng):
    """A fair-esm layout state dict of numpy arrays (torch [out, in])."""
    D, Fd = TINY["dim"], TINY["ffn"]
    sd = {}

    def add_lin(prefix, i, o):
        sd[f"{prefix}.weight"] = rng.normal(0, 0.3, (o, i)).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, o).astype(np.float32)

    def add_ln(prefix, d):
        sd[f"{prefix}.weight"] = rng.normal(1, 0.1, d).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, d).astype(np.float32)

    sd["embed_tokens.weight"] = rng.normal(0, 0.3, (33, D)).astype(np.float32)
    for i in range(TINY["layers"]):
        p = f"layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            add_lin(f"{p}.self_attn.{name}", D, D)
        add_ln(f"{p}.self_attn_layer_norm", D)
        add_lin(f"{p}.fc1", D, Fd)
        add_lin(f"{p}.fc2", Fd, D)
        add_ln(f"{p}.final_layer_norm", D)
    add_ln("emb_layer_norm_after", D)
    add_lin("lm_head.dense", D, D)
    add_ln("lm_head.layer_norm", D)
    sd["lm_head.bias"] = rng.normal(0, 0.1, 33).astype(np.float32)
    return sd


def test_from_state_dict_matches_jax(rng):
    sd = _state_dict(rng)
    jp = jesm2.from_state_dict(sd, "tiny", dtype=jnp.float32)
    tp = esm2.from_state_dict(sd, "tiny", dtype=torch.float32, device="cpu")
    for a, b in zip(jax.tree.flatten(jp)[0], leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the converted q weight lands transposed
    np.testing.assert_array_equal(
        tp["layers"][0]["q"]["w"].numpy(),
        sd["layers.0.self_attn.q_proj.weight"].T)
    x = onehots(["ACDE"])
    ref = jesm2.forward_logits(jp, jnp.asarray(x), heads=HEADS)
    out = esm2.forward_logits(tp, torch.from_numpy(x), heads=HEADS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    tb = esm2.from_state_dict(sd, "tiny", device="cpu")  # default bf16
    assert tb["layers"][1]["fc2"]["w"].dtype == torch.bfloat16
    assert tb["lm_ln"]["b"].dtype == tb["lm_bias"].dtype == torch.float32


def test_load_torch_checkpoint_reads_a_fair_esm_file(rng, tmp_path):
    sd = _state_dict(rng)
    path = str(tmp_path / "esm2_tiny.pt")
    torch.save({"model": {f"encoder.sentence_encoder.{k}": torch.from_numpy(v)
                          for k, v in sd.items()}}, path)
    tp = esm2.load_torch_checkpoint(path, "tiny", torch.float32, "cpu")
    want = esm2.from_state_dict(sd, "tiny", torch.float32, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(tp), leaves(want)))


def test_npz_checkpoint_crosses_between_the_packages(tmp_path):
    """A file written by either package loads in the other."""
    jp = jax_params()
    jpath = str(tmp_path / "from_jax.npz")
    jesm2.save_npz_checkpoint(jpath, jp, step=7)
    tp = esm2.load_npz_checkpoint(jpath, "tiny", torch.float32, "cpu")
    want = carry(jp)
    assert set(tp) == set(want)
    for a, b in zip(leaves(tp), leaves(want)):
        assert torch.equal(a, b)
    tpath = str(tmp_path / "from_torch.npz")
    esm2.save_npz_checkpoint(tpath, tp, step=7)
    back = jesm2.load_npz_checkpoint(tpath, "tiny", jnp.float32)
    for a, b in zip(jax.tree.flatten(back)[0], jax.tree.flatten(jp)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the mixed layout of a bf16 load; a wrong architecture is refused
    tb = esm2.load_npz_checkpoint(jpath, "tiny", device="cpu")
    assert tb["embed"].dtype == torch.bfloat16
    assert tb["layers"][0]["attn_ln"]["g"].dtype == torch.float32
    esm2.CONFIGS["tiny3"] = dict(TINY, layers=3)
    with pytest.raises(ValueError, match="wrong architecture"):
        esm2.load_npz_checkpoint(jpath, "tiny3", device="cpu")
    esm2.CONFIGS["tiny-wide"] = dict(TINY, ffn=128)
    with pytest.raises(ValueError, match="expects"):
        esm2.load_npz_checkpoint(jpath, "tiny-wide", device="cpu")


def test_cast_params_keeps_norms_and_bias_f32():
    tp = carry(jax_params())
    tp = dict(tp, wt_score=torch.zeros(1), perm=torch.zeros(20, 33))
    tb = esm2.cast_params(tp, torch.bfloat16)
    jb = jesm2.cast_params(dict(jax_params(), wt_score=jnp.zeros(1),
                                perm=jnp.zeros((20, 33))), jnp.bfloat16)
    for a, b in zip(jax.tree.flatten(jb)[0], leaves(tb)):
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
    assert tb["perm"].dtype == torch.bfloat16
    assert tb["wt_score"].dtype == torch.float32


def test_lora_merge_matches_jax(rng):
    jp = jax_params()
    jl = jesm2.lora_init(jax.random.PRNGKey(3), "tiny", rank=4)
    # b starts at zero (a zero delta): fill it so the merge moves weights
    jl = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(0, 0.05, a.shape).astype(np.float32)), jl)
    ref = jesm2.lora_merge(jp, jl, alpha=8.0)
    tl = convert.esm2_from_numpy(jax.tree.map(np.asarray, jl), "cpu")
    tp = carry(jp)
    out = esm2.lora_merge(tp, tl, alpha=8.0)
    for a, b in zip(jax.tree.flatten(ref)[0], leaves(out)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    moved = out["layers"][0]["q"]["w"] - tp["layers"][0]["q"]["w"]
    assert moved.abs().max() > 1e-3
    assert out["embed"] is tp["embed"]           # untouched leaves shared
    with pytest.raises(ValueError, match="layers"):
        esm2.lora_merge(tp, {"layers": tl["layers"][:1]})
    bad = {"layers": [dict(la, q={"a": la["q"]["a"][:5], "b": la["q"]["b"]})
                      for la in tl["layers"]]}
    with pytest.raises(ValueError, match="does not match"):
        esm2.lora_merge(tp, bad)


def test_load_expert_matches_jax_and_is_zero_at_the_wild_type(tmp_path):
    """Both packages load the same npz file: equal delta scores; 0 at the
    wild type; wt_score and perm ride in params."""
    wt = "ACDEFGHIKLMNPQRS"
    path = str(tmp_path / "tiny.npz")
    jesm2.save_npz_checkpoint(path, jax_params(seed=4))
    jp, japply = jesm2.load_expert("tiny", wt, weights_path=path,
                                   dtype=jnp.float32)
    tp, tapply = esm2.load_expert("tiny", wt, weights_path=path,
                                  dtype=torch.float32, device="cpu")
    assert tp["perm"].shape == (20, 33) and tp["wt_score"].shape == (1,)
    np.testing.assert_allclose(tp["wt_score"].numpy(),
                               np.asarray(jp["wt_score"]), **F32_TOL)
    rng = np.random.default_rng(0)
    x = jcodec.ints_to_onehot(rng.integers(0, 20, (4, len(wt))))
    x[0] = jcodec.seqs_to_onehot([wt])[0]
    out = tapply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(japply(jp, jnp.asarray(
        x))), **F32_TOL)
    assert abs(float(out[0])) < 1e-4 and out[1:].abs().min() > 1e-3
    # carrying the JAX expert's tree over gives the same expert
    tc = convert.esm2_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    torch.testing.assert_close(tapply(tc, torch.from_numpy(x)), out,
                               rtol=1e-5, atol=1e-5)


def test_load_expert_without_weights():
    with pytest.raises(FileNotFoundError):
        esm2.load_expert("tiny", "ACDE", device="cpu")
    tp, tapply = esm2.load_expert("tiny", "ACDE", allow_random=True,
                                  device="cpu")
    assert tp["embed"].dtype == torch.bfloat16   # the default compute type
    x = torch.from_numpy(jcodec.seqs_to_onehot(["ACDE", "ACDF"]))
    out = tapply(tp, x)
    assert out.shape == (2,) and float(out[0]) == 0.0
    assert torch.isfinite(out).all()


def test_pll_position_dependence():
    """Rotary positions: reversing the sequence changes the score."""
    tp = carry(jax_params())
    a = esm2.pseudo_log_likelihood(tp, torch.from_numpy(onehots(
        ["ACDEFGHI"])), HEADS)
    b = esm2.pseudo_log_likelihood(tp, torch.from_numpy(onehots(
        ["IHGFEDCA"])), HEADS)
    assert abs(float(a) - float(b)) > 1e-4
