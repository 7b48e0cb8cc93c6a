"""ppde_tpu_torch.models.esm2 against ppde_tpu.models.esm2 at the large
experts' real widths: transformer-M (dim 640, 20 heads of 32, ffn 2560) and
transformer-L (dim 1280, 20 heads of 64, ffn 5120), cut to 2 layers, the
weights made by the JAX package's seeded init and carried over through
convert.esm2_from_numpy, on short sequences (T <= 24).

Tolerance: float32 on the CPU at rtol 1e-4 / atol 1e-4, the bound of
test_torch_port_esm2.py (sums in another order than XLA's). The init's
scale is 0.3 * sqrt(32 / dim): the tiny test's 0.3 at dim 32, so that the
activations keep that test's size at these widths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, energy as jenergy
from ppde_tpu.models import cnn as jcnn, esm2 as jesm2, potts as jpotts
from ppde_tpu.ops import attention_pallas
from ppde_tpu_torch import convert, energy
from ppde_tpu_torch.models import esm2, potts

torch.set_num_threads(1)
LAYERS = 2
WIDTHS = {"transformer-M": 32, "transformer-L": 64}   # the head widths
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# every JAX call takes [2, 24, 33] one-hots and one seeded init a config,
# so that the eager op compiles of the first tests serve the rest
SEQS = ["ACDEFGHIKLMNPQRSTVWYACDE", "WYACDEFGHIKLMNPQRSTVACDE"]
WT = SEQS[0]
_PARAMS = {}


@pytest.fixture(params=sorted(WIDTHS), ids=["M", "L"])
def name(request):
    """The config cut to LAYERS layers, under its own name in both
    packages."""
    cut = f"{request.param}-{LAYERS}"
    cfg = dict(esm2.CONFIGS[request.param], layers=LAYERS)
    assert cfg["dim"] // cfg["heads"] == WIDTHS[request.param]
    esm2.CONFIGS[cut] = jesm2.CONFIGS[cut] = cfg
    yield cut
    del esm2.CONFIGS[cut], jesm2.CONFIGS[cut]


def heads(name):
    return esm2.CONFIGS[name]["heads"]


def jax_params(name):
    """The JAX package's seeded init of ``name``, made once."""
    if name not in _PARAMS:
        scale = 0.3 * (32 / esm2.CONFIGS[name]["dim"]) ** 0.5
        _PARAMS[name] = jesm2.init(jax.random.PRNGKey(0), name,
                                   dtype=jnp.float32, scale=scale)
    return _PARAMS[name]


def carry(jparams):
    return convert.esm2_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def onehots(seqs=SEQS):
    return np.stack([jesm2.seq_to_esm_onehot(s) for s in seqs])


def test_forward_logits_match_jax(name):
    jp = jax_params(name)
    x = onehots()
    ref = jesm2.forward_logits(jp, jnp.asarray(x), heads=heads(name))
    out = esm2.forward_logits(carry(jp), torch.from_numpy(x), heads(name))
    assert out.shape == (2, len(SEQS[0]), 33)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    assert np.abs(out.numpy()).max() > 0.5   # not a comparison of zeros


def test_pll_and_input_gradient_match_jax(name):
    jp = jax_params(name)
    x = onehots()
    ref, gref = jax.value_and_grad(lambda v: jesm2.pseudo_log_likelihood(
        jp, v, heads(name)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = esm2.pseudo_log_likelihood(carry(jp), xt, heads(name))
    (g,) = torch.autograd.grad(out.sum(), xt)
    np.testing.assert_allclose(out.sum().item(), float(ref), **F32_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), **F32_TOL)
    assert np.abs(g.numpy()).max() > 1e-2


def test_pll_matches_jax_through_the_pallas_kernel_in_interpret_mode(
        name, monkeypatch):
    """The JAX package's flash path (its Pallas kernels in interpret mode,
    monkeypatched in as its own tests do) at hd 32 and 64 against the
    port, value and gradient."""
    orig = attention_pallas.flash_attention
    monkeypatch.setattr(jesm2.attention_pallas, "flash_attention",
                        lambda q, k, v, zb=8, interpret=False: orig(
                            q, k, v, zb, True))
    monkeypatch.setattr(jesm2, "ATTENTION_IMPL", "flash")
    jp = jax_params(name)
    x = onehots()
    ref, gref = jax.value_and_grad(lambda v: jesm2.pseudo_log_likelihood(
        jp, v, heads(name)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = esm2.pseudo_log_likelihood(carry(jp), xt, heads(name)).sum()
    (g,) = torch.autograd.grad(out, xt)
    np.testing.assert_allclose(out.item(), float(ref), **F32_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), **F32_TOL)


def test_protein_poe_with_the_expert_matches_jax(name, tmp_path):
    """``potts+`` the expert: both packages load one npz file (written by
    the port) as the expert, energy and gradient of the product of
    experts."""
    path = str(tmp_path / "expert.npz")
    esm2.save_npz_checkpoint(path, carry(jax_params(name)))
    jtr = jesm2.load_expert(name, WT, weights_path=path, dtype=jnp.float32)
    ttr = esm2.load_expert(name, WT, weights_path=path, dtype=torch.float32,
                           device="cpu")
    je = jcnn.init_ensemble(jax.random.PRNGKey(0), 3, input_size=len(WT))
    te = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, je), "cpu")
    wt_oh = jcodec.seqs_to_onehot([WT])
    jen = jenergy.protein_poe(jpotts.synthetic(WT, seed=3), je, 1.0,
                              jnp.asarray(wt_oh), transformer=jtr)
    ten = energy.protein_poe(potts.synthetic(WT, seed=3, device="cpu"), te,
                             1.0, torch.from_numpy(wt_oh), transformer=ttr)
    x = jcodec.seqs_to_onehot(SEQS)  # the wild type and a variant
    with torch.no_grad():
        e, fit, grad = ten.energy_and_grad(ten.params, torch.from_numpy(x))
    ej, fj, gj = jen.energy_and_grad(jen.params, jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), **F32_TOL)
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), **F32_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(gj), **F32_TOL)
    tr_only = ttr[1](ttr[0], torch.from_numpy(x))
    assert abs(float(tr_only[0])) < 1e-4 and abs(float(tr_only[1])) > 1e-2


def test_remat_gives_the_same_value_and_gradient(name):
    tp = carry(jax_params(name))
    x = onehots()

    def run(remat):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = esm2.pseudo_log_likelihood(tp, xt, heads(name), remat=remat)
        return y.detach(), torch.autograd.grad(y.sum(), xt)[0]

    (y0, g0), (y1, g1) = run(False), run(True)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)


def test_lora_merge_matches_jax(name):
    jp = jax_params(name)
    jl = jesm2.lora_init(jax.random.PRNGKey(6), name, rank=8)
    # b starts at zero (a zero delta): fill it so the merge moves weights
    rng = np.random.default_rng(7)
    jl = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(0, 0.01, a.shape).astype(np.float32)), jl)
    ref = jesm2.lora_merge(jp, jl, alpha=16.0)
    out = esm2.lora_merge(carry(jp), carry(jl), alpha=16.0)
    for a, b in zip(jax.tree.flatten(ref)[0], esm2._flatten(out)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32_TOL)
    x = onehots()
    np.testing.assert_allclose(
        esm2.pseudo_log_likelihood(out, torch.from_numpy(x), heads(name))
        .numpy(), np.asarray(jesm2.pseudo_log_likelihood(
            ref, jnp.asarray(x), heads(name))), **F32_TOL)


def _state_dict(name, rng):
    """A fair-esm layout state dict of numpy arrays (torch [out, in]) of
    the config's shapes."""
    cfg = esm2.CONFIGS[name]
    D, Fd = cfg["dim"], cfg["ffn"]
    s = 0.3 * (32 / D) ** 0.5
    sd = {}

    def add_lin(prefix, i, o):
        sd[f"{prefix}.weight"] = rng.normal(0, s, (o, i)).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, o).astype(np.float32)

    def add_ln(prefix, d):
        sd[f"{prefix}.weight"] = rng.normal(1, 0.1, d).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, d).astype(np.float32)

    sd["embed_tokens.weight"] = rng.normal(0, s, (33, D)).astype(np.float32)
    for i in range(cfg["layers"]):
        p = f"layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            add_lin(f"{p}.self_attn.{proj}", D, D)
        add_ln(f"{p}.self_attn_layer_norm", D)
        add_lin(f"{p}.fc1", D, Fd)
        add_lin(f"{p}.fc2", Fd, D)
        add_ln(f"{p}.final_layer_norm", D)
    add_ln("emb_layer_norm_after", D)
    add_lin("lm_head.dense", D, D)
    add_ln("lm_head.layer_norm", D)
    sd["lm_head.bias"] = rng.normal(0, 0.1, 33).astype(np.float32)
    return sd


def test_fair_esm_state_dict_loads_equal(name, rng):
    sd = _state_dict(name, rng)
    jp = jesm2.from_state_dict(sd, name, dtype=jnp.float32)
    tp = esm2.from_state_dict(sd, name, dtype=torch.float32, device="cpu")
    jflat = jax.tree.flatten(jp)[0]
    tflat = esm2._flatten(tp)
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = onehots()
    np.testing.assert_allclose(
        esm2.forward_logits(tp, torch.from_numpy(x), heads(name)).numpy(),
        np.asarray(jesm2.forward_logits(jp, jnp.asarray(x),
                                        heads=heads(name))), **F32_TOL)
