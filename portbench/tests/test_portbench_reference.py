"""The plain reference against the program's plain CPU path at tiny sizes,
and the control's roundings."""
import numpy as np
import pytest
import torch

from portbench import experts, harness, reference
from portbench.experts import esm2 as esm2_expert

TINY_ESM = {"program_name": "transformer-T", "layers": 2, "embed_dim": 32,
            "attention_heads": 4, "ffn_embed_dim": 64, "vocab": 33,
            "dtype": "bfloat16", "init_embed_std": 0.1, "init_bias_std": 0.02}


def tiny_config(esm=None):
    cfg = harness.load_json(
        f"{harness.HERE}/configs/poe-potts-cnn.json")
    return dict(cfg, esm2=esm)


def random_onehots(n, L, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 20, (n, L), generator=g)
    return torch.nn.functional.one_hot(toks, 20).float()


def test_esm_leaf_order_is_the_programs():
    from ppde_tpu_torch.models import esm2

    cfg = harness.load_json(
        f"{harness.HERE}/configs/poe-potts-cnn-esm2-150m.json")["esm2"]
    want = [tuple(s) for s in esm2._flatten(esm2._shapes("transformer-M"))]
    assert [s for _, s in esm2_expert.esm_leaves(cfg)] == want


def test_reference_esm_against_the_program_in_float32(monkeypatch, tmp_path):
    from ppde_tpu_torch.models import esm2

    monkeypatch.setitem(esm2.CONFIGS, "transformer-T",
                        dict(layers=2, dim=32, heads=4, ffn=64))
    leaves = esm2_expert.esm_arrays(torch.Generator().manual_seed(3),
                                    TINY_ESM, "cpu")
    path = str(tmp_path / "esm.npz")
    np.savez(path, step=0, **{f"p{i}": a for i, a in enumerate(leaves)})
    prog = esm2.load_npz_checkpoint(path, "transformer-T", torch.float32,
                                    "cpu")
    ref = esm2_expert.esm_tree([torch.from_numpy(a) for a in leaves], 2)
    x = random_onehots(3, 9, 0) @ esm2_expert.esm_perm("cpu")
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    pa = esm2.pseudo_log_likelihood(prog, xa, heads=4)
    pb = esm2_expert.esm_pll(ref, xb, 4, lambda t: t)
    torch.testing.assert_close(pb, pa, rtol=1e-5, atol=1e-4)
    (ga,) = torch.autograd.grad(pa.sum(), xa)
    (gb,) = torch.autograd.grad(pb.sum(), xb)
    torch.testing.assert_close(gb, ga, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("esm", [None, TINY_ESM], ids=["potts-cnn",
                                                       "potts-cnn-esm2"])
def test_reference_energy_against_the_programs_assembly(esm, monkeypatch,
                                                        tmp_path):
    """The energy the CLI assembles from a protein directory written from
    the seed (the program's plain CPU path: ESM2 in bf16 as served, the
    rest in float32) against the reference over the same files."""
    from ppde_tpu_torch.models import esm2

    monkeypatch.setitem(esm2.CONFIGS, "transformer-T",
                        dict(layers=2, dim=32, heads=4, ffn=64))
    cfg = tiny_config(esm)
    traffic = {"protein": "TINY", "wt_length": 14, "n_chains": 6}
    dev = torch.device("cpu")
    paths, en, pop = harness.build(cfg, traffic, 12345, str(tmp_path), dev)
    x = random_onehots(6, 14, 1)
    e, fit, grad = en.energy_and_grad(en.params, x)
    raw = reference.load(paths["dir"], "potts.npz", experts.of(cfg), dev)
    ref = reference.Reference(raw, cfg["energy_lamda"])
    re, rfit, rgrad = ref.energy_and_grad(x, block=4)
    torch.testing.assert_close(rfit, fit, rtol=1e-5, atol=1e-5)
    if esm is None:
        torch.testing.assert_close(re, e, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(rgrad, grad, rtol=1e-5, atol=1e-4)
    else:
        # ESM2 is served in bf16: the gaps are bf16's
        torch.testing.assert_close(re, e, rtol=2e-2, atol=2e-2)
        assert (rgrad - grad).norm() / rgrad.norm() < 2e-2
    # the wild type scores 0 in both delta terms: its energy is lam * fit
    e_wt, fit_wt = ref.energy(pop[:1], block=4)
    torch.testing.assert_close(e_wt, cfg["energy_lamda"] * fit_wt)


def test_control_roundings():
    one = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0])
    assert reference.round_tf32(one).tolist() == [1.0 + 2.0 ** -10, 1.0,
                                                  -3.0]
    t = torch.tensor([448.0, 1.0, 0.3])
    q = esm2_expert.round_fp8(t)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] != 0.3
    assert abs(q[2] - 0.3) <= 0.3 * 2.0 ** -4
    # straight through: the gradient of a rounded operand is the identity
    p = reference.Precision("control")
    x = torch.tensor([0.3, 0.7], requires_grad=True)
    (g,) = torch.autograd.grad(p.rounding(esm2_expert.control_round)(x)
                               .sum(), x)
    assert g.tolist() == [1.0, 1.0]
