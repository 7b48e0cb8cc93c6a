"""Each expert in a module of its own under ``portbench/experts/``: ESM2
moved there with every file and reference value as before, a toy expert
written here run end to end through the same modules, and no expert's name
left in the files that reach experts only through their modules."""
import dataclasses
import hashlib
import os
import re
import sys
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from portbench import experts, harness, proteins, reference

TINY_ESM = {"program_name": "transformer-T", "layers": 2, "embed_dim": 32,
            "attention_heads": 4, "ffn_embed_dim": 64, "vocab": 33,
            "dtype": "bfloat16", "init_embed_std": 0.1, "init_bias_std": 0.02}
TINY = {"protein": "TINY", "wt_length": 14, "n_chains": 6}
SEED = 2 ** 31 + 12345


def tiny_config(esm=None):
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "poe-potts-cnn.json"))
    return dict(cfg, esm2=esm)


def content_sha256(path: str) -> str:
    """A file's bytes; a zip's (``.npz``, ``.pt``) members' names and bytes,
    so that the time a zip records does not count."""
    h = hashlib.sha256()
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            for n in z.namelist():
                h.update(n.encode())
                h.update(z.read(n))
    else:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def directory_sha256(path: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        h.update(name.encode())
        h.update(content_sha256(os.path.join(path, name)).encode())
    return h.hexdigest()


# written by the parent's ``proteins.write`` (ESM2 inside ``proteins.py``)
# at the same configuration, traffic and seed
PARENT_DIRECTORY = {
    "potts-cnn": "676acec70a4c22acc194c0ab02a70825ce953f7bb1753921b989b2915"
                 "753cbd8",
    "esm2": "9a1d25088b014811c6768fdc63ca83cfe0a102f83d93a6cdd27a6d1e5554ced9",
}
PARENT_ESM_FILE = ("44c74bf9d77562eca0702b37c919eabfcf0986e0e3d8a2663660bea5b"
                   "c4283c3")


@pytest.mark.parametrize("kind", ["potts-cnn", "esm2"])
def test_protein_directory_is_the_parents(kind, tmp_path):
    cfg = tiny_config(TINY_ESM if kind == "esm2" else None)
    paths = proteins.write(str(tmp_path), "TINY", cfg, TINY, SEED, "cpu")
    assert directory_sha256(paths["dir"]) == PARENT_DIRECTORY[kind]
    if kind == "esm2":
        assert paths["experts"] == {
            "esm2": {"esm2.npz": os.path.join(paths["dir"], "esm2.npz")}}
        assert content_sha256(os.path.join(paths["dir"], "esm2.npz")) \
            == PARENT_ESM_FILE
    else:
        assert paths["experts"] == {}


# the parent's ``Reference`` (ESM2 through ``esm_layers`` / ``esm_heads``)
# on the directories above, at the one-hots of ``onehots()``, blocks of 4
PARENT_VALUES = {
    ("potts-cnn", "reference"): {
        "e": [-15.720892906188965, -16.370386123657227, -13.640088081359863,
              -16.61207389831543, -16.229148864746094, -13.277984619140625],
        "fit": [-0.03021170385181904, -0.0315752737224102,
                -0.022283924743533134, -0.02852453477680683,
                -0.03243815153837204, -0.027603425085544586],
        "grad_sum": 129.38871310465038, "grad_abs": 805.3172689396888},
    ("potts-cnn", "control"): {
        "e": [-15.719623565673828, -16.36922264099121, -13.63902473449707,
              -16.610065460205078, -16.227569580078125, -13.276830673217773],
        "fit": [-0.030177883803844452, -0.03156428039073944,
                -0.022285716608166695, -0.028490684926509857,
                -0.03244270384311676, -0.027593016624450684],
        "grad_sum": 129.53239696845412, "grad_abs": 805.2899713553488},
    ("esm2", "reference"): {
        "e": [-17.25348663330078, -21.874305725097656, -12.166343688964844,
              -21.313804626464844, -21.46446990966797, -18.33672332763672],
        "fit": [-0.03021170385181904, -0.0315752737224102,
                -0.022283924743533134, -0.02852453477680683,
                -0.03243815153837204, -0.027603425085544586],
        "grad_sum": -6003.4681433700025, "grad_abs": 6006.555436041206},
    ("esm2", "control"): {
        "e": [-17.336883544921875, -21.63262939453125, -12.007232666015625,
              -21.10906219482422, -22.03912353515625, -17.997589111328125],
        "fit": [-0.030177883803844452, -0.03156428039073944,
                -0.022285716608166695, -0.028490684926509857,
                -0.03244270384311676, -0.027593016624450684],
        "grad_sum": -5971.82445307821, "grad_abs": 5975.134800218046},
}


def onehots(L=14):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 20, (6, L), generator=g)
    return torch.nn.functional.one_hot(toks, 20).float()


@pytest.mark.parametrize("kind,precision", sorted(PARENT_VALUES))
def test_reference_through_the_modules_is_the_parents(kind, precision,
                                                      tmp_path):
    cfg = tiny_config(TINY_ESM if kind == "esm2" else None)
    paths = proteins.write(str(tmp_path), "TINY", cfg, TINY, SEED, "cpu")
    raw = reference.load(paths["dir"], "potts.npz", experts.of(cfg), "cpu")
    ref = reference.Reference(raw, cfg["energy_lamda"], precision=precision)
    e, fit, grad = ref.energy_and_grad(onehots(), block=4)
    e2, fit2 = ref.energy(onehots(), block=4)
    want = PARENT_VALUES[kind, precision]
    rel = 1e-6  # float32 sums in another order on another host
    assert e.tolist() == pytest.approx(want["e"], rel=rel)
    assert e2.tolist() == pytest.approx(want["e"], rel=rel)
    assert fit.tolist() == pytest.approx(want["fit"], rel=rel)
    assert fit2.tolist() == pytest.approx(want["fit"], rel=rel)
    g = grad.double()
    assert float(g.sum()) == pytest.approx(want["grad_sum"], rel=1e-5)
    assert float(g.abs().sum()) == pytest.approx(want["grad_abs"], rel=rel)


def test_esm2_is_found_by_its_key_and_its_interface_is_whole():
    assert "esm2" in experts.names()
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "poe-potts-cnn-esm2-150m.json"))
    (key, mod, settings), = experts.of(cfg)
    assert key == "esm2" and settings is cfg["esm2"]
    assert experts.of(tiny_config()) == []
    assert mod.cli_term(settings) == "transformer-M"
    assert mod.cli_args(settings, {"esm2.npz": "w.npz"}) == {
        "esm_weights": "w.npz", "allow_random_esm": False, "esm_chunk": 0}
    assert mod.REFERENCE_BLOCK == 16 and mod.SPAN_PREFIX == "esm2."
    assert set(mod.KERNELS) == {"kernel_c", "kernel_c_bwd"}


# ---------------------------------------------------------------------------
# a toy expert: a module of its own, and nothing else
# ---------------------------------------------------------------------------

TOY_MODULE = '''
"""A toy expert: sum_i x_i . w_i, w [L, 20] drawn from the seed."""
import os

import numpy as np
import torch

FILE = "toy.npz"
SPAN_PREFIX = "toy."
REFERENCE_BLOCK = 4
KERNELS = {"kernel_toy": ("portbench_toy_ops", "apply", "launches")}


def cli_term(cfg):
    return cfg["program_name"]


def cli_args(cfg, files):
    return {"toy_weights": files[FILE]}


def check_dtype(cfg):
    if cfg["dtype"] != "float32":
        raise ValueError("the toy runs in float32 only")


def forward_flops(cfg, L):
    return 2 * L * 20


def write(gen, cfg, path, wt, device):
    w = torch.randn(len(wt) * 20, generator=gen, device=device)
    out = os.path.join(path, FILE)
    np.savez(out, w=(w.reshape(len(wt), 20) * cfg["scale"]).cpu().numpy())
    return {FILE: out}


def control_round(t):
    return t.to(torch.bfloat16).float()


def reference_term(protein_dir, cfg, device):
    w = torch.from_numpy(np.load(os.path.join(protein_dir, FILE))["w"])
    w = w.to(device)

    def score(x, r):
        return (r(x) * r(w)).sum((1, 2))
    return score
'''


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's module in a directory of the experts package's path, its
    kernel wrapper in a module of its own, and the program's assembly taught
    the toy's term (the program is patched; the harness, ``proteins.py`` and
    ``reference/`` are not)."""
    from ppde_tpu_torch import runtime

    mods = tmp_path / "experts"
    mods.mkdir()
    (mods / "toy.py").write_text(TOY_MODULE)
    monkeypatch.setattr(experts, "__path__",
                        list(experts.__path__) + [str(mods)])
    ops = types.ModuleType("portbench_toy_ops")
    ops.launches = 0

    def apply(w, x):
        ops.launches += 1
        return (x * w).sum((1, 2)), w.expand_as(x)

    ops.apply = apply
    monkeypatch.setitem(sys.modules, "portbench_toy_ops", ops)
    calls = []
    build = runtime.build_protein_energy

    def build_with_toy(args, device):
        calls.append(args)
        en, *rest = build(args, device)
        w = torch.from_numpy(np.load(args.toy_weights)["w"]).to(device)
        t_wt = (en.wt_onehot * w).sum((1, 2))

        def energy_and_grad(params, x):
            e, fit, g = en.energy_and_grad(params, x)
            t, gt = ops.apply(w, x)
            return e + t - t_wt, fit, g + gt

        return (dataclasses.replace(en, energy_and_grad=energy_and_grad),
                *rest)

    monkeypatch.setattr(runtime, "build_protein_energy", build_with_toy)
    yield types.SimpleNamespace(calls=calls, ops=ops)
    sys.modules.pop("portbench.experts.toy", None)


def toy_spec():
    spec = harness.find_cell("poe-potts-cnn.gfp.c1024")
    spec["config"] = dict(spec["config"], toy={
        "program_name": "toy-1", "dtype": "float32", "scale": 0.5})
    spec["traffic"] = {"protein": "TINY", "wt_length": 24, "n_chains": 8,
                       "log_every": 5, "warm_steps": 2}
    return spec


def test_a_toy_expert_runs_through_its_module_alone(toy, tmp_path):
    spec = toy_spec()
    cfg = spec["config"]
    assert [k for k, _, _ in experts.of(cfg)] == ["toy"]

    # its file, drawn after the CNN's, beside the others
    paths = proteins.write(str(tmp_path), "TINY", cfg, spec["traffic"],
                           SEED, "cpu")
    assert os.path.isfile(paths["experts"]["toy"]["toy.npz"])

    # its reference term added to Potts and the CNN
    x = onehots(24)
    raw = reference.load(paths["dir"], "potts.npz", experts.of(cfg), "cpu")
    bare = dict(raw, experts=[])
    w = torch.from_numpy(np.load(paths["experts"]["toy"]["toy.npz"])["w"])
    wt = torch.from_numpy(reference.onehot(raw["wt"]))[None]
    e, _, g = reference.Reference(raw, 15.0).energy_and_grad(x, 4)
    e0, _, g0 = reference.Reference(bare, 15.0).energy_and_grad(x, 4)
    torch.testing.assert_close(e - e0, ((x - wt) * w).sum((1, 2)))
    torch.testing.assert_close(g - g0, w.expand_as(x))

    # a whole run: the CLI's term and arguments, the judged outputs, the
    # kernel counted
    out = harness.run("toy.cell", spec, SEED, 0.2, False,
                      torch.device("cpu"), time.perf_counter(),
                      log=lambda m: None)
    assert out["correct"], out["checks"]
    args = toy.calls[-1]
    assert args.unsupervised_expert == "potts+toy-1"
    assert args.toy_weights.endswith(os.path.join("TINY", "toy.npz"))
    assert not hasattr(args, "esm_weights")
    assert toy.ops.launches > 0

    # traced: its kernel held by the unattributed check (a CPU trace books
    # no device time to any span, so every launched kernel is listed)
    out = harness.run("toy.cell", spec, SEED, 0.2, True,
                      torch.device("cpu"), time.perf_counter(),
                      log=lambda m: None)
    assert "kernel_toy" in out["checks"]["unattributed_kernel_classes"][
        "classes"]
    assert "idle_between_steps_ms_per_step" in out["metrics"]


def test_a_toy_expert_is_counted_by_step_mfu(toy):
    cfg = toy_spec()["config"]
    run = {"config": cfg, "chains": 8, "L": 24, "energy_calls": 3,
           "trace": {"host_window_s": 2.0}}
    read = harness.reader("step_mfu_pct")
    with_toy = read(run)
    without = read(dict(run, config=dict(cfg, toy=None)))
    flops = 2 * 8 * (2 * 24 * 20) * 3
    assert with_toy - without == pytest.approx(
        100.0 * flops / 2.0 / 989e12, rel=1e-9)


def test_a_toy_expert_is_refused_in_a_type_it_cannot_serve(toy):
    cfg = toy_spec()["config"]
    cfg["toy"] = dict(cfg["toy"], dtype="bfloat16")
    with pytest.raises(ValueError, match="toy"):
        harness.cli_settings(cfg)


def test_a_toy_experts_spans_are_the_programs(toy):
    from portbench import program_spans, trace

    assert "toy." in program_spans.prefixes()
    assert trace.kernels()["kernel_toy"] == ("portbench_toy_ops", "apply",
                                             "launches")
    bare = toy.ops.apply
    with trace.spans():
        assert toy.ops.apply is not bare
    assert toy.ops.apply is bare


GENERIC = ("harness.py", "proteins.py", "reference/__init__.py", "control.py",
           "trace.py", "program_spans.py", "metrics/step_mfu_pct.py")


@pytest.mark.parametrize("name", GENERIC)
def test_no_expert_is_named_outside_its_module(name):
    with open(os.path.join(harness.HERE, name)) as f:
        text = f.read()
    assert not re.findall(r"esm|transformer|\bkernel_c\w*|attention", text,
                          re.IGNORECASE), name
