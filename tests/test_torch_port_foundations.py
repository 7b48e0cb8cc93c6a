"""ppde_tpu_torch foundations against ppde_tpu: codec, utils, layers,
conversion, the kernel build's import behaviour, and the import rule (the
port and chip_smoke.py import neither JAX nor the JAX package)."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu import codec as jcodec, utils as jutils
from ppde_tpu.models import cnn as jcnn, layers as jlayers
from ppde_tpu_torch import codec, convert, utils
from ppde_tpu_torch.models import cnn, layers
from ppde_tpu_torch.ops import _build, cnn_fused, potts_fused

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(ROOT, "ppde_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    """No `import jax`, `from jax`, nor any module of ppde_tpu (other than
    ppde_tpu_torch) in the port or in chip_smoke.py."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "ppde_tpu"), (
                f"{path}:{node.lineno} imports {name}")
    src = open(path).read().replace("ppde_tpu_torch", "")
    assert "ppde_tpu." not in src.replace("ppde_tpu/", ""), path


def test_codec_matches_jax_package():
    assert codec.AA_TO_INT == jcodec.AA_TO_INT
    assert codec.ALPHABET == jcodec.ALPHABET
    seqs = ["ACDKW", "YVTSA", "MMMM"]
    np.testing.assert_array_equal(codec.seqs_to_onehot(seqs),
                                  jcodec.seqs_to_onehot(seqs))
    np.testing.assert_array_equal(codec.seqs_to_ints(seqs),
                                  jcodec.seqs_to_ints(seqs))
    assert codec.mutation_names("ACDKW", "ACEKW") == \
        jcodec.mutation_names("ACDKW", "ACEKW")


def test_utils_match_jax_package(rng):
    x = codec.ints_to_onehot(rng.integers(0, 20, (6, 11)))
    wt = x[0]
    np.testing.assert_array_equal(
        utils.mut_distance(torch.from_numpy(x), torch.from_numpy(wt)).numpy(),
        np.asarray(jutils.mut_distance(jnp.asarray(x), jnp.asarray(wt))))
    np.testing.assert_array_equal(
        utils.position_window_mask(11, 20, 2, 7).numpy(),
        np.asarray(jutils.position_window_mask(11, 20, 2, 7)))
    assert utils.NEG_INF == jutils.NEG_INF  # finite: softmax of masked rows


def test_resolve_device():
    assert utils.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert utils.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            utils.resolve_device("cuda")


def test_layers_match_jax_package(rng):
    p = jlayers.init_conv1d(jax.random.PRNGKey(0), 5, 20, 12)
    q = jlayers.init_linear(jax.random.PRNGKey(1), 12, 7)
    x = rng.standard_normal((3, 17, 20)).astype(np.float32)
    tp = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tq = convert.cnn_ensemble_from_numpy(jax.tree.map(np.asarray, q), "cpu")
    y = layers.conv1d(tp, torch.from_numpy(x))
    # f32 sums in another order
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jlayers.conv1d(p, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.linear(tq, y).numpy(),
        np.asarray(jlayers.linear(q, jlayers.conv1d(p, jnp.asarray(x)))),
        rtol=1e-5, atol=1e-5)


def test_init_layout_and_bounds():
    g = torch.Generator().manual_seed(0)
    ens = cnn.init_ensemble(g, 3, input_size=16)
    ref = jax.tree.map(np.shape, jcnn.init_ensemble(jax.random.PRNGKey(0), 3,
                                                    input_size=16))
    assert jax.tree.map(lambda t: tuple(t.shape), ens) == ref
    # uniform +-1/sqrt(fan_in), like layers.py:84-118
    assert ens["encoder"]["w"].abs().max() <= 1 / np.sqrt(5 * 20)
    assert ens["embed"]["w"].abs().max() <= 1 / np.sqrt(16)
    assert ens["decoder"]["b"].abs().max() <= 1 / np.sqrt(32)
    stacked = layers.stack_params([{"a": {"w": torch.ones(2)}}] * 3)
    assert stacked["a"]["w"].shape == (3, 2)


def test_convert_keeps_bf16():
    a = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))
    t = convert.cnn_ensemble_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_kernels_are_not_built_at_import():
    """Importing the wrappers builds nothing (this host has no nvcc); the
    CPU path runs the plain versions and counts no launch."""
    assert sorted(_build.sources()) == ["cnn_ensemble", "flash_attention",
                                        "layer_norm", "potts_energy",
                                        "qkv_rotary", "row_attention"]
    assert not _build._libs
    n_a, n_b = potts_fused.launches, cnn_fused.launches
    W = torch.eye(128)
    H, g = potts_fused.energy_and_grad(W, torch.zeros(128),
                                       torch.ones((2, 128)))
    torch.testing.assert_close(H, torch.full((2,), 64.0))
    ens = cnn.init_ensemble(torch.Generator().manual_seed(0), 3,
                            input_size=8)
    x = torch.nn.functional.one_hot(torch.arange(8) % 20, 20).float()[None]
    fit, dx = cnn_fused.ensemble_apply_and_grad(ens, x)
    assert fit.shape == (1,) and dx.shape == x.shape
    assert (potts_fused.launches, cnn_fused.launches) == (n_a, n_b)
