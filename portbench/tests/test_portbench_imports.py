"""No module of JAX or of the JAX package, compared by whole top-level
names; the reference imports nothing of the program; no result without a
card."""
import ast
import glob
import os
import subprocess
import sys

from portbench import harness


def test_whole_names_are_compared():
    assert harness.forbidden_modules(["ppde_tpu_torch", "ppde_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["ppde_tpu.models", "jax.numpy",
                                      "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "ppde_tpu"]


def test_a_run_loads_no_jax():
    code = ("import portbench.run, portbench.control, portbench.harness as h;"
            "from ppde_tpu_torch import runtime;"
            "from ppde_tpu_torch.samplers.protein import ppde;"
            "from ppde_tpu_torch.models import esm2;"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_and_yardstick_import_nothing_of_the_program():
    files = glob.glob(os.path.join(harness.HERE, "reference", "*.py"))
    files += glob.glob(os.path.join(harness.HERE, "experts", "*.py"))
    files.append(os.path.join(harness.HERE, "yardstick.py"))
    for f in files:
        tree = ast.parse(open(f).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("ppde_tpu_torch", "ppde_tpu",
                                               "jax"), (f, n)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present: the refusal is for hosts without "
                    "one")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "poe-potts-cnn.gfp.c1024", "--seed", str(2 ** 31 + 11),
         "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
