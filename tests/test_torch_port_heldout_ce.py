"""The port's held-out CE tool (``python -m ppde_tpu_torch.scripts.
eval_esm_heldout_ce``) against the JAX package on the CPU.

The JAX tool itself (``tools/eval_esm_heldout_ce.py``) stops with a
TypeError before it computes anything: it calls
``family_in_wt_context(msa, wt)``, which takes ``(rows, msa_path,
wt_seq)``. So the JAX side here is what its docstring says it reproduces:
``scripts/finetune_esm.family_in_wt_context`` with its three arguments,
then ``scripts/finetune_esm.py``'s split, then
``ppde_tpu.training.esm_mlm_heldout_ce``.

Tolerances: the held-out list equal; the CE of JAX-initialised params
(``mlm-tiny``, carried across by ``convert``, the JAX masks replayed, both
in float32) within rtol 1e-5, the bound of
``test_torch_port_training.py::test_esm_mlm_heldout_ce_matches_jax``; the
tool's CEs equal to the fine-tune's before and after values bit for bit
(the same call on the same inputs).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GFP_WT
from ppde_tpu import io as jio, training as jt
from ppde_tpu.models import esm2 as jesm
from ppde_tpu_torch import convert, training
from ppde_tpu_torch.models import esm2 as pesm
from ppde_tpu_torch.scripts import eval_esm_heldout_ce as tool
from ppde_tpu_torch.scripts import finetune_esm
from scripts import finetune_esm as jft

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GFP_A2M = os.path.join(REPO, "data", "proteins", "synthetic",
                       "GFP_AEQVI_Sarkisyan2016_synth.a2m")
TINY = dict(layers=2, dim=32, heads=4, ffn=64)
jesm.CONFIGS["mlm-tiny"] = TINY
pesm.CONFIGS["mlm-tiny"] = dict(TINY)
AA_LO, AA_HI = jesm.ESM_TOK_TO_IDX["L"], jesm.ESM_TOK_TO_IDX["C"]


@pytest.fixture(scope="module")
def wt_fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("wt") / "wt.fasta"
    path.write_text(f">GFP\n{GFP_WT}\n")
    return str(path)


def jax_split(wt_fasta, val_frac, seed):
    """The held-out list of the JAX package's finetune_esm
    (scripts/finetune_esm.py:176-180)."""
    wt = jio.read_fasta(wt_fasta)[0]
    seqs = jft.family_in_wt_context(jio.load_msa(GFP_A2M), GFP_A2M, wt)
    rng = np.random.default_rng(seed + 1)
    n_val = max(1, int(round(val_frac * len(seqs))))
    vidx = set(rng.choice(len(seqs), n_val, replace=False).tolist())
    return [seqs[i] for i in sorted(vidx)]


def args_for(wt_fasta, *extra):
    return tool.build_parser().parse_args(
        ["--msa", GFP_A2M, "--wt_fasta", wt_fasta, "--device", "cpu",
         *extra])


@pytest.mark.parametrize("val_frac,seed", [(0.05, 0), (0.1, 7), (0.01, 3)])
def test_split_is_the_jax_fine_tunes(wt_fasta, val_frac, seed):
    ours = tool.heldout_split(GFP_A2M, wt_fasta, val_frac, seed)
    theirs = jax_split(wt_fasta, val_frac, seed)
    assert len(ours) == max(1, round(val_frac * 2001))
    assert ours == theirs
    assert all(len(s) == len(GFP_WT) for s in ours)


def test_flags_and_defaults():
    a = tool.build_parser().parse_args(["--msa", "m", "--wt_fasta", "w"])
    assert (a.esm_model, a.val_frac, a.seed, a.ckpt, a.device) == (
        "transformer-S", 0.05, 0, [], "cuda")
    a = tool.build_parser().parse_args(
        ["--msa", "m", "--wt_fasta", "w", "--ckpt", "a.npz", "b.pt"])
    assert a.ckpt == ["a.npz", "b.pt"]


def test_cuda_default_raises_without_a_gpu(wt_fasta):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    a = tool.build_parser().parse_args(
        ["--msa", GFP_A2M, "--wt_fasta", wt_fasta])
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(a)


def test_checkpoint_ce_matches_jax(wt_fasta, tmp_path, monkeypatch):
    """JAX-initialised mlm-tiny params written as the port's .npz: the
    tool's CE of that file equals the JAX package's CE of the params on
    the JAX split, the JAX masks replayed."""
    from test_torch_port_training import Replay, corrupt_draws, np_tree

    val_frac, seed = 0.01, 0
    p0 = jesm.init(jax.random.PRNGKey(4), "mlm-tiny", jnp.float32)
    ckpt = str(tmp_path / "tiny.npz")
    pesm.save_npz_checkpoint(ckpt, convert.esm2_from_numpy(np_tree(p0),
                                                           "cpu"))
    val = jax_split(wt_fasta, val_frac, seed)
    theirs = jt.esm_mlm_heldout_ce(p0, val, name="mlm-tiny", seed=seed,
                                   compute_dtype=jnp.float32)

    def replayed():
        q = []
        for k in jax.random.split(jax.random.PRNGKey(seed), 4):
            q += corrupt_draws(k, (len(val), len(GFP_WT)))
        return Replay(q)

    plain = training.esm_mlm_heldout_ce
    calls = []

    def float32_replayed(params, seqs, name, seed):
        calls.append((seqs, name, seed))
        return plain(params, seqs, name=name, seed=seed,
                     compute_dtype=torch.float32, draws=replayed())

    monkeypatch.setattr(training, "esm_mlm_heldout_ce", float32_replayed)
    out = tool.main(args_for(wt_fasta, "--esm_model", "mlm-tiny",
                             "--val_frac", str(val_frac), "--ckpt", ckpt))
    assert [c[1:] for c in calls] == [("mlm-tiny", seed)] * 2
    assert all(c[0] == val for c in calls)
    assert out["n_heldout"] == len(val) and out["length"] == len(GFP_WT)
    assert out["tiny.npz"] == pytest.approx(theirs, rel=1e-5)


def test_tool_ties_out_with_the_fine_tune(wt_fasta, tmp_path, monkeypatch,
                                          capsys):
    """finetune_esm (2 steps, --val_frac 0.05) and then the tool on its
    checkpoint, same --seed: the random-init CE is the fine-tune's
    "before", the checkpoint's its "after", bit for bit; the held-out
    count is the fine-tune's "(+N held out)"."""
    plain = training.esm_mlm_heldout_ce
    seen = []

    def spy(*args, **kw):
        seen.append(plain(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(training, "esm_mlm_heldout_ce", spy)
    out = str(tmp_path / "ft")
    finetune_esm.main(finetune_esm.build_parser().parse_args([
        "--msa", GFP_A2M, "--wt_fasta", wt_fasta, "--esm_model", "mlm-tiny",
        "--out", out, "--n_iters", "2", "--batch_size", "4", "--val_frac",
        "0.05", "--seed", "3", "--log_every", "1", "--device", "cpu"]))
    ft_out = capsys.readouterr().out
    before, after = seen
    got = tool.main(args_for(wt_fasta, "--esm_model", "mlm-tiny", "--seed",
                             "3", "--ckpt", f"{out}_ckpt_2.npz"))
    tool_out = capsys.readouterr().out
    assert got["random_init"] == before
    assert got["ft_ckpt_2.npz"] == after
    assert f"(+{got['n_heldout']} held out)" in ft_out
    assert f"held-out masked CE before: {before:.4f}" in ft_out
    assert f"random-init mlm-tiny: heldout CE {before:.4f}" in tool_out
    assert f"ft_ckpt_2.npz: heldout CE {after:.4f}" in tool_out
    assert before != after
