"""The MSA Transformer as a product-of-experts term
(``models/msa_transformer.py::load_expert``): its score and gradient
against the benchmark's plain float32 reference
(``portbench/experts/msa.py``), kernels T / T''s plain versions and the
batched column attention against the scorer's unfused compositions, the
CLI's ``potts+msa-*`` term, the refusal of unknown terms, its spans, the
memory policy and the fair-esm position table.

CPU only, float32 (the kernels' runs on the card:
``test_torch_port_kernels_cuda.py``). Tolerances: the expert and the
reference compute the same float32 function with sums in another order
(einsums against matrix products, a layer norm's own kernels), so the
scores agree to 2e-5 of the largest and the gradients to 2e-5 in relative
norm (measured on the CPU: 2.3e-6 of the largest score at both widths,
1.7e-7 and 5.5e-7 in the gradients)."""
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.experts import msa as bench_msa
from ppde_tpu_torch import codec, energy, profiling, runtime
from ppde_tpu_torch.models import cnn, esm2, msa_transformer as msat
from ppde_tpu_torch.ops import attention_fused, row_attention_fused
from ppde_tpu_torch.scripts import directed_evolution as de
from ppde_tpu_torch.scripts import seeded_protein

torch.set_num_threads(1)
WIDTHS = {"msa-tiny": dict(layers=2, embed_dim=32, attention_heads=2,
                           ffn_embed_dim=64, max_positions=256),
          "msa-S": dict(layers=4, embed_dim=256, attention_heads=8,
                        ffn_embed_dim=1024, max_positions=1024)}
SCALES = dict(vocab=33, dtype="float32", init_embed_std=0.3,
              init_pos_std=0.3, init_msa_pos_std=0.1, init_bias_std=0.1)
L = 11  # 12 columns with <cls>


def _letters(rng, n):
    return "".join(np.array(list(codec.ALPHABET))[rng.integers(0, 20, n)])


def expert_dir(tmp_path, name, rows, seed=0):
    """A directory with the benchmark's files for the ``name`` widths:
    ``msa.npz`` drawn by ``bench_msa.msa_arrays`` (every leaf random:
    biases, gains, positions) and ``rows - 1`` context rows; returns
    (dir, cfg, wt, context rows)."""
    cfg = dict(WIDTHS[name], program_name=name, rows=rows, **SCALES)
    rng = np.random.default_rng(seed)
    wt = _letters(rng, L)
    ctx = [_letters(rng, L) for _ in range(rows - 1)]
    leaves = bench_msa.msa_arrays(torch.Generator().manual_seed(seed), cfg,
                                  "cpu")
    np.savez(tmp_path / bench_msa.FILE, step=0,
             **{f"p{i}": a for i, a in enumerate(leaves)})
    with open(tmp_path / bench_msa.CONTEXT, "w") as f:
        for i, row in enumerate(ctx):
            f.write(f">row{i}\n{row}\n")
    return str(tmp_path), cfg, wt, ctx


def onehots(wt, n, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(codec.seqs_to_onehot([wt] * n))
    for i in range(n):
        for p in rng.choice(L, 3, replace=False):
            x[i, p] = torch.eye(20)[rng.integers(0, 20)]
    return x


@pytest.mark.parametrize("name,rows", [("msa-tiny", 3), ("msa-S", 4)])
def test_expert_equals_the_plain_reference(tmp_path, name, rows):
    d, cfg, wt, ctx = expert_dir(tmp_path, name, rows)
    params, apply = msat.load_expert(
        name, wt, ctx, weights_path=os.path.join(d, bench_msa.FILE),
        dtype=torch.float32, device="cpu")
    x = onehots(wt, 5)
    xg = x.clone().requires_grad_(True)
    got = apply(params, xg)
    (g,) = torch.autograd.grad(got.sum(), xg)

    score = bench_msa.reference_term(d, cfg, "cpu")
    xr = x.clone().requires_grad_(True)
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt]))
    want = score(xr, lambda t: t) - score(wt_oh, lambda t: t)
    (gr,) = torch.autograd.grad(want.sum(), xr)
    scale = float(want.detach().abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * max(scale, 1.0)
    assert float((g - gr).norm() / gr.norm()) <= 2e-5


def test_score_is_zero_at_the_wild_type(tmp_path):
    d, cfg, wt, ctx = expert_dir(tmp_path, "msa-tiny", 3)
    params, apply = msat.load_expert(
        "msa-tiny", wt, ctx, weights_path=os.path.join(d, bench_msa.FILE),
        dtype=torch.float32, device="cpu")
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt]))
    with torch.no_grad():
        assert float(apply(params, wt_oh)[0]) == 0.0
        both = apply(params, torch.cat([wt_oh, onehots(wt, 2)]))
    assert abs(float(both[0])) <= 1e-5 * float(both.abs().max())
    assert params["ctx"].shape == (2, L + 1, 32)


def test_expert_refuses_what_it_cannot_score():
    wt = "ACDEFGHIKL"
    with pytest.raises(ValueError, match="context row"):
        msat.load_expert("msa-tiny", wt, [], allow_random=True,
                         device="cpu")
    with pytest.raises(ValueError, match="context row"):
        msat.load_expert("msa-tiny", wt, ["ACDE"], allow_random=True,
                         device="cpu")
    with pytest.raises(FileNotFoundError):
        msat.load_expert("msa-tiny", wt, [wt], device="cpu")


def _proj(H, hd, seed):
    g = torch.Generator().manual_seed(seed)
    D = H * hd
    return {n: {"w": torch.randn(D, D, generator=g) / math.sqrt(D),
                "b": torch.randn(D, generator=g) * 0.1} for n in "qkvo"}


@pytest.mark.parametrize("N,R,C,H,hd", [(2, 3, 7, 2, 8), (1, 5, 12, 4, 16),
                                        (3, 2, 9, 1, 24)])
def test_plain_kernels_equal_the_unfused_compositions(N, R, C, H, hd):
    """The expert's tied row attention (plain T) and column attention (one
    batched product over kernel C's [N C H, R, hd]) against the scorer's
    ``_tied_row_attention`` and ``_column_attention``, float32; plain T'
    against autograd through plain T."""
    p = _proj(H, hd, N + C)
    g = torch.Generator().manual_seed(C)
    x = torch.randn(N, R, C, H * hd, generator=g)
    zero = torch.zeros_like(x)
    torch.testing.assert_close(msat._expert_row(p, zero, x, H),
                               msat._tied_row_attention(p, x, H),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(msat._expert_col(p, zero, x, H),
                               msat._column_attention(p, x, H),
                               rtol=1e-5, atol=1e-6)
    q, k, v, dout = (torch.randn(N, R, C, H, hd, generator=g)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = row_attention_fused.tied_row_attention(*leaves, 0.3)
    want = torch.autograd.grad(o, leaves, dout)
    got = row_attention_fused.tied_row_attention_bwd(q, k, v, dout, 0.3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # the column attention is kernel C's plain version on the CPU: one
    # batched product, no loop over chains and heads
    calls = []
    plain = attention_fused.attention_plain

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)

    attention_fused.attention_plain = counted
    try:
        msat._expert_col(p, zero, x, H)
    finally:
        attention_fused.attention_plain = plain
    assert calls == [(N * C * H, R, hd)]


def _cli_dir(tmp_path, rows=4):
    root = str(tmp_path / "weights")
    wt = "MKTAYIAKQRQISFVKSHFS"
    seeded_protein.write_protein_dir(root, "TOY", wt, seed=1)
    rng = np.random.default_rng(3)
    a2m = tmp_path / "ctx.a2m"
    with open(a2m, "w") as f:
        for i in range(rows + 2):
            f.write(f">r{i}\n{_letters(rng, len(wt))}\n")
    return root, str(a2m)


def _cli_argv(root, a2m, tmp_path, term, *extra):
    return ["--protein_weights", root, "--protein", "TOY",
            "--results_path", str(tmp_path / "results"), "--n_iters", "3",
            "--n_chains", "4", "--log_every", "3", "--nmut_threshold", "4",
            "--disable_MSA_transformer_scoring", "--device", "cpu",
            "--sampler", "PPDE", "--unsupervised_expert", term,
            "--msa_expert_context", a2m, *extra]


def test_cli_runs_potts_plus_msa_tiny(tmp_path, capsys):
    root, a2m = _cli_dir(tmp_path)
    argv = _cli_argv(root, a2m, tmp_path, "potts+msa-tiny",
                     "--allow_random_msa", "--msa_expert_rows", "4")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        run_dir = de.main(de.build_parser().parse_args(argv))
    out = capsys.readouterr().out
    assert "WT protein energy:" in out and "done" in out
    hist = np.load(run_dir / "energy_history.npy")
    assert hist.shape[1] == 4 and np.isfinite(hist).all()
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["unsupervised_expert"] == "potts+msa-tiny"


def test_cli_builds_the_msa_term_and_no_other(tmp_path):
    """The runtime's energy holds the MSA term (spans ``energy.msa``), its
    context the file's first rows - 1 rows in file order."""
    root, a2m = _cli_dir(tmp_path)
    args = de.build_parser().parse_args(_cli_argv(
        root, a2m, tmp_path, "msa-tiny", "--allow_random_msa",
        "--msa_expert_rows", "3"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        en, *_ = runtime.build_protein_energy(args, "cpu")
    assert "potts" not in en.params and en.params["tr"]["ctx"].shape[0] == 2
    from ppde_tpu_torch import io as pio
    rows = [s for _, s in pio.load_msa(a2m)]
    assert runtime.msa_context(a2m, rows[0], 3) == rows[:2]
    with pytest.raises(ValueError, match="aligned rows"):
        runtime.msa_context(a2m, rows[0], 30)
    with pytest.raises(ValueError, match="aligned rows"):
        runtime.msa_context(a2m, rows[0][:-1], 3)


@pytest.mark.parametrize("term", ["potts+anything", "potts+msa-2b",
                                  "potts+transformer-S+msa-tiny"])
def test_an_unknown_expert_term_raises(tmp_path, term):
    root, a2m = _cli_dir(tmp_path)
    with pytest.raises(ValueError, match="unsupervised_expert"):
        de.main(de.build_parser().parse_args(
            _cli_argv(root, a2m, tmp_path, term)))
    assert runtime.expert_terms("potts+msa-1b") == {
        "potts": True, "esm": None, "msa": "msa-1b", "unknown": []}


def _traced_names(tmp_path, en, x):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            out = en.energy_and_grad(en.params, x)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, {e["name"] for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_traced_energy_books_msa_spans_and_keeps_esm2s(tmp_path, remat):
    """A traced energy with the MSA term books ``energy.msa``,
    ``msa.backward``, every forward kind and the backward kinds, and no
    ESM2 name; the same energy with an ESM2 term books ESM2's names as
    before; tracing leaves the bits as they are."""
    wt = "ACDEFGHIKLMNPQRSTVWY"
    ctx = [wt[::-1], wt[1:] + wt[0]]
    ens = cnn.init_ensemble(torch.Generator().manual_seed(1), 2,
                            input_size=len(wt))
    wt_oh = torch.from_numpy(codec.seqs_to_onehot([wt]))
    tr = msat.load_expert("msa-tiny", wt, ctx, allow_random=True,
                          dtype=torch.float32, remat=remat, device="cpu")
    en = energy.protein_poe(None, ens, 1.0, wt_oh, transformer=tr)
    x = onehots(wt, 3)
    with torch.no_grad():
        off = en.energy_and_grad(en.params, x)
    on, names = _traced_names(tmp_path, en, x)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    kinds = ("embed", "norm", "qkv", "row", "col", "attn_out", "ffn", "head")
    assert {"energy", "energy.cnn", "energy.msa", "msa.backward"} <= names
    assert {f"msa.{k}" for k in kinds} <= names
    assert {f"msa.bwd.{k}" for k in kinds if k != "row"} <= names
    assert names <= profiling.SPANS
    assert not any(n.startswith("esm2") or n == "energy.esm2" for n in names)

    esm2.CONFIGS["tiny-msa-test"] = dict(layers=1, dim=16, heads=2, ffn=32)
    try:
        tr = esm2.load_expert("tiny-msa-test", wt, allow_random=True,
                              dtype=torch.float32, device="cpu")
    finally:
        del esm2.CONFIGS["tiny-msa-test"]
    en = energy.protein_poe(None, ens, 1.0, wt_oh, transformer=tr)
    _, names = _traced_names(tmp_path, en, x)
    assert {"energy.esm2", "esm2.backward", "esm2.embed",
            "esm2.bwd.head"} <= names
    assert not any(n.startswith("msa") or n == "energy.msa" for n in names)


def test_memory_policy_takes_the_fewest_pieces_without_recomputation():
    card = 85_000_000_000
    tokens = 32 * 238  # msa-1b over GFP's 32-row alignment
    assert runtime.resolve_msa_grad(0, 128, "msa-1b", tokens, card) == (
        26, False)
    assert runtime.resolve_msa_grad(0, 8, "msa-1b", tokens, card) == (
        None, False)
    assert runtime.resolve_msa_grad(0, 128, "msa-1b", tokens, None) == (
        None, False)
    assert runtime.resolve_msa_grad(16, 128, "msa-1b", tokens, card) == (
        16, False)
    assert runtime.resolve_msa_grad(-1, 128, "msa-1b", tokens, card) == (
        None, False)
    # an alignment too wide for one chain without recomputation
    assert runtime.resolve_msa_grad(0, 4, "msa-1b", 40 * tokens, card)[1]
    base, per = runtime.MSA_GRAD_MEMORY["msa-1b", False]
    assert base + per * tokens * 26 <= runtime.ESM_MEMORY_SHARE * card


def test_fair_esm_position_table_is_read_two_rows_on(tmp_path):
    """fair-esm's LearnedPositionalEmbedding (padding_idx 1) has 1,026 rows
    and reads column c at row c + 2: the loader keeps rows 2.., so that
    ``pos_embed[c]`` is that row, and the scorer's logits equal a forward
    with fair-esm's lookup."""
    from tests.test_weight_manifests import make_msa1b_state_dict

    sd = make_msa1b_state_dict()
    table = sd["embed_positions.weight"].clone()
    assert table.shape == (1026, 768)
    path = tmp_path / "msa1b.pt"
    torch.save({"args": {"arch": "msa_transformer"}, "model": sd}, path)
    params = msat.load_torch_checkpoint(str(path), torch.float32, "cpu")
    assert params["pos_embed"].shape == (1024, 768)
    torch.testing.assert_close(params["pos_embed"], table[2:])
    toks = torch.from_numpy(msat.tokenize_msa(["MKTAYI", "MRTAYI"]))[None]
    # fair-esm: positions = cumsum(non-pad mask) * mask + padding_idx
    mask = toks[0, 0].ne(msat.PAD_IDX).long()
    fair = torch.cumsum(mask, 0) * mask + msat.PAD_IDX
    assert fair.tolist() == list(range(2, 9))
    with torch.no_grad():
        got = msat.forward_logits(params, toks)
        want = msat.forward_logits(dict(params, pos_embed=table[fair]), toks)
    torch.testing.assert_close(got, want)
