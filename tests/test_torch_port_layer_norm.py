"""ops/layer_norm_fused.py on the CPU: the wrapper's plain path is the
composition ESM2 and the MSA Transformer ran before the kernels (float32
cast, ``F.layer_norm``, the cast back), bit for bit, forward and backward;
the backward kernel's formula (``layer_norm_bwd_plain``) is autograd's; the
autograd Function's plumbing (what it keeps, which gradients it asks for,
the launches a model makes) with the kernels' launches replaced by their
plain formulas; the checks the CUDA path makes; the launch counters. The
kernels themselves are held to these on the card
(``test_torch_port_kernels_cuda.py``)."""
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ppde_tpu_torch import profiling
from ppde_tpu_torch.models import esm2
from ppde_tpu_torch.models import msa_transformer as msat
from ppde_tpu_torch.ops import layer_norm_fused as lnf

DTYPES = [torch.float32, torch.bfloat16]
# [..., D]: transformer-S / -M / msa-1b / -L widths over a few rows, a
# 4-d stream (msa-1b's [N, R, C, D]), a single row, a tiny width
SHAPES = [(3, 5, 480), (2, 7, 640), (2, 2, 3, 768), (4, 1280), (1, 32),
          (9, 32)]


def _inputs(shape, dtype, seed=0):
    """x (a shift and a spread per row, as a residual stream has), dy, and
    float32 g, b away from 1 and 0."""
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 4.0, shape[:-1] + (1,))
         + rng.uniform(-3, 3, shape[:-1] + (1,)))
    dy = rng.standard_normal(shape)
    g = 1.0 + 0.3 * rng.standard_normal(D)
    b = 0.2 * rng.standard_normal(D)
    return (torch.from_numpy(x.astype(np.float32)).to(dtype),
            torch.from_numpy(dy.astype(np.float32)).to(dtype),
            torch.from_numpy(g.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def old_composition(x, g, b, eps=1e-5):
    """What models/esm2.py's ``_layer_norm`` was before the kernels."""
    y = F.layer_norm(x.float(), x.shape[-1:], g, b, eps)
    return y.to(x.dtype)


def _grads(fn, x, g, b, dy):
    xs = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = fn(*xs)
    return y, torch.autograd.grad(y, xs, dy)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_old_composition(dtype, shape):
    """The output and the gradients of x, g and b equal the old
    composition's bit for bit."""
    x, dy, g, b = _inputs(shape, dtype, seed=shape[-1])
    got, got_g = _grads(lnf.layer_norm, x, g, b, dy)
    want, want_g = _grads(old_composition, x, g, b, dy)
    assert got.dtype == dtype and torch.equal(got, want)
    for a, w in zip(got_g, want_g):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_esm2_and_msa_norms_are_the_wrapper(dtype):
    """``esm2._layer_norm`` (which the MSA Transformer imports) is the old
    composition bit for bit on the CPU, on a contiguous stream and on the
    head's strided view of row 0."""
    assert msat._layer_norm is esm2._layer_norm
    x, _, g, b = _inputs((2, 3, 5, 32), dtype, seed=3)
    for t in (x, x[:, 0, 1:]):
        assert torch.equal(esm2._layer_norm({"g": g, "b": b}, t),
                           old_composition(t, g, b))


@pytest.mark.parametrize("affine", [False, True], ids=["dx", "dx_dg_db"])
@pytest.mark.parametrize("shape", [(3, 5, 32), (7, 480), (2, 2, 3, 64)])
def test_plain_backward_is_autograd_of_the_plain_forward_in_float64(
        shape, affine):
    """``layer_norm_bwd_plain``'s formula in float64 against autograd
    through the plain forward's function (``F.layer_norm``) in float64:
    dx, and dg, db when asked (None when not)."""
    x, dy, g, b = (t.double() for t in _inputs(shape, torch.float32,
                                                  seed=len(shape)))
    xs = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = F.layer_norm(xs[0], shape[-1:], xs[1], xs[2], 1e-5)
    want = torch.autograd.grad(y, xs, dy)
    got = lnf.layer_norm_bwd_plain(x, dy, g, affine=affine)
    torch.testing.assert_close(got[0], want[0], rtol=1e-10, atol=1e-12)
    if affine:
        torch.testing.assert_close(got[1], want[1], rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(got[2], want[2], rtol=1e-10, atol=1e-12)
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_backward_in_the_working_type_is_autograd_of_the_composition(
        dtype):
    """In float32 and bf16 the formula (float32 sums, dx rounded once to
    x's type) agrees with autograd through the old composition to float32
    rounding: the sums run in another order (at most a unit in the last
    place of dx's type, far below it in float32)."""
    x, dy, g, b = _inputs((6, 7, 640), dtype, seed=5)
    _, want = _grads(old_composition, x, g, b, dy)
    dx, dg, db = lnf.layer_norm_bwd_plain(x, dy, g, affine=True)
    got, ref = dx.float(), want[0].float()
    if dtype == torch.bfloat16:  # a bf16 unit: 2**-7 of the larger value
        assert bool(((got - ref).abs() <= 2.0 ** -7 * torch.maximum(
            got.abs(), ref.abs()) + 1e-6).all())
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dg, want[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, want[2], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the autograd Function with its launches replaced by their plain formulas
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """``layer_norm`` through ``_LayerNorm`` on CPU tensors, the kernels'
    launches replaced by the same functions in plain PyTorch (the checks
    kept, the counters counted)."""
    asked = []

    def fwd(x, g, b, eps, keep):
        D = lnf.check(x, g, b)
        xf = x.float().reshape(-1, D)
        mu = xf.mean(-1)
        rstd = torch.rsqrt((xf - mu[:, None]).square().mean(-1) + eps)
        profiling.count("layer_norm_fwd")
        return (old_composition(x, g, b, eps),
                torch.stack([mu, rstd], 1) if keep else None)

    def bwd(x, dy, g, stats, affine):
        D = lnf.check(x, g)
        asked.append(affine)
        mu, rstd = stats[:, 0, None], stats[:, 1, None]
        xh = (x.float().reshape(-1, D) - mu) * rstd
        d = dy.float().reshape(-1, D)
        gd = g * d
        dx = rstd * (gd - gd.mean(-1, keepdim=True)
                     - xh * (gd * xh).mean(-1, keepdim=True))
        profiling.count("layer_norm_bwd")
        return (dx.reshape(x.shape).to(x.dtype),
                *(((d * xh).sum(0), d.sum(0)) if affine else (None, None)))

    monkeypatch.setattr(lnf, "_fwd_cuda", fwd)
    monkeypatch.setattr(lnf, "_bwd_cuda", bwd)
    monkeypatch.setattr(lnf, "layer_norm",
                        lambda x, g, b, eps=1e-5: lnf._fused(x, g, b, eps))
    return asked


def _launches(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, (after["layer_norm_fwd"] - before["layer_norm_fwd"],
                 after["layer_norm_bwd"] - before["layer_norm_bwd"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_function_gives_the_composition_gradients(plain_launches, dtype):
    """The Function's gradients of x, g and b (asking the backward for g's
    and b's only when they require grad) agree with autograd through the
    composition; one launch each way."""
    x, dy, g, b = _inputs((4, 6, 480), dtype, seed=9)
    (got, got_g), n = _launches(lambda: _grads(lnf.layer_norm, x, g, b, dy))
    _, want_g = _grads(old_composition, x, g, b, dy)
    assert n == (1, 1) and plain_launches == [True]
    assert torch.equal(got, old_composition(x, g, b))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-4)
    for a, w in zip(got_g, want_g):
        torch.testing.assert_close(a.float(), w.float(), **tol)
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(lnf.layer_norm(xg, g, b), xg, dy)
    assert plain_launches[-1] is False
    torch.testing.assert_close(gx.float(), want_g[0].float(), **tol)


def test_function_keeps_nothing_without_autograd(plain_launches):
    """Under no_grad, or with no input that requires grad, the forward
    keeps no statistics and no backward runs."""
    x, _, g, b = _inputs((3, 32), torch.bfloat16)
    with torch.no_grad():
        y, n = _launches(lambda: lnf.layer_norm(x.requires_grad_(True), g,
                                                b))
    assert n == (1, 0) and y.grad_fn is None
    y, n = _launches(lambda: lnf.layer_norm(x.detach(), g, b))
    assert n == (1, 0) and y.grad_fn is None


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_esm2_launches_two_a_layer_and_two_in_the_head(plain_launches,
                                                       monkeypatch, remat):
    """A tiny ESM2's pseudo-log-likelihood and its input gradient: 2 x
    layers + 2 norms each way (the layers' forward twice under remat);
    the gradient equals the composition's path's."""
    monkeypatch.setitem(esm2.CONFIGS, "ln3", dict(layers=3, dim=32, heads=4,
                                                  ffn=64))
    params = esm2.init(torch.Generator().manual_seed(0), "ln3",
                       dtype=torch.float32, scale=0.2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(4, 24, (2, 9)))
    x = F.one_hot(toks, esm2.ESM_VOCAB).float()

    def pll_and_grad():
        xg = x.clone().requires_grad_(True)
        y = esm2.pseudo_log_likelihood(params, xg, 4, remat=remat)
        return y, torch.autograd.grad(y.sum(), xg)[0]

    (y, gx), n = _launches(pll_and_grad)
    assert n == (2 * 3 * (1 + remat) + 2, 2 * 3 + 2)
    assert set(plain_launches) == {False}
    monkeypatch.setattr(lnf, "layer_norm", lnf.layer_norm_plain)
    y0, gx0 = pll_and_grad()
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gx, gx0, rtol=1e-4, atol=1e-5)


def test_msa_expert_launches_three_a_layer_and_three_more(plain_launches):
    """An msa-tiny expert's term and its gradient over 3 chains: 3 x layers
    + 3 norms each way (row 0's embedding norm, the head's two); the
    context's norm runs once, at load."""
    rng = np.random.default_rng(1)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    wt = "".join(letters[rng.integers(0, 20, 12)])
    ctx = ["".join(letters[rng.integers(0, 20, 12)]) for _ in range(3)]
    (params, apply_fn), n_load = _launches(lambda: msat.load_expert(
        "msa-tiny", wt, ctx, allow_random=True, dtype=torch.float32,
        device="cpu"))
    layers = msat.CONFIGS["msa-tiny"]["layers"]
    assert n_load == (1 + 3 * layers + 3, 0)
    x = F.one_hot(torch.from_numpy(rng.integers(0, 20, (3, 12))), 20).float()

    def grad():
        xg = x.clone().requires_grad_(True)
        return torch.autograd.grad(apply_fn(params, xg).sum(), xg)[0]

    _, n = _launches(grad)
    assert n == (3 * layers + 3, 3 * layers + 3)


def test_finetune_asks_for_g_and_b_gradients(plain_launches):
    """A step of ``train_esm_mlm`` (every leaf trained) asks each norm's
    backward for g's and b's gradients; with LoRA adapters (the norms
    frozen) it asks for none, and the first norm, whose input does not
    require grad, runs no backward."""
    from ppde_tpu_torch import training

    esm2.CONFIGS["ln2"] = dict(layers=2, dim=32, heads=4, ffn=64)
    try:
        seqs = ["".join(np.random.default_rng(s).choice(
            list("ACDEFGHIKLMNPQRSTVWY"), 10)) for s in range(6)]
        kw = dict(n_iters=1, batch_size=4, log_every=1, quiet=True,
                  compute_dtype=torch.float32, device="cpu")
        _, n = _launches(lambda: training.train_esm_mlm(seqs, "ln2", **kw))
        assert n == (2 * 2 + 2, 2 * 2 + 2)
        assert set(plain_launches) == {True}
        plain_launches.clear()
        _, n = _launches(lambda: training.train_esm_mlm(
            seqs, "ln2", lora_rank=2, **kw))
        assert n == (2 * 2 + 2, 2 * 2 + 2 - 1)
        assert set(plain_launches) == {False}
    finally:
        del esm2.CONFIGS["ln2"]


# ---------------------------------------------------------------------------
# the checks, the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "float16", "float64", "bf16 D 12", "f32 D 6", "bf16 D 4104",
    "f32 D 2052", "D 0", "0-d", "g bf16", "b float64", "g of another D",
    "g on another device", "non-contiguous", "misaligned"])
def test_check_rejects_what_the_kernels_do_not_take(case):
    """The CUDA path's checks, which run before any launch (metadata only):
    types other than float32 and bf16 (and g, b not float32), D not a
    whole number of 16-byte vectors or past the widest row, g and b that do
    not fit or lie elsewhere, x not contiguous or not on a 16-byte
    boundary."""
    x, _, g, b = _inputs((4, 32), torch.bfloat16)
    err = ValueError
    if case in ("float16", "float64"):
        x, err = x.to(getattr(torch, case)), TypeError
    elif case.startswith(("bf16 D", "f32 D")):
        D = int(case.split()[-1])
        dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
        x, _, g, b = _inputs((2, D), dt)
    elif case == "D 0":
        x, g, b = x[:, :0], g[:0], b[:0]
    elif case == "0-d":
        x = x[0, 0]
    elif case == "g bf16":
        g, err = g.to(torch.bfloat16), TypeError
    elif case == "b float64":
        b, err = b.double(), TypeError
    elif case == "g of another D":
        g = torch.ones(40)
    elif case == "g on another device":
        g = torch.ones(32, device="meta")
    elif case == "non-contiguous":
        x = x.t().contiguous().t()
    elif case == "misaligned":
        x = torch.zeros(4 * 32 + 1, dtype=torch.bfloat16)[1:].view(4, 32)
    with pytest.raises(err):
        lnf.check(x, g, b)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 480),
                                     (torch.bfloat16, 4096),
                                     (torch.float32, 1280),
                                     (torch.float32, 2048),
                                     (torch.bfloat16, 8)])
def test_check_accepts_the_models_widths(dtype, D):
    x, _, g, b = _inputs((3, D), dtype)
    assert lnf.check(x, g, b) == D
    assert lnf.check(x, g) == D


def test_counters_are_declared_at_zero_and_the_cpu_launches_nothing():
    """In a fresh process ESM2's import declares both counters at 0 (so a
    run that never reaches the kernels reports 0, not a missing name); the
    plain path counts nothing."""
    code = ("from ppde_tpu_torch import profiling\n"
            "from ppde_tpu_torch.models import esm2\n"
            "c = profiling.counters()\n"
            "print(c['layer_norm_fwd'], c['layer_norm_bwd'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["0", "0"]
    x, dy, g, b = _inputs((3, 32), torch.bfloat16)
    _, n = _launches(lambda: _grads(lnf.layer_norm, x, g, b, dy))
    assert n == (0, 0)
    c = profiling.counters()
    assert lnf.launches_fwd == c["layer_norm_fwd"]
    assert lnf.launches_bwd == c["layer_norm_bwd"]
