"""ops/rotary_fused.py on the CPU: the wrapper's plain path is the
composition ESM2's attention ran before the kernel (head-major copies, the q
scale, ``esm2._rotary``), bit for bit, forward and backward; the plain
backward is autograd's through it; the checks the CUDA path makes; the
launch counters. The kernels themselves are held to these on the card
(``test_torch_port_kernels_cuda.py``)."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppde_tpu_torch import profiling
from ppde_tpu_torch.models import esm2
from ppde_tpu_torch.ops import rotary_fused

DTYPES = [torch.float32, torch.bfloat16]
# (B, T, heads, hd): transformer-S / -M / -L head widths, T = 1, an odd T,
# heads as under tp
SHAPES = [(2, 7, 4, 24), (3, 5, 2, 32), (1, 1, 3, 64), (2, 9, 5, 8),
          (2, 6, 2, 16)]


def projections(B, T, heads, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, heads * hd)).astype(
        np.float32) * 2.0).to(dtype) for _ in range(3)]


def composition(q, k, v, heads):
    """What models/esm2.py's attention did between the projections and
    kernel C before the kernel."""
    B, T, D = q.shape
    hd = D // heads

    def proj(t):
        return t.reshape(B, T, heads, hd).permute(0, 2, 1, 3).contiguous()

    q = proj(q) * (1.0 / math.sqrt(hd))
    k, v = proj(k), proj(v)
    q, k = esm2._rotary(q, k)
    return q, k, v


def wrapper(q, k, v, heads):
    B, T, D = q.shape
    hd = D // heads
    cos, sin = esm2._rotary_tables(T, hd, q.dtype, q.device)
    return rotary_fused.qkv_rotary(q, k, v, cos, sin, heads,
                                   1.0 / math.sqrt(hd))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,heads,hd", SHAPES)
def test_wrapper_on_cpu_is_the_composition(dtype, B, T, heads, hd):
    """Outputs (contiguous [B, heads, T, hd]) and the gradients of a random
    cotangent equal the composition's bit for bit."""
    ins = projections(B, T, heads, hd, dtype, seed=B * T + hd)
    cot = projections(B, T, heads, hd, dtype, seed=7)
    cot = [c.reshape(B, T, heads, hd).transpose(1, 2) for c in cot]

    def run(fn):
        xs = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*xs, heads)
        grads = torch.autograd.grad(out, xs, cot)
        return out, grads

    got, got_g = run(wrapper)
    want, want_g = run(composition)
    for a, b in zip(got, want):
        assert a.shape == (B, heads, T, hd) and a.is_contiguous()
        assert torch.equal(a, b)
    for a, b in zip(got_g, want_g):
        assert a.shape == (B, T, heads * hd)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,heads,hd", SHAPES)
def test_plain_backward_is_autograd_of_the_composition(dtype, B, T, heads,
                                                       hd):
    """What the backward kernel computes (un-rotate, scale, back to [B, T,
    heads * hd]) with autograd's rounding points, bit for bit; and the
    wrapper's backward on the CPU is that plain backward."""
    ins = [t.requires_grad_(True)
           for t in projections(B, T, heads, hd, dtype, seed=hd)]
    cos, sin = esm2._rotary_tables(T, hd, dtype, torch.device("cpu"))
    scale = 1.0 / math.sqrt(hd)
    cot = [t.reshape(B, heads, T, hd)
           for t in projections(B, T, heads, hd, dtype, seed=hd + 1)]
    out = rotary_fused.qkv_rotary_plain(*ins, cos, sin, heads, scale)
    want = torch.autograd.grad(out, ins, cot)
    got = rotary_fused.qkv_rotary_bwd_plain(*cot, cos, sin, scale)
    again = rotary_fused.qkv_rotary_bwd(*cot, cos, sin, scale)
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape == (B, T, heads * hd)
        assert torch.equal(a, b) and torch.equal(c, b)


def test_counters_are_declared_at_zero_and_the_cpu_launches_nothing():
    """In a fresh process ESM2's import declares both counters at 0 (so a
    run that never reaches the kernel reports 0, not a missing name); the
    plain path counts nothing."""
    code = ("from ppde_tpu_torch import profiling\n"
            "from ppde_tpu_torch.models import esm2\n"
            "c = profiling.counters()\n"
            "print(c['qkv_rotary_fwd'], c['qkv_rotary_bwd'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["0", "0"]
    before = profiling.counters()
    q, k, v = projections(2, 5, 4, 8, torch.float32)
    wrapper(q, k, v, 4)
    after = profiling.counters()
    assert (after["qkv_rotary_fwd"], after["qkv_rotary_bwd"]) == (
        before["qkv_rotary_fwd"], before["qkv_rotary_bwd"])
    assert rotary_fused.launches_fwd == after["qkv_rotary_fwd"]
    assert rotary_fused.launches_bwd == after["qkv_rotary_bwd"]


def _tables(T, hd, dtype=torch.float32):
    return esm2._rotary_tables(T, hd, dtype, torch.device("cpu"))


@pytest.mark.parametrize("case", [
    "hd 12", "hd 72", "hd 0", "heads do not divide", "float16",
    "mixed types", "tables of another T", "shapes differ",
    "non-contiguous", "misaligned", "cotangent heads", "2-d"])
def test_check_rejects_what_the_kernels_do_not_take(case):
    """The CUDA path's checks, which run before any launch: hd odd or not
    a multiple of 8 or above 64, other types, tables that do not fit,
    non-contiguous or misaligned tensors."""
    B, T, heads, hd = 2, 5, 4, 8
    q, k, v = projections(B, T, heads, hd, torch.float32)
    cos, sin = _tables(T, hd)
    ts, h, err = (q, k, v), heads, ValueError
    if case.startswith("hd"):
        n = int(case.split()[1])
        ts = projections(B, T, 1, n, torch.float32) if n else ts
        h = 1 if n else heads
        if n:
            cos, sin = _tables(T, n)
        else:
            ts = [t[..., :0] for t in ts]
    elif case == "heads do not divide":
        h = 3
    elif case == "float16":
        ts, cos, sin = [t.half() for t in ts], cos.half(), sin.half()
        err = TypeError
    elif case == "mixed types":
        ts, err = (q, k.to(torch.bfloat16), v), TypeError
    elif case == "tables of another T":
        cos, sin = _tables(T + 1, hd)
    elif case == "shapes differ":
        ts = (q, k[:1], v)
    elif case == "non-contiguous":
        ts = [t.transpose(0, 1).contiguous().transpose(0, 1) for t in ts]
    elif case == "misaligned":
        flat = torch.zeros(q.numel() + 1)
        ts = (flat[1:].view(q.shape), k, v)
    elif case == "cotangent heads":
        ts = [t.reshape(B, T, heads, hd).transpose(1, 2).contiguous()
              for t in ts]
        h = heads + 1
    elif case == "2-d":
        ts = [t.reshape(B * T, heads * hd) for t in ts]
    with pytest.raises(err):
        rotary_fused._check(ts, cos, sin, h)


def test_check_accepts_both_layouts():
    B, T, heads, hd = 2, 5, 4, 24
    q, k, v = projections(B, T, heads, hd, torch.bfloat16)
    cos, sin = _tables(T, hd, torch.bfloat16)
    assert rotary_fused._check((q, k, v), cos, sin, heads) == (B, T, heads,
                                                               hd)
    g = [t.reshape(B, T, heads, hd).transpose(1, 2).contiguous()
         for t in (q, k, v)]
    assert rotary_fused._check(g, cos, sin, heads) == (B, T, heads, hd)
