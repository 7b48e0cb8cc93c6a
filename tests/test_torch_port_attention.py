"""ppde_tpu_torch.ops.attention_fused against ppde_tpu.ops.attention_pallas.

On the CPU the port's wrapper runs the plain versions of kernels C and C';
the JAX package's Pallas kernels run in interpret mode. Inputs are made with
numpy from a seed and handed to both. Tolerances are those of the JAX
package's own tests (tests/test_attention_pallas.py): float32 forward rtol
1e-5 / atol 1e-5 and gradients rtol 1e-4 / atol 1e-5 (sums in another
order); bfloat16 forward 2e-2 and gradients 3e-2 (one rounding of the
weights and of ds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppde_tpu.ops import attention_pallas
from ppde_tpu_torch.ops import attention_fused

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def make(Z, T, hd, dtype, seed=0, n=3, scale=0.5):
    """n arrays [Z, T, hd] for both packages, rounded to dtype alike."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((Z, T, hd)) * scale).astype(np.float32)
            for _ in range(n)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("Z,T,hd,dtype", [
    (4, 16, 8, "float32"),
    (6, 237, 24, "float32"),     # ESM2-S head shape (odd T)
    (8, 64, 32, "bfloat16"),
    (3, 33, 16, "bfloat16"),
])
def test_forward_matches_jax_kernel(Z, T, hd, dtype):
    (jq, jk, jv), (q, k, v) = make(Z, T, hd, dtype)
    ref = attention_pallas.flash_attention(jq, jk, jv, 8, True)
    out = attention_fused.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(f32(out), f32(ref), **FWD_TOL[dtype])
    # on a CPU tensor the wrapper is its plain version
    assert torch.equal(out, attention_fused.attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_kernel(dtype):
    """autograd through the port's plain version against jax.grad through
    the Pallas kernels' custom VJP (interpret mode)."""
    Z, T, hd = 4, 33, 16
    (jq, jk, jv), (q, k, v) = make(Z, T, hd, dtype, seed=1)
    (jw,), (w,) = make(Z, T, hd, dtype, seed=9, n=1, scale=1.0)

    def loss_flash(q_, k_, v_):
        return jnp.sum(attention_pallas.flash_attention(
            q_, k_, v_, 8, True).astype(jnp.float32) * jw.astype(jnp.float32))

    g_ref = jax.grad(loss_flash, argnums=(0, 1, 2))(jq, jk, jv)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    loss = (attention_fused.flash_attention(*qs).float() * w.float()).sum()
    g = torch.autograd.grad(loss, qs)
    for a, b, name in zip(g, g_ref, "qkv"):
        assert a.dtype == q.dtype
        np.testing.assert_allclose(f32(a), f32(b), err_msg=f"d{name}",
                                   **BWD_TOL[dtype])


@pytest.mark.parametrize("Z,T,hd,dtype", [
    (4, 33, 16, "float32"),
    (4, 33, 16, "bfloat16"),
    (2, 237, 24, "float32"),
    (3, 64, 32, "bfloat16"),
])
def test_bwd_plain_matches_jax_bwd_kernel(Z, T, hd, dtype):
    """attention_bwd_plain (the specification of kernel C') against the
    Pallas backward kernel in interpret mode."""
    (jq, jk, jv, jd), (q, k, v, d) = make(Z, T, hd, dtype, seed=2, n=4)
    ref = attention_pallas._bwd_call(jq, jk, jv, jd, 8, True)
    got = attention_fused.flash_attention_bwd(q, k, v, d)
    for a, b, name in zip(got, ref, "qkv"):
        assert a.dtype == q.dtype and a.shape == q.shape
        np.testing.assert_allclose(f32(a), f32(b), err_msg=f"d{name}",
                                   **BWD_TOL[dtype])


def einsum_attention(q, k, v):
    """The JAX package's default ESM2 attention (ppde_tpu/models/esm2.py,
    ATTENTION_IMPL unset): einsum scores in the input type, softmax in
    float32, weights cast back, einsum with v."""
    scores = jnp.einsum("zqd,zkd->zqk", q, k)
    w = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("zqk,zkd->zqd", w, v)


# proteins longer than the kernels' old limit of T = 512 (the key-tiled
# kernels on the card): T = 600 and ESM2's trained context T = 1024
@pytest.mark.parametrize("Z,T,hd,dtype", [
    (2, 600, 8, "float32"),
    (2, 600, 24, "bfloat16"),
    (1, 1024, 24, "float32"),
    (1, 1024, 8, "bfloat16"),
])
def test_long_sequences_match_jax(Z, T, hd, dtype):
    """Forward and gradients at T = 600 and 1024 against the Pallas kernels
    (interpret mode) and the einsum path. The einsum path rounds its scores
    to the input type, so in bfloat16 it is held to the gradients' bound."""
    (jq, jk, jv), (q, k, v) = make(Z, T, hd, dtype, seed=T + hd)
    (jw,), (w,) = make(Z, T, hd, dtype, seed=5, n=1, scale=1.0)
    out = attention_fused.flash_attention(q, k, v)
    for name, fn in (("flash", lambda *a: attention_pallas.flash_attention(
            *a, 8, True)), ("einsum", einsum_attention)):
        tol = FWD_TOL[dtype] if name == "flash" else BWD_TOL[dtype]
        np.testing.assert_allclose(f32(out), f32(fn(jq, jk, jv)),
                                   err_msg=name, **tol)

        def loss(q_, k_, v_, fn=fn):
            return jnp.sum(fn(q_, k_, v_).astype(jnp.float32)
                           * jw.astype(jnp.float32))

        g_ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
        qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g = torch.autograd.grad(
            (attention_fused.flash_attention(*qs).float() * w.float()).sum(),
            qs)
        for a, b, n in zip(g, g_ref, "qkv"):
            np.testing.assert_allclose(f32(a), f32(b),
                                       err_msg=f"{name} d{n}",
                                       **BWD_TOL[dtype])
    # kernel C' specification at this length against the Pallas backward
    ref = attention_pallas._bwd_call(jq, jk, jv, jw, 8, True)
    got = attention_fused.flash_attention_bwd(q, k, v, w)
    for a, b, n in zip(got, ref, "qkv"):
        np.testing.assert_allclose(f32(a), f32(b), err_msg=f"bwd d{n}",
                                   **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_autograd_of_plain(dtype):
    """The written-out identities agree with autograd through the forward
    (in bfloat16 the two round at different places: the JAX bound)."""
    _, (q, k, v, d) = make(3, 21, 8, dtype, seed=3, n=4)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_fused.attention_plain(*qs), qs, d)
    got = attention_fused.attention_bwd_plain(q, k, v, d)
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **BWD_TOL[dtype])


def test_plain_masks_nothing_and_scales_nothing():
    """q is scaled by the caller and there is no mask: one key gives v back,
    equal keys give the mean of v."""
    _, (q, k, v) = make(2, 1, 8, "float32")
    torch.testing.assert_close(attention_fused.flash_attention(q, k, v), v)
    _, (q, k, v) = make(2, 5, 8, "float32", seed=4)
    k = k[:, :1].expand(-1, 5, -1).contiguous()
    out = attention_fused.flash_attention(q, k, v)
    torch.testing.assert_close(out, v.mean(1, keepdim=True).expand_as(v))


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "rank",
                                  "strides", "T", "hd", "hd-odd"])
def test_check_rejects_what_the_kernels_do_not_take(case):
    """The wrapper's input check (run before any launch on the card)."""
    q = torch.zeros((2, 8, 8))
    bad = {
        "dtype": (TypeError, (q.half(), q.half(), q.half())),
        "mixed": (TypeError, (q, q.bfloat16(), q)),
        "shape": (ValueError, (q, q[:, :4].contiguous(), q)),
        "rank": (ValueError, (q[0], q[0], q[0])),
        "strides": (ValueError, (q.transpose(1, 2),) * 3),
        "T": (ValueError, (torch.zeros((1, 0, 8)),) * 3),
        "hd": (ValueError, (torch.zeros((1, 4, attention_fused.HD_MAX + 8)),)
               * 3),
        "hd-odd": (ValueError, (torch.zeros((1, 4, 12)),) * 3),
    }
    exc, args = bad[case]
    with pytest.raises(exc):
        attention_fused._check(*args)
    assert attention_fused._check(q, q, q) == (2, 8, 8)


def test_cpu_path_launches_no_kernel():
    n = (attention_fused.launches_fwd, attention_fused.launches_bwd)
    _, (q, k, v, d) = make(2, 9, 8, "float32", n=4)
    attention_fused.flash_attention(q, k, v)
    attention_fused.flash_attention_bwd(q, k, v, d)
    assert (attention_fused.launches_fwd, attention_fused.launches_bwd) == n


def test_kernel_input_checks():
    """What the CUDA wrapper refuses before it launches a kernel, checked on
    CPU tensors (the check does not look at the device): shapes, types,
    contiguity, and a start off a 16-byte boundary (the kernels load 16
    bytes at a time)."""
    Z, T, hd = 2, 37, 24
    q = torch.zeros((Z, T, hd), dtype=torch.bfloat16)
    assert attention_fused._check(q, q, q) == (Z, T, hd)
    flat = torch.zeros(Z * T * hd + 8, dtype=torch.bfloat16)
    off = next(i for i in range(8) if (flat[i:].data_ptr() % 16) == 2)
    shifted = flat[off:off + Z * T * hd].view(Z, T, hd)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        attention_fused._check(shifted, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        attention_fused._check(q.transpose(1, 2).contiguous().transpose(1, 2),
                               q, q)
    with pytest.raises(TypeError):
        attention_fused._check(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="hd a multiple of 8"):
        attention_fused._check(*[torch.zeros((Z, T, 20))] * 3)
    with pytest.raises(ValueError, match="T >= 1"):
        empty = torch.zeros((1, 0, 8))
        attention_fused._check(empty, empty, empty)
    # no length limit: ESM2's trained context (T = 1024) and beyond pass
    for t in (1024, 4096):
        long = torch.zeros((1, t, 8))
        assert attention_fused._check(long, long, long) == (1, t, 8)
