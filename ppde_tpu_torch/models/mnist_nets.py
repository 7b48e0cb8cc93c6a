"""MNIST-domain experts: Siamese sum regressor, DAE, ResNet EBM.

Counterpart of ``ppde_tpu/models/mnist_nets.py`` (architecture parity with
the reference ppde/nets.py:14-37, 59-168 and
third_party/grathwohl/mlp.py:52-196), as pure functions over parameter
dicts in torch's layout: NCHW activations, OIHW conv kernels, [in, out,
kh, kw] transposed-conv kernels, [in, out] linear weights. The dict keys
are the JAX package's, so both packages flatten a tree in the same order
(``load_npz``). Flattening an NCHW activation gives torch's order, which
the JAX package reaches by transposing its NHWC activations.

The convolutions are cuDNN's (through ``torch.nn.functional``): no
hand-written kernel, as the JAX package's experts are plain XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ppde_tpu_torch import checkpoint
from ppde_tpu_torch.models import layers
from ppde_tpu_torch.models.layers import swish


def _to_image(x: torch.Tensor) -> torch.Tensor:
    """[B, 784] -> NCHW [B, 1, 28, 28]."""
    return x.reshape(x.shape[0], 1, 28, 28)


# ---------------------------------------------------------------------------
# Siamese regression net (reference MNISTRegressionNet, nets.py:14-37)
# ---------------------------------------------------------------------------

# (stride, padding) of the trunk's four convs: 28 -> 14 -> 7 -> 3 -> 1
_TRUNK = ((2, 1), (2, 1), (2, 1), (1, 0))


def regression_init(generator: torch.Generator, nc: int = 16,
                    dtype=torch.float32):
    return {
        "conv": [
            layers.init_conv2d(generator, 4, 4, 1, nc, dtype),
            layers.init_conv2d(generator, 4, 4, nc, nc, dtype),
            layers.init_conv2d(generator, 4, 4, nc, nc, dtype),
            layers.init_conv2d(generator, 3, 3, nc, nc, dtype),
        ],
        "out": layers.init_linear(generator, nc, 1, dtype),
    }


def regression_init_ensemble(generator: torch.Generator, n_members: int = 3,
                             nc: int = 16):
    return layers.stack_params([regression_init(generator, nc)
                                for _ in range(n_members)])


def _trunk(conv, x: torch.Tensor, members: int) -> torch.Tensor:
    """[B, 784] -> [B, members, nc]. With a member axis on the kernels
    ([M, out, in, kh, kw]) every member runs as one group of a grouped
    convolution, the image repeated once per group."""
    h = _to_image(x).expand(-1, members, -1, -1)
    for p, (stride, pad) in zip(conv, _TRUNK):
        w = p["w"].reshape((-1,) + tuple(p["w"].shape[-3:]))
        h = swish(torch.nn.functional.conv2d(
            h, w, p["b"].reshape(-1), stride=stride, padding=pad,
            groups=members))
    return h.reshape(h.shape[0], members, -1)


def _regression(params, x1, x2, members: int) -> torch.Tensor:
    """[B, members] predicted sums; both images go through the trunk in
    one batch."""
    B = x1.shape[0]
    h = _trunk(params["conv"], torch.cat([x1, x2]), members)
    h = h[:B] + h[B:]                                       # [B, M, nc]
    w = params["out"]["w"].reshape(members, -1)             # [M, nc]
    return (h * w).sum(-1) + params["out"]["b"].reshape(members)


def regression_apply(params, x1, x2) -> torch.Tensor:
    """Predict the sum of two digits; x1, x2 are [B, 784]."""
    return _regression(params, x1, x2, 1)[:, 0]


def regression_ensemble_apply(stacked, x1, x2) -> torch.Tensor:
    """Mean prediction of a stacked ensemble (leading member axis)."""
    members = stacked["conv"][0]["w"].shape[0]
    return _regression(stacked, x1, x2, members).mean(-1)


# ---------------------------------------------------------------------------
# BasicBlock (reference grathwohl/mlp.py:52-98)
# ---------------------------------------------------------------------------

def basic_block_init(generator: torch.Generator, c_in: int, c_out: int,
                     stride: int = 1, norm: bool = False,
                     dtype=torch.float32):
    up = stride < 0
    block = {
        "conv1": (layers.init_conv_transpose2d if up else layers.init_conv2d)(
            generator, 3, 3, c_in, c_out, dtype),
        "conv2": layers.init_conv2d(generator, 3, 3, c_out, c_out, dtype),
    }
    if norm:
        block["norm1"] = layers.init_batchnorm2d(c_out, dtype,
                                                 generator.device)
        block["norm2"] = layers.init_batchnorm2d(c_out, dtype,
                                                 generator.device)
    if stride != 1 or c_in != c_out:
        block["shortcut"] = (
            layers.init_conv_transpose2d(generator, 1, 1, c_in, c_out, dtype)
            if up else layers.init_conv2d(generator, 1, 1, c_in, c_out,
                                          dtype))
    return block


def basic_block_apply(p, x, stride: int = 1, out_nonlin: bool = True):
    """Residual block; stride < 0 denotes the transposed-conv (upsampling)
    form."""
    norm = "norm1" in p
    if stride < 0:
        h = layers.conv_transpose2d(p["conv1"], x, stride=-stride,
                                    padding=1, output_padding=1)
    else:
        h = layers.conv2d(p["conv1"], x, stride=stride, padding=1)
    if norm:
        h = layers.batchnorm2d(p["norm1"], h)
    h = swish(h)
    out = layers.conv2d(p["conv2"], h, stride=1, padding=1)
    if "shortcut" in p:
        if stride < 0:
            sc = layers.conv_transpose2d(p["shortcut"], x, stride=-stride,
                                         padding=0, output_padding=1)
        else:
            sc = layers.conv2d(p["shortcut"], x, stride=stride, padding=0)
        out = out + sc
    else:
        out = out + x
    if out_nonlin:
        if norm:
            out = layers.batchnorm2d(p["norm2"], out)
        out = swish(out)
    return out


# ---------------------------------------------------------------------------
# ResNet EBM (reference mlp.ResNetEBM/EBM, mlp.py:100-196)
# ---------------------------------------------------------------------------

_EBM_STRIDES = (2, 2, 1, 1, 1, 1, 1, 1)


def ebm_init(generator: torch.Generator, n_channels: int = 64, mean=None,
             dtype=torch.float32):
    nc = n_channels
    p = {"proj": layers.init_conv2d(generator, 3, 3, 1, nc, dtype),
         "blocks": [basic_block_init(generator, nc, nc, s, dtype=dtype)
                    for s in _EBM_STRIDES],
         "energy_linear": layers.init_linear(generator, nc, 1, dtype)}
    if mean is not None:
        p["mean"] = torch.as_tensor(np.asarray(mean), dtype=dtype).reshape(
            -1).to(generator.device)
    return p


def ebm_net_apply(params, x: torch.Tensor) -> torch.Tensor:
    """ResNetEBM body: x [B, 784] -> scalar energy head [B]."""
    h = layers.conv2d(params["proj"], _to_image(x), stride=1, padding=1)
    for p, s in zip(params["blocks"], _EBM_STRIDES):
        h = basic_block_apply(p, h, stride=s)
    return layers.linear(params["energy_linear"], h.mean((2, 3)))[:, 0]


def ebm_log_prob(params, x: torch.Tensor) -> torch.Tensor:
    """logp(x) = net(x) + Bernoulli(mean).log_prob(x).sum(-1)
    (mlp.py:175-196)."""
    logp = ebm_net_apply(params, x)
    if "mean" in params:
        m = params["mean"][None, :]
        logp = logp + (x * torch.log(m) + (1.0 - x) * torch.log1p(-m)).sum(-1)
    return logp


# ---------------------------------------------------------------------------
# DAE (reference nets.py:59-168)
# ---------------------------------------------------------------------------

def dae_init(generator: torch.Generator, latent_dim: int = 16,
             n_channels: int = 64, dtype=torch.float32):
    nc = n_channels
    g = generator
    return {
        "enc_proj": layers.init_conv2d(g, 3, 3, 1, nc, dtype),
        "enc_blocks": [basic_block_init(g, nc, nc, s, norm=True, dtype=dtype)
                       for s in (2, 2, 1)],
        "fc": layers.init_linear(g, nc * 49, latent_dim, dtype),
        "dec_proj": layers.init_linear(g, latent_dim, nc * 49, dtype),
        "dec_blocks": [basic_block_init(g, nc, nc, s, norm=True, dtype=dtype)
                       for s in (-2, -2, 1)],
        "final": layers.init_conv2d(g, 1, 1, nc, 1, dtype),
    }


def dae_encode(params, x: torch.Tensor) -> torch.Tensor:
    h = layers.conv2d(params["enc_proj"], _to_image(x), stride=1, padding=1)
    for p, s in zip(params["enc_blocks"], (2, 2, 1)):
        h = basic_block_apply(p, h, stride=s)
    return layers.linear(params["fc"], h.reshape(h.shape[0], -1))


def dae_decode(params, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, latent] -> reconstruction logits NCHW [B, 1, 28, 28]."""
    h = layers.linear(params["dec_proj"], z)
    nc = params["final"]["w"].shape[1]
    h = h.reshape(h.shape[0], nc, 7, 7)
    for p, s in zip(params["dec_blocks"], (-2, -2, 1)):
        h = basic_block_apply(p, h, stride=s)
    return layers.conv2d(params["final"], h, stride=1, padding=0)


def dae_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Decoded reconstruction logits flattened to [B, 784]."""
    y = dae_decode(params, dae_encode(params, x))
    return y.reshape(y.shape[0], -1)


def dae_log_prob(params, x: torch.Tensor) -> torch.Tensor:
    """-BCEWithLogits(decode(encode(x)), x) summed over pixels
    (nets.py:162-168)."""
    logits = dae_logits(params, x)
    x = x.reshape(x.shape[0], -1)
    return -torch.nn.functional.binary_cross_entropy_with_logits(
        logits, x, reduction="none").sum(-1)


def dae_corrupt(draws, x: torch.Tensor, max_p: int = 15) -> torch.Tensor:
    """Flip a random <= max_p% of pixels, one rate for the whole batch
    (training-time noising, nets.py:123-131). Draws ``randint(max_p + 1,
    [])`` (the percent) and ``uniform(x.shape)`` (the flips)."""
    p = draws.randint(max_p + 1, ()).float() / 100.0
    flip = (draws.uniform(x.shape) < p).to(x.dtype)
    return (1 - x) * flip + x * (1 - flip)


# ---------------------------------------------------------------------------
# the JAX trainer's checkpoints
# ---------------------------------------------------------------------------

def load_npz(path: str, like):
    """Read a checkpoint of the JAX package's trainer (``p{i}`` leaves in
    JAX flatten order, plus ``step``; ``ppde_tpu/training.py``'s
    ``save_ckpt``) into a tree of numpy arrays in the JAX layout, shaped as
    ``like`` (a tree with the same keys, e.g. ``ebm_init``'s). Returns
    (tree, step); ``ebm_from_numpy`` / ``dae_from_numpy`` in ``convert.py``
    carry the tree into the port's layout. A leaf count or a leaf size
    that differs from ``like``'s raises, naming the leaf."""
    z = np.load(path, allow_pickle=False)
    like_leaves = [leaf for _, leaf in checkpoint.flatten_with_paths(like)]
    n = sum(k[1:].isdigit() for k in z.files if k.startswith("p"))
    if n != len(like_leaves):
        raise ValueError(f"{path} holds {n} leaves; the configured model "
                         f"has {len(like_leaves)}")
    arrays = [z[f"p{i}"] for i in range(n)]
    for i, (a, b) in enumerate(zip(arrays, like_leaves)):
        if a.size != int(np.prod(tuple(b.shape))):
            raise ValueError(f"{path} leaf p{i}: shape {a.shape} does not "
                             f"fit the configured {tuple(b.shape)}")
    return checkpoint.unflatten(like, iter(arrays)), int(z["step"])
