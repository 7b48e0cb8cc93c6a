"""Read the reference's trained artifacts into the JAX layout.

Counterpart of ``ppde_tpu/models/torch_convert.py``: the reference
OnehotCNN checkpoints (``onehot_cnn_seed=*.pt``, the torch module of
ppde/nets.py:350-376), the augmented linear-regression oracle pickles, and
the MNIST nets' state dicts (the regression net and ensemble, the ResNet
EBM, the DAE). The loaders return numpy arrays in the JAX package's layout,
for ``convert.*_from_numpy``. The writers make the same files from
parameters (seeded stand-ins for tests and ``scripts/seeded_protein.py``,
``scripts/seeded_mnist.py``).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def _torch_load(path):
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {k: v.detach().numpy() for k, v in sd.items()}


def _lin(sd, prefix):
    return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
            "b": sd[f"{prefix}.bias"]}


def _conv1d(sd, prefix):
    # torch [out,in,k] -> WIO [k,in,out]
    return {"w": np.ascontiguousarray(
        sd[f"{prefix}.weight"].transpose(2, 1, 0)),
        "b": sd[f"{prefix}.bias"]}


def _conv2d(sd, prefix):
    # Conv2d [out,in,kh,kw] -> HWIO [kh,kw,in,out]; the same permutation
    # takes a ConvTranspose2d's [in,out,kh,kw] to the JAX package's
    # transposed-conv layout [kh,kw,out,in]
    return {"w": np.ascontiguousarray(
        sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)),
        "b": sd[f"{prefix}.bias"]}


def _bn(sd, prefix):
    return {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack(list(ts)) for ts in zip(*trees)]
    return np.stack(trees, 0)


def onehot_cnn(path: str) -> dict:
    """One reference OnehotCNN state dict -> {encoder, embed, decoder}."""
    sd = _torch_load(path)
    return {"encoder": _conv1d(sd, "encoder"),
            "embed": _lin(sd, "embedding.0"),
            "decoder": _lin(sd, "decoder")}


def onehot_cnn_ensemble(paths: list[str]) -> dict:
    """The members' parameters stacked on a leading axis (encoder.w
    [M,K,V,C], embed.w [M,C,2C], decoder.w [M,2C,1], ...)."""
    return _stack([onehot_cnn(p) for p in paths])


def save_onehot_cnn(path: str, member: dict) -> None:
    """Write one member ({encoder, embed, decoder} of numpy arrays or
    tensors, the JAX layout) as a reference OnehotCNN state dict."""
    def t(a):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        return torch.from_numpy(np.ascontiguousarray(a))

    enc, emb, dec = member["encoder"], member["embed"], member["decoder"]
    torch.save({"encoder.weight": t(enc["w"]).permute(2, 1, 0).contiguous(),
                "encoder.bias": t(enc["b"]),
                "embedding.0.weight": t(emb["w"]).T.contiguous(),
                "embedding.0.bias": t(emb["b"]),
                "decoder.weight": t(dec["w"]).T.contiguous(),
                "decoder.bias": t(dec["b"])}, path)


def linear_oracle(paths: list[str]) -> dict:
    """The ridge heads' pickles (keys coef_ [1+L*V], intercept_, reg_coef)
    -> coef [S, 1+L*V], intercept [S], reg_coef [S], float32."""
    coefs, intercepts, regs = [], [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f)
        coefs.append(np.asarray(d["coef_"], np.float32))
        intercepts.append(np.float32(d["intercept_"]))
        regs.append(np.float32(d["reg_coef"]))
    return {"coef": np.stack(coefs),
            "intercept": np.asarray(intercepts),
            "reg_coef": np.asarray(regs)}


def save_linear_oracle_head(path: str, coef, intercept: float,
                            reg_coef: float) -> None:
    """Write one ridge head in the reference pickle layout."""
    with open(path, "wb") as f:
        pickle.dump({"coef_": np.asarray(coef, np.float64),
                     "intercept_": float(intercept),
                     "reg_coef": float(reg_coef)}, f)


# ---------------------------------------------------------------------------
# MNIST (reference MNISTRegressionNet nets.py:14-37, DAE nets.py:59-168,
# ResNetEBM grathwohl/mlp.py:100-196)
# ---------------------------------------------------------------------------

_REGRESSION_CONVS = (0, 2, 4, 6)  # net.{i}: the Sequential's conv slots


def mnist_regression(path: str) -> dict:
    """One reference MNISTRegressionNet state dict -> {conv, out}."""
    sd = _torch_load(path)
    return {"conv": [_conv2d(sd, f"net.{i}") for i in _REGRESSION_CONVS],
            "out": _lin(sd, "out")}


def mnist_regression_ensemble(paths: list[str]) -> dict:
    """The members' parameters stacked on a leading axis."""
    return _stack([mnist_regression(p) for p in paths])


def save_mnist_regression(path: str, member: dict) -> None:
    """Write one regression net in the port's layout ({conv: [{w OIHW, b}],
    out: {w [nc,1], b [1]}}, tensors) as a reference state dict."""
    sd = {}
    for i, p in zip(_REGRESSION_CONVS, member["conv"]):
        sd[f"net.{i}.weight"] = p["w"].detach().cpu().contiguous()
        sd[f"net.{i}.bias"] = p["b"].detach().cpu().contiguous()
    sd["out.weight"] = member["out"]["w"].detach().cpu().T.contiguous()
    sd["out.bias"] = member["out"]["b"].detach().cpu().contiguous()
    torch.save(sd, path)


def _basic_block(sd, prefix, norm: bool):
    block = {"conv1": _conv2d(sd, f"{prefix}.conv1"),
             "conv2": _conv2d(sd, f"{prefix}.conv2")}
    if norm:
        block["norm1"] = _bn(sd, f"{prefix}.norm1")
        block["norm2"] = _bn(sd, f"{prefix}.norm2")
    if f"{prefix}.shortcut_conv.weight" in sd:
        block["shortcut"] = _conv2d(sd, f"{prefix}.shortcut_conv")
    return block


def resnet_ebm(path: str) -> dict:
    """EBM checkpoint: {'model': state_dict} with net.* (ResNetEBM) and
    mean."""
    sd = _torch_load(path)
    params = {
        "proj": _conv2d(sd, "net.proj"),
        "blocks": [_basic_block(sd, f"net.net.{i}", norm=False)
                   for i in range(8)],
        "energy_linear": _lin(sd, "net.energy_linear"),
    }
    if "mean" in sd:
        params["mean"] = sd["mean"]
    return params


def dae(path: str) -> dict:
    """DAE checkpoint: encoder.{0..3}, fc, decoder.{0,2,3,4},
    final_layer."""
    sd = _torch_load(path)
    return {
        "enc_proj": _conv2d(sd, "encoder.0"),
        "enc_blocks": [_basic_block(sd, f"encoder.{i}", norm=True)
                       for i in (1, 2, 3)],
        "fc": _lin(sd, "fc"),
        "dec_proj": _lin(sd, "decoder.0"),
        "dec_blocks": [_basic_block(sd, f"decoder.{i}", norm=True)
                       for i in (2, 3, 4)],
        "final": _conv2d(sd, "final_layer"),
    }
