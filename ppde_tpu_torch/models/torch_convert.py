"""Read the reference's trained protein artifacts into the JAX layout.

Counterpart of ``ppde_tpu/models/torch_convert.py`` (the protein parts): the
reference OnehotCNN checkpoints (``onehot_cnn_seed=*.pt``, the torch module
of ppde/nets.py:350-376) and the augmented linear-regression oracle pickles.
The loaders return numpy arrays in the JAX package's stacked layout, for
``convert.cnn_ensemble_from_numpy`` and ``convert.oracle_from_numpy``. The
writers make the same files from parameters (seeded stand-ins for tests and
``scripts/seeded_protein.py``).
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


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
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
