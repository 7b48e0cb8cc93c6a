"""A protein directory made from the seed, in the layouts the program reads.

``write`` makes, on the device and in a few large draws from one
``torch.Generator``, every weight of a configuration, and writes:

  * ``wt.fasta``: the traffic's wild type (a named sequence, or one of a
    given length drawn uniformly over the 20 letters from the seed);
  * ``potts.npz``: couplings J [L, L, 20, 20] (symmetric, zero diagonal
    blocks) and fields h [L, 20], with ``index_list`` 1..L and offset 1, so
    the whole sequence is the Potts window;
  * ``onehot_cnn_seed={m}.pt``: PPDE's OnehotCNN state dicts (Conv1d 20 ->
    C, k = 5; Linear C -> 2C; Linear 2C -> 1), PyTorch's default uniform
    init bounds;
  * the 20 linear oracle heads' pickles (the run assembly loads them; the
    window never calls the oracle);
  * each expert's files (``experts/<key>.py``'s ``write``), drawn from the
    same generator after the CNN's, in the configuration's order.

The program and the plain reference both read these files.
"""
from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

from portbench import experts

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
V = 20


def wild_type(traffic: dict, seed: int) -> str:
    if "wild_type" in traffic:
        return traffic["wild_type"]
    rng = np.random.default_rng(seed)
    return "".join(ALPHABET[i] for i in rng.integers(0, V,
                                                     traffic["wt_length"]))


def _normal(gen, n: int, device) -> torch.Tensor:
    return torch.randn(n, generator=gen, device=device)


def _uniform(gen, shape, bound: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return (2.0 * u - 1.0) * bound


def potts_arrays(gen, wt: str, cfg: dict, device):
    """J [L, L, V, V] and h [L, V] (float32 numpy)."""
    L = len(wt)
    W = _normal(gen, (L * V) ** 2, device).reshape(L * V, L * V)
    W = 0.5 * (W + W.T) * cfg["coupling_std"]
    W4 = W.reshape(L, V, L, V)
    W4[torch.arange(L), :, torch.arange(L), :] = 0.0
    J = W4.permute(0, 2, 1, 3).contiguous()  # J[i,j,k,l] = W[(i,k),(j,l)]
    h = _normal(gen, L * V, device).reshape(L, V) * cfg["field_std"]
    idx = torch.tensor([ALPHABET.index(c) for c in wt], device=device)
    h[torch.arange(L), idx] += cfg["wt_field_bonus"]
    return J.cpu().numpy(), h.cpu().numpy()


def cnn_members(gen, L: int, cfg: dict, device) -> list[dict]:
    """OnehotCNN state dicts (CPU tensors); C = L when ``channels`` is
    "L" (PPDE's OnehotCNN takes its width from the protein's length)."""
    C = L if cfg["channels"] == "L" else int(cfg["channels"])
    K = cfg["kernel"]
    out = []
    for _ in range(cfg["members"]):
        b_enc = 1.0 / math.sqrt(V * K)
        b_emb = 1.0 / math.sqrt(C)
        b_dec = 1.0 / math.sqrt(2 * C)
        sd = {"encoder.weight": _uniform(gen, (C, V, K), b_enc, device),
              "encoder.bias": _uniform(gen, (C,), b_enc, device),
              "embedding.0.weight": _uniform(gen, (2 * C, C), b_emb, device),
              "embedding.0.bias": _uniform(gen, (2 * C,), b_emb, device),
              "decoder.weight": _uniform(gen, (1, 2 * C), b_dec, device),
              "decoder.bias": _uniform(gen, (1,), b_dec, device)}
        out.append({k: v.cpu() for k, v in sd.items()})
    return out


def write(root: str, name: str, config: dict, traffic: dict, seed: int,
          device) -> dict:
    """Write the directory ``root/name``; returns its paths."""
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    wt = wild_type(traffic, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    with open(os.path.join(path, "wt.fasta"), "w") as f:
        f.write(f">{name}\n{wt}\n")
    J, h = potts_arrays(gen, wt, config["potts"], device)
    potts_file = os.path.join(path, "potts.npz")
    np.savez(potts_file, J=J, h=h, index_list=np.arange(1, len(wt) + 1),
             reg_coef=1.0, offset=1)
    del J
    for m, sd in enumerate(cnn_members(gen, len(wt), config["cnn"], device)):
        torch.save(sd, os.path.join(path, f"onehot_cnn_seed={m}.pt"))
    rng = np.random.default_rng(seed)
    d = 1 + len(wt) * V
    for s in range(20):
        with open(os.path.join(
                path, f"results-predictor=ev+onehot-train=-1-seed={s}-"
                "linear.pkl"), "wb") as f:
            pickle.dump({"coef_": rng.normal(0.0, 0.01, d),
                         "intercept_": float(rng.normal(0.0, 0.1)),
                         "reg_coef": float(rng.uniform(0.5, 2.0))}, f)
    files = {key: mod.write(gen, cfg, path, wt, device)
             for key, mod, cfg in experts.of(config)}
    return {"dir": path, "wt": wt, "potts": potts_file, "experts": files}
