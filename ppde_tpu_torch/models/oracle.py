"""Protein ground-truth oracle: the "Augmented EVmutation" linear ensemble.

Counterpart of ``ppde_tpu/models/oracle.py`` (reference
AugmentedLinearRegression, ppde/nets.py:315-347): 20 ridge regressions over
the features [sqrt(1/potts_reg) * delta_hamiltonian, sqrt(1/reg_s) *
flat_onehot], averaged. The whole ensemble is two products (the one-hot
features hit every head at once) and one Potts score; the products are
plain ``torch.matmul``, as the JAX package's are plain XLA.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ppde_tpu_torch import utils
from ppde_tpu_torch.models import potts as potts_mod
from ppde_tpu_torch.models import torch_convert


@dataclasses.dataclass
class LinearOracleParams:
    coef: torch.Tensor          # [S, 1 + L*V]
    intercept: torch.Tensor     # [S]
    inv_sqrt_reg: torch.Tensor  # [S] = sqrt(1/reg_coef_s)
    potts: potts_mod.PottsParams


def head_paths(protein_dir: str, n_seeds: int = 20) -> list[str]:
    """The reference's file names of the ridge heads."""
    return [os.path.join(
        protein_dir, f"results-predictor=ev+onehot-train=-1-seed={s}-"
        "linear.pkl") for s in range(n_seeds)]


def load(protein_dir: str, n_seeds: int = 20,
         potts_params: potts_mod.PottsParams | None = None,
         device="cuda") -> LinearOracleParams:
    """Load the 20 linear pickles (+ the Potts model: ``potts_params`` or
    the directory's potts.pkl) of a reference protein directory."""
    device = utils.resolve_device(device)
    raw = torch_convert.linear_oracle(head_paths(protein_dir, n_seeds))
    if potts_params is None:
        potts_params = potts_mod.load_pickle(protein_dir, device=device)
    return LinearOracleParams(
        coef=torch.from_numpy(raw["coef"]).to(device),
        intercept=torch.from_numpy(raw["intercept"]).to(device),
        inv_sqrt_reg=torch.from_numpy(
            np.sqrt(1.0 / raw["reg_coef"])).to(device),
        potts=potts_params)


def synthetic(potts_params: potts_mod.PottsParams, full_len: int,
              n_seeds: int = 20, seed: int = 0,
              device="cuda") -> LinearOracleParams:
    """Deterministic random oracle with the real feature contract; the same
    numpy draws as the JAX package's ``synthetic``, so both packages get
    identical arrays from one seed."""
    device = utils.resolve_device(device)
    rng = np.random.default_rng(seed)
    d = 1 + full_len * potts_mod.VOCAB
    coef = rng.normal(0, 0.01, (n_seeds, d)).astype(np.float32)
    coef[:, 0] += 0.5  # weight the evolutionary feature
    intercept = rng.normal(0, 0.1, n_seeds).astype(np.float32)
    return LinearOracleParams(
        coef=torch.from_numpy(coef).to(device),
        intercept=torch.from_numpy(intercept).to(device),
        inv_sqrt_reg=torch.ones((n_seeds,), device=device),
        potts=potts_params)


def apply(params: LinearOracleParams, x: torch.Tensor) -> torch.Tensor:
    """Oracle fitness of one-hot proteins x [B, L_full, V] -> [B].

    y_s = c_s0 * sqrt(1/potts_reg) * dH(x) + sqrt(1/r_s) * (x . c_s[1:])
    + b_s, averaged over the heads s (nets.py:332-347).
    """
    dH = potts_mod.score(params.potts, x, delta=True)            # [B]
    xf = x.reshape(x.shape[0], -1).float()
    ev = dH * float(np.sqrt(1.0 / params.potts.reg_coef))
    onehot_term = xf @ params.coef[:, 1:].T                      # [B, S]
    y = (ev[:, None] * params.coef[None, :, 0]
         + onehot_term * params.inv_sqrt_reg[None, :]
         + params.intercept[None, :])
    return y.mean(-1)
