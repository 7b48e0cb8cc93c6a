"""The yardstick: peaks, operation and byte counts, and the run checks.

Copied from the program's own arithmetic so that a later change to the
program cannot move it:

  * ``HBM_BYTES_PER_S``, ``PEAK_OPS``, ``bound_s``: ``chip_smoke.py:250-251``
    and ``chip_smoke.py:479`` (``bound_ms``), in seconds here;
  * ``potts_bytes_ops``: kernel A's bytes and operations,
    ``chip_smoke.py:558-568``;
  * ``cnn_ops``, ``cnn_bytes``: kernel B's, ``chip_smoke.py:603-613`` and
    ``chip_smoke.py:636``, ``:664``, counted from the shapes of a one-hot
    input (a patch of K one-hot rows has K nonzeros);
  * ``attention_bytes_ops``: kernels C and C''s, ``chip_smoke.py:899-906``;
  * ``check_run``: ``ppde_tpu_torch/scripts/bench.py::check_run``, without
    its fresh evaluation of the best states (the plain reference does that
    here, ``compare.py``).

Every count is of what the inputs need, each input byte read once and each
output byte written once, so the least time it gives is a lower bound of
any implementation's, and a share of it never passes 100%.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# float32 on the FMA units (no tensor cores), bf16 dense on the tensor cores
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
STEP_PEAK = PEAK_OPS["bfloat16"]  # the chip's peak for the whole step's share
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory's rate and the operations over the type's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype])


def potts_padded(L: int, V: int = 20, lane: int = 128) -> int:
    """P: the flattened couplings' side, L*V padded to a multiple of 128."""
    return -(-(L * V) // lane) * lane


def potts_bytes_ops(B: int, L: int, dtype: str, V: int = 20):
    """Kernel A on B one-hot sequences of L residues: bytes (xf in bf16, W
    and h in ``dtype``, grad [B, P] and H [B] in float32) and operations (2
    per nonzero of xf per column of W, plus the fields and the sum)."""
    P = potts_padded(L, V)
    s = DTYPE_BYTES[dtype]
    n_bytes = B * P * 2 + P * P * s + P * s + B * P * 4 + B * 4
    nnz = B * L
    return n_bytes, 2 * nnz * P + 4 * B * P


def cnn_ops(B: int, L: int, M: int, C: int, C2: int, K: int = 5) -> int:
    """Kernel B's operations on B one-hot sequences: the conv on the
    patches' nonzeros (K a patch), the dense embed layer, and one routed row
    of emb_w per (sample, member, channel) in the backward pass."""
    T = L - K + 1
    nnz_patches = B * T * K
    return 2 * M * (nnz_patches * C + B * T * C * C2 + B * C2 * C)


def cnn_bytes(B: int, L: int, M: int, C: int, C2: int, dtype: str,
              K: int = 5, V: int = 20) -> int:
    """Kernel B's bytes: x in ``dtype``, the weights in ``dtype`` with their
    biases in float32, fit [B] and dx [B, L, V] in float32."""
    s = DTYPE_BYTES[dtype]
    w_bytes = M * (K * V * C + C * C2 + C2) * s + M * (C + C2 + 1) * 4
    return B * L * V * s + w_bytes + B * 4 + B * L * V * 4


def attention_bytes_ops(Z: int, T: int, hd: int, dtype: str,
                        backward: bool):
    """Kernel C (forward) or C' (backward) on [Z, T, hd]: q, k, v read and o
    written once (backward: q, k, v, dout read, dq, dk, dv written); 2
    (backward 5) products of 2 Z T^2 hd."""
    n = Z * T * hd
    s = DTYPE_BYTES[dtype]
    if backward:
        return 7 * n * s, 10 * n * T
    return 4 * n * s, 4 * n * T


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def check_run(energies, best_energy, best_x, final_x, n_accepted, wt,
              nmut_threshold: int, steps: int, n_chains: int) -> dict:
    """The checks every PPDE run must pass; returns their numbers.

    energies [records, n_chains] (host), whose first row holds the initial
    energies; best_energy [n_chains]; best_x and final_x [n_chains, L, V]
    (host); n_accepted: the proposals accepted over ``steps`` steps; wt
    [L, V] the wild type's one-hot. A run in which no chain left the wild
    type has not sampled."""
    check(np.isfinite(energies).all(), "non-finite energies")
    check(np.isfinite(best_energy).all(), "non-finite best energy")
    d_final = (final_x != wt[None]).any(-1).sum(-1)
    d_best = (best_x != wt[None]).any(-1).sum(-1)
    check(d_final.max() < nmut_threshold,
          f"final distance {d_final.max()} >= nmut threshold")
    check(d_best.max() <= nmut_threshold,
          f"best distance {d_best.max()} > nmut threshold")
    rate = float(n_accepted) / (steps * n_chains)
    check(0.0 < rate < 1.0, f"acceptance rate {rate}")
    check((best_energy >= energies[0]).all(),
          "best energy below the initial energy")
    check((d_final > 0).any(), "no chain left the wild type")
    return {"acceptance_rate": rate,
            "max_distance_final": int(d_final.max()),
            "chains_moved": int((d_final > 0).sum())}
