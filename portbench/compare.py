"""What decides ``correct``: the program's outputs against the reference.

The window's outputs that are judged, at the window's own sizes:

  * the energy's last call (the last step's proposals, every chain): its
    energies, its fitness and its gradient, every term's, against the
    reference's at the same one-hots (the gradient by the median of the
    chains' gaps and by their 95th percentile);
  * the sampler's state after the window: each chain's best energy against
    the reference's energy of its best state, and, for each chain that is
    away from the wild type at the end (so was not sent back to it at the
    last step), its last recorded energy against the reference's energy of
    its final state;
  * ``yardstick.check_run``'s checks of the run (finite energies, every
    chain within the mutation budget, an acceptance rate inside (0, 1),
    bests at least the start, at least one chain away from the wild type).

Each gap is relative to the reference's largest magnitude (energies: at
least 1) and is the widest over the chains, but the gradient's: the
median of the chains' gaps, and their 95th percentile, which a fault in
more than one chain in twenty reaches while the one or two chains a sound
float32 run routes otherwise at a max-pool tie do not. A cell's file
under ``limits/`` names the gaps it judges, each with its limit. The
control puts the reference computed one precision lower
(``reference.Precision``) in the program's place at the same states.
"""
from __future__ import annotations

import numpy as np
import torch

GAPS = ("energy_gap", "fit_gap", "grad_gap", "grad_gap_p95", "best_gap",
        "record_gap")


def _rel(a, b, floor: float) -> float:
    """The widest |a - b| over the chains, relative to the reference's
    largest magnitude (at least ``floor``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(floor, np.abs(b).max()))


def gaps(last: dict, best_e, rec_last, moved, ref: dict) -> dict:
    """Every gap of ``GAPS`` (and the look behind the gradient's).

    last: the energy's last call {e, fit, grad} (host arrays); best_e [n]
    the carried best energies; rec_last [n] the last recorded energies;
    moved [n] bool: chains away from the wild type at the end; ref: the
    reference's {e, fit, grad} at the last call's one-hots, ``best_e`` at
    the best states and ``final_e`` at the final states.
    """
    g, gr = (np.asarray(last["grad"], np.float64),
             np.asarray(ref["grad"], np.float64))
    # the gradient's gap of each chain; the median and the 95th percentile
    # are judged, not the widest: in float32 a channel's max-pool can route
    # a near-tie to the other row than the reference does, which moves one
    # chain's gradient and no value
    per = (np.linalg.norm((g - gr).reshape(len(g), -1), axis=1)
           / np.maximum(np.linalg.norm(gr.reshape(len(gr), -1), axis=1),
                        1e-30))
    med = float(np.median(per))
    out = {
        "energy_gap": _rel(last["e"], ref["e"], 1.0),
        "fit_gap": _rel(last["fit"], ref["fit"], 1e-6),
        "grad_gap": med,
        "grad_gap_p95": float(np.quantile(per, 0.95)),
        "best_gap": _rel(best_e, ref["best_e"], 1.0),
        # not judged: the whole batch's gap, and the chains far above the
        # median
        "grad_gap_whole": float(np.linalg.norm(g - gr)
                                / max(np.linalg.norm(gr), 1e-30)),
        "grad_chain_max": float(per.max()),
        "grad_chains_over_10x_median": int((per > 10 * med).sum()),
    }
    moved = np.asarray(moved, bool)
    rec, fin = np.asarray(rec_last)[moved], np.asarray(ref["final_e"])[moved]
    out["record_gap"] = _rel(rec, fin, 1.0) if moved.any() else float("inf")
    return out


def evaluate(reference, x_last, best_x, final_x, block: int) -> dict:
    """The reference's (or the control's) values at the judged states."""
    dev = reference.raw["potts_W"].device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    e, fit, grad = reference.energy_and_grad(t(x_last), block)
    best_e = reference.energy(t(best_x), block)[0]
    final_e = reference.energy(t(final_x), block)[0]
    return {"e": e.cpu().numpy(), "fit": fit.cpu().numpy(),
            "grad": grad.cpu().numpy(), "best_e": best_e.cpu().numpy(),
            "final_e": final_e.cpu().numpy()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every gap the cell judges at most
    its limit."""
    checks, ok = {}, True
    for name in limits:
        v, lim = numbers[name], limits[name]
        checks[name] = {"value": v, "limit": lim}
        ok = ok and bool(v <= lim)
    return ok, checks
