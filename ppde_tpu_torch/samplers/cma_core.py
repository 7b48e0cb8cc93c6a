"""Minimal CMA-ES (covariance matrix adaptation) — host-side numpy.

A copy of ``ppde_tpu/samplers/cma_core.py`` (the port imports nothing of
the JAX package): the same seed gives the same ``ask()``. The reference
delegates to the `cma` pip package (protein_samplers/cmaes.py:79-89). The
ask/tell update is sequential O(popsize * d) host work; only the objective
(the energy of a generation's argmax-discretised candidates) runs on the
device, in one call per generation.

Standard equations of Hansen's CMA-ES tutorial (weighted recombination,
cumulation paths for sigma and the rank-1 update, rank-mu update, lazy
eigendecomposition). ``diag=True`` selects sep-CMA-ES (Ros & Hansen 2008):
the covariance restricted to its diagonal, the rank-1/rank-mu learning
rates times (d+2)/3, every update O(popsize * d) and no eigendecomposition,
which keeps the GFP-sized search space (d = 237 * 20 = 4740) tractable.
``diag=None`` (default) selects sep-CMA above AUTO_DIAG_DIM.
``get_state`` / ``set_state`` carry the whole host state (the numpy
generator's too) for checkpoints.
"""
from __future__ import annotations

import numpy as np

AUTO_DIAG_DIM = 1024  # diag=None switches to sep-CMA above this dimension


class CMAES:
    """Minimize an objective over R^d via ask/tell."""

    def __init__(self, x0: np.ndarray, sigma: float, popsize: int | None = None,
                 seed: int = 0, diag: bool | None = None):
        self.dim = d = int(x0.size)
        self.mean = np.asarray(x0, np.float64).copy().ravel()
        self.sigma = float(sigma)
        self.rng = np.random.default_rng(seed)
        self.diag = bool(d > AUTO_DIAG_DIM) if diag is None else bool(diag)

        self.lam = popsize or 4 + int(3 * np.log(d))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights ** 2)

        self.cc = (4 + self.mueff / d) / (d + 4 + 2 * self.mueff / d)
        self.cs = (self.mueff + 2) / (d + self.mueff + 5)
        self.c1 = 2 / ((d + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mueff - 2 + 1 / self.mueff)
                       / ((d + 2) ** 2 + self.mueff))
        if self.diag:
            # sep-CMA: learning on d instead of d^2 covariance entries
            # supports the (d+2)/3 faster rate (Ros & Hansen 2008, eq. 4)
            scale = (d + 2) / 3.0
            self.c1 = min(1.0, self.c1 * scale)
            self.cmu = min(1 - self.c1, self.cmu * scale)
        self.damps = 1 + 2 * max(0.0, np.sqrt((self.mueff - 1) / (d + 1)) - 1) \
            + self.cs
        self.chiN = np.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d ** 2))

        self.pc = np.zeros(d)
        self.ps = np.zeros(d)
        if self.diag:
            self.C = np.ones(d)      # diagonal covariance only
            self.D = np.ones(d)
            self.invsqrtD = np.ones(d)
            self.eigen_every = 1     # D refresh is O(d); do it every tell
        else:
            self.C = np.eye(d)
            self.B = np.eye(d)
            self.D = np.ones(d)
            self.invsqrtC = np.eye(d)
            # lazy eigendecomposition cadence (generations)
            self.eigen_every = max(
                1, int(1.0 / ((self.c1 + self.cmu) * d * 10)))
        self.eigen_stale = 0
        self.generation = 0
        self._last_ask: np.ndarray | None = None

    def _update_eigen(self):
        if self.diag:
            self.D = np.sqrt(np.maximum(self.C, 1e-20))
            self.invsqrtD = 1.0 / self.D
            self.eigen_stale = 0
            return
        self.C = np.triu(self.C) + np.triu(self.C, 1).T
        vals, vecs = np.linalg.eigh(self.C)
        vals = np.maximum(vals, 1e-20)
        self.D = np.sqrt(vals)
        self.B = vecs
        self.invsqrtC = vecs @ np.diag(1.0 / self.D) @ vecs.T
        self.eigen_stale = 0

    def ask(self) -> np.ndarray:
        """Sample a generation of candidates, shape [popsize, dim]."""
        z = self.rng.standard_normal((self.lam, self.dim))
        if self.diag:
            y = z * self.D  # B = I
        else:
            y = (z * self.D) @ self.B.T
        self._last_ask = self.mean + self.sigma * y
        return self._last_ask

    def tell(self, solutions: np.ndarray, fitnesses: np.ndarray) -> None:
        """Update the distribution from evaluated candidates (minimization)."""
        self.generation += 1
        order = np.argsort(fitnesses)
        sel = solutions[order[: self.mu]]
        old_mean = self.mean
        self.mean = self.weights @ sel

        y_mean = (self.mean - old_mean) / self.sigma
        whitened = (self.invsqrtD * y_mean if self.diag
                    else self.invsqrtC @ y_mean)
        self.ps = (1 - self.cs) * self.ps + np.sqrt(
            self.cs * (2 - self.cs) * self.mueff) * whitened
        hsig = (np.linalg.norm(self.ps)
                / np.sqrt(1 - (1 - self.cs) ** (2 * self.generation))
                / self.chiN) < (1.4 + 2 / (self.dim + 1))
        self.pc = (1 - self.cc) * self.pc + hsig * np.sqrt(
            self.cc * (2 - self.cc) * self.mueff) * y_mean

        artmp = (sel - old_mean) / self.sigma  # [mu, d]
        if self.diag:
            self.C = ((1 - self.c1 - self.cmu) * self.C
                      + self.c1 * (self.pc ** 2
                                   + (not hsig) * self.cc * (2 - self.cc)
                                   * self.C)
                      + self.cmu * (self.weights @ artmp ** 2))
        else:
            self.C = ((1 - self.c1 - self.cmu) * self.C
                      + self.c1 * (np.outer(self.pc, self.pc)
                                   + (not hsig) * self.cc * (2 - self.cc)
                                   * self.C)
                      + self.cmu * (artmp.T * self.weights) @ artmp)

        self.sigma *= np.exp((self.cs / self.damps)
                             * (np.linalg.norm(self.ps) / self.chiN - 1))
        self.eigen_stale += 1
        if self.eigen_stale >= self.eigen_every:
            self._update_eigen()

    def ask_and_eval(self, objective) -> tuple[np.ndarray, np.ndarray]:
        X = self.ask()
        f = np.asarray(objective(X), np.float64)
        return X, f

    # -- checkpointing (flat dict of numpy arrays; json-packed RNG state) --

    def get_state(self) -> dict:
        import json

        st = {"mean": self.mean, "sigma": np.float64(self.sigma),
              "pc": self.pc, "ps": self.ps, "C": self.C, "D": self.D,
              "eigen_stale": np.int64(self.eigen_stale),
              "generation": np.int64(self.generation),
              "diag": np.bool_(self.diag),
              "rng_state": np.frombuffer(
                  json.dumps(self.rng.bit_generator.state).encode(),
                  np.uint8)}
        if self.diag:
            st["invsqrtD"] = self.invsqrtD
        else:
            st["B"] = self.B
            st["invsqrtC"] = self.invsqrtC
        return st

    def set_state(self, st: dict) -> None:
        import json

        if bool(st["diag"]) != self.diag:
            # not an assert: must survive `python -O`, else a full-model
            # checkpoint silently assigns mismatched-shape C/D into sep-CMA
            raise ValueError(
                "checkpoint covariance model "
                f"({'diag' if bool(st['diag']) else 'full'}) mismatches this "
                f"instance ({'diag' if self.diag else 'full'})")
        self.mean = np.asarray(st["mean"], np.float64)
        self.sigma = float(st["sigma"])
        self.pc = np.asarray(st["pc"], np.float64)
        self.ps = np.asarray(st["ps"], np.float64)
        self.C = np.asarray(st["C"], np.float64)
        self.D = np.asarray(st["D"], np.float64)
        self.eigen_stale = int(st["eigen_stale"])
        self.generation = int(st["generation"])
        if self.diag:
            self.invsqrtD = np.asarray(st["invsqrtD"], np.float64)
        else:
            self.B = np.asarray(st["B"], np.float64)
            self.invsqrtC = np.asarray(st["invsqrtC"], np.float64)
        self.rng.bit_generator.state = json.loads(
            bytes(st["rng_state"]).decode())


def save_run(path: str, es: CMAES, step: int, **arrays) -> None:
    """Write a CMA-ES run's host state (``cmaes_state.npz``): the
    generation count ``step``, the sampler's ``arrays`` (archive,
    histories; a list of rows is stacked, an empty one stored as [0]) and
    ``es``'s state under ``es_*`` keys, atomically."""
    from ppde_tpu_torch import checkpoint

    arrays = {k: ((np.stack(v, 0) if v else np.zeros((0,)))
                  if isinstance(v, list) else v) for k, v in arrays.items()}
    checkpoint._atomic_savez(path, step=np.int64(step), **arrays,
                             **{"es_" + k: v
                                for k, v in es.get_state().items()})


def load_run(path: str, es: CMAES):
    """Restore ``es`` from ``save_run``'s file; returns (step, the file's
    arrays)."""
    z = np.load(path, allow_pickle=False)
    es.set_state({k[3:]: z[k] for k in z.files if k.startswith("es_")})
    return int(z["step"]), z
