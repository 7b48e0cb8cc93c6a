"""Population metrics of a run's summary.

Counterpart of ``diversity_pct`` and ``exploration`` in
``ppde_tpu/metrics.py`` (reference make_figures.py:29-49). The rest of that
module (Potts and MSA-Transformer scoring, the MNIST writers) waits for the
metrics port.
"""
from __future__ import annotations

import numpy as np
import torch

from ppde_tpu_torch import codec, utils


def diversity_pct(population: np.ndarray) -> float:
    """% unique variants of a one-hot population [N, L, V]."""
    seqs = codec.onehot_to_seqs(population)
    return 100.0 * len(set(seqs)) / len(seqs)


def exploration(population: np.ndarray, wt_onehot: np.ndarray):
    """(mean, std) number of mutations from the wild type."""
    d = utils.mut_distance(torch.as_tensor(np.asarray(population)),
                           torch.as_tensor(np.asarray(wt_onehot))).numpy()
    return float(d.mean()), float(d.std())
