"""Amino-acid / one-hot codecs.

A copy of ``ppde_tpu/codec.py`` (pure numpy): the port keeps its own so that
it imports nothing of the JAX package. Vocabulary parity with the reference
20-letter table (``third_party/hsu/data_utils.py:48-72``) is load-bearing:
the committed CNN/linear checkpoints were trained against this exact ordering.

All functions here are small host-side numpy utilities; arrays they return are
moved to the device as constants or initial state.
"""
from __future__ import annotations

import numpy as np

# Alphabetically-ordered canonical 20 AA vocabulary + start/stop sentinels.
AA_TO_INT: dict[str, int] = {
    "A": 0, "C": 1, "D": 2, "E": 3, "F": 4, "G": 5, "H": 6, "I": 7, "K": 8,
    "L": 9, "M": 10, "N": 11, "P": 12, "Q": 13, "R": 14, "S": 15, "T": 16,
    "V": 17, "W": 18, "Y": 19, "start": 20, "stop": 21,
}
INT_TO_AA: dict[int, str] = {v: k for k, v in AA_TO_INT.items()}
VOCAB_SIZE = 20

# The 20-letter alphabet in vocabulary order (index i -> AA letter).
ALPHABET = "".join(INT_TO_AA[i] for i in range(VOCAB_SIZE))


def aa_seq_to_ints(seq: str) -> list[int]:
    """String of amino acids -> list of vocabulary indices."""
    return [AA_TO_INT[a] for a in seq]


def ints_to_aa_seq(idxs) -> str:
    """Iterable of vocabulary indices -> amino-acid string."""
    return "".join(INT_TO_AA[int(i)] for i in idxs)


def seqs_to_ints(seqs: list[str]) -> np.ndarray:
    """List of equal-or-ragged-length AA strings -> int array [N, max_len].

    Shorter sequences are right-padded with 0 ('A'), matching the reference
    batch formatter's constant-0 padding (data_utils.py:124-135).
    """
    max_len = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), max_len), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = aa_seq_to_ints(s)
    return out


def seqs_to_onehot(seqs: list[str], dtype=np.float32) -> np.ndarray:
    """AA strings -> one-hot array [N, L, VOCAB_SIZE].

    Parity with data_utils.seqs_to_onehot (data_utils.py:150-157).
    """
    ints = seqs_to_ints(seqs)
    return ints_to_onehot(ints, dtype=dtype)


def ints_to_onehot(ints: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Int array [..., L] -> one-hot [..., L, VOCAB_SIZE]."""
    return np.eye(VOCAB_SIZE, dtype=dtype)[np.asarray(ints)]


def onehot_to_seqs(onehots: np.ndarray) -> list[str]:
    """One-hot / soft array [N, L, V] -> list of AA strings (argmax decode).

    Parity with data_utils.onehot2seq (data_utils.py:167-175).
    """
    idx = np.argmax(np.asarray(onehots), axis=-1)
    return ["".join(INT_TO_AA[int(j)] for j in row) for row in idx]


def seq_to_mutations(seq: str, wt: str, offset: int = 0,
                     focus_only: bool = True) -> list[tuple[int, str, str]]:
    """Mutations of ``seq`` relative to ``wt`` as (pos, wt_aa, mut_aa) tuples.

    Parity with data_utils.seq2mutation_fromwt (data_utils.py:196-206):
    lowercase WT positions are skipped when ``focus_only``.
    """
    muts = []
    for i in range(offset, offset + len(seq)):
        if wt[i - offset].islower() and focus_only:
            continue
        if seq[i - offset].upper() != wt[i - offset].upper():
            muts.append((i, wt[i - offset].upper(), seq[i - offset].upper()))
    return muts


def mutation_names(seq: str, wt: str, offset: int = 1) -> str:
    """Human-readable mutation string, e.g. 'A12G:K90R' (1-indexed default)."""
    muts = seq_to_mutations(seq, wt)
    return ":".join(f"{w}{p + offset}{m}" for p, w, m in muts)
