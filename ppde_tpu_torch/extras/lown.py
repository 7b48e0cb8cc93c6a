"""Low-N engineering utilities (reference third_party/biswas/{utils,constants}.py).

A copy of ``ppde_tpu/extras/lown.py`` (numpy only; the port imports nothing
of the JAX package).

The reference vendors these from the Biswas et al. low-N paper toolchain;
nothing in its own pipeline imports them and their internal import is broken
(biswas/utils.py:15 imports a nonexistent module — SURVEY.md §2 #26). They
are reimplemented here in working, dependency-free form for feature parity:
edit-distance matrices, alternate-alphabet one-hot encoders, AA->DNA codon
selection, and edit strings, plus the GFP / beta-lactamase constants.
"""
from __future__ import annotations

import numpy as np

# Alternate alphabet ordering used by the low-N encoders (alphabetical, same
# as ours) and a minimal standard codon table (most-used E. coli codon per
# AA) for naive codon optimization.
PREFERRED_CODON = {
    "A": "GCG", "C": "TGC", "D": "GAT", "E": "GAA", "F": "TTT", "G": "GGC",
    "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTG", "M": "ATG", "N": "AAC",
    "P": "CCG", "Q": "CAG", "R": "CGT", "S": "AGC", "T": "ACC", "V": "GTG",
    "W": "TGG", "Y": "TAT", "*": "TAA",
}

# Wild-type constants carried by the reference toolkit (UniProt canonical).
AVGFP_WT = (
    "SKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTLSYGVQCFSRY"
    "PDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNS"
    "HNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVL"
    "LEFVTAAGITHGMDELYK"
)
BLAC_SIGNAL_PEPTIDE = "MSIQHFRVALIPFFAAFCLPVFA"


def levenshtein(a: str, b: str) -> int:
    """Edit distance (insert/delete/substitute)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def levenshtein_matrix(seqs: list[str]) -> np.ndarray:
    """Pairwise edit-distance matrix [N, N]."""
    n = len(seqs)
    out = np.zeros((n, n), np.int32)
    for i in range(n):
        for j in range(i + 1, n):
            d = levenshtein(seqs[i], seqs[j])
            out[i, j] = out[j, i] = d
    return out


def hamming(a: str, b: str) -> int:
    assert len(a) == len(b)
    return sum(x != y for x, y in zip(a, b))


def onehot_alt(seqs: list[str], alphabet: str) -> np.ndarray:
    """One-hot in an arbitrary alphabet ordering -> [N, L, |alphabet|]."""
    table = {c: i for i, c in enumerate(alphabet)}
    L = max(len(s) for s in seqs)
    out = np.zeros((len(seqs), L, len(alphabet)), np.float32)
    for n, s in enumerate(seqs):
        for i, c in enumerate(s):
            out[n, i, table[c]] = 1.0
    return out


def aa_to_dna(seq: str) -> str:
    """Naive codon optimization: the preferred codon per residue."""
    return "".join(PREFERRED_CODON[c] for c in seq.upper())


def edit_string(seq: str, wt: str, offset: int = 1) -> str:
    """Mutations vs wt as 'A23T:K45R' (1-indexed by default)."""
    muts = [f"{w}{i + offset}{s}" for i, (w, s) in enumerate(zip(wt, seq))
            if w != s]
    return ":".join(muts) if muts else "WT"


def apply_edit_string(edits: str, wt: str, offset: int = 1) -> str:
    """Inverse of edit_string."""
    if edits.upper() == "WT":
        return wt
    chars = list(wt)
    for m in edits.replace(";", ":").replace(",", ":").split(":"):
        idx = int(m[1:-1]) - offset
        assert chars[idx] == m[0], f"wt mismatch at {m}"
        chars[idx] = m[-1]
    return "".join(chars)
