"""File IO: FASTA parsing.

Counterpart of ``read_fasta`` in ``ppde_tpu/io.py`` (a copy: the port
imports nothing of the JAX package). The alignment readers wait for the
metrics port.
"""
from __future__ import annotations


def read_fasta(filename: str, return_ids: bool = False):
    """Parse a FASTA file -> list of sequences (and optionally ids).

    The id is the first whitespace-delimited token after '>'.
    """
    seqs, ids = [], []
    cur = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                ids.append(line[1:].split()[0])
            else:
                cur.append(line)
    if cur:
        seqs.append("".join(cur))
    if return_ids:
        return seqs, ids
    return seqs
