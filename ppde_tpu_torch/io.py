"""File IO: FASTA and A2M alignment parsing, sharded text files.

A copy of ``ppde_tpu/io.py`` (pure Python: the port imports nothing of the
JAX package). Dependency-free reimplementations of the behaviors the
reference gets from BioPython + DeepSequence helpers (reference:
third_party/hsu/io_utils.py:178-188 and ppde/utils.py:31-104).
"""
from __future__ import annotations

import os
from collections import OrderedDict

ALIGNMENT_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


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


def load_msa(filename: str) -> list[tuple[str, str]]:
    """Load an .a2m MSA restricted to focus columns.

    Semantics match the reference loader (ppde/utils.py:31-104), which was
    itself stripped from DeepSequence:
      * focus columns = positions where the first (focus) sequence is
        uppercase (gaps '-' count as uppercase);
      * '.' is mapped to '-', everything uppercased;
      * sequences containing characters outside the 20-AA alphabet + '-'
        in their focus columns are dropped.

    Returns a list of (name, focus_column_sequence) pairs; the focus sequence
    is first.
    """
    seq_by_name: "OrderedDict[str, str]" = OrderedDict()
    name = ""
    with open(filename) as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                name = line
                seq_by_name.setdefault(name, "")
            else:
                seq_by_name[name] = seq_by_name.get(name, "") + line

    names = list(seq_by_name.keys())
    focus_seq = seq_by_name[names[0]]
    focus_cols = [i for i, s in enumerate(focus_seq) if s == s.upper()]

    alphabet_set = set(ALIGNMENT_ALPHABET)
    out = []
    for n in names:
        s = seq_by_name[n].replace(".", "-")
        focus = "".join(s[i].upper() for i in focus_cols)
        if any((c not in alphabet_set and c != "-") for c in focus):
            continue
        out.append((n, focus))
    return out


def focus_columns(filename: str) -> list[int]:
    """Indices (0-based, within the focus sequence) of the focus columns."""
    with open(filename) as f:
        lines = f.read().splitlines()
    # first record's full sequence
    seq = []
    started = False
    for line in lines:
        if line.startswith(">"):
            if started:
                break
            started = True
            continue
        if started:
            seq.append(line.rstrip())
    focus_seq = "".join(seq)
    return [i for i, s in enumerate(focus_seq) if s == s.upper()]


def msa_region(filename: str) -> tuple[str, int, int]:
    """Return (uniprot_id, start, end) parsed from the focus id
    '>NAME/START-END' (start 1 and end -1 without a region)."""
    with open(filename) as f:
        for line in f:
            if line.startswith(">"):
                header = line[1:].strip().split()[0]
                break
    if "/" in header:
        name, region = header.rsplit("/", 1)
        start, end = region.split("-")
        return name, int(start), int(end)
    return header, 1, -1


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def save_txt_sharded(lines: list[str], prefix: str,
                     n_shards: int) -> list[str]:
    """Write lines round-robin into ``{prefix}-{i}-of-{n}.txt`` shards
    (capability parity with the reference's sharded txt IO,
    third_party/hsu/io_utils.py:105-151)."""
    ensure_dir(os.path.dirname(prefix) or ".")
    paths = [f"{prefix}-{i:05d}-of-{n_shards:05d}.txt"
             for i in range(n_shards)]
    handles = [open(p, "w") for p in paths]
    try:
        for i, line in enumerate(lines):
            handles[i % n_shards].write(line.rstrip("\n") + "\n")
    finally:
        for h in handles:
            h.close()
    return paths


def load_txt_sharded(prefix: str) -> list[str]:
    """Read back shards written by save_txt_sharded, restoring order."""
    import glob

    paths = sorted(glob.glob(f"{prefix}-*-of-*.txt"))
    if not paths:
        raise FileNotFoundError(f"no shards match {prefix}-*-of-*.txt")
    shards = []
    for p in paths:
        with open(p) as f:
            shards.append([line.rstrip("\n") for line in f])
    out = []
    for i in range(sum(len(s) for s in shards)):
        out.append(shards[i % len(shards)][i // len(shards)])
    return out
