"""Checkpoint/resume for sampler runs.

Counterpart of ``ppde_tpu/checkpoint.py``: at a segment boundary a run can
persist (chain state, random state, steps done, accumulated records), so a
long run survives preemption and resumes bit for bit.

Format: a directory with
  * state.npz: the flattened sampler state, the sampler's
    ``torch.Generator`` state and the step counter;
  * records.npz: the per-step records concatenated so far.
Each file is written to a temporary name and moved into place with
``os.replace``. The state's structure is supplied by the caller on restore
(it is a function of the run configuration).

The state is a tree of tuples, lists, dicts (keys in sorted order) and
dataclasses; ``None`` holds no leaf. Its leaves are tensors (a bfloat16
tensor is stored as its int16 bits, numpy has no bfloat16) and Python ints
and floats (the samplers' host step counters), each stored with its type,
so a resumed counter comes back an ``int``. A leaf is named by its path as
``jax.tree_util.keystr`` names it (``[1][0]``, ``['x1']``).

Checkpoints are not read across packages: the JAX package stores a PRNG
key where this one stores a generator state, and ``load`` refuses a
``state.npz`` that holds a key.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from ppde_tpu_torch.parallel import mesh as pmesh


def _atomic_savez(path: str, **arrays):
    """np.savez through a temporary file and a rename. On a device mesh
    only rank 0 writes (every rank holds the same replicated state)."""
    if not pmesh.is_lead():
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _children(tree):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in the order ``jax.tree`` flattens the same tree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for key, child in kids
            for pl in flatten_with_paths(child, prefix + key)]


def unflatten(like, leaves):
    """``like`` with its leaves taken, in order, from the iterator."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: unflatten(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, leaves) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return next(leaves)


def _kind(leaf) -> str:
    """The type a leaf is stored and checked as: a torch dtype's name, or
    ``int`` / ``float`` for a host number."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float)):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: "
                        "leaves must be tensors, ints or floats")
    return type(leaf).__name__


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int64 if isinstance(leaf, int)
                          else np.float64)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item())
    t = torch.from_numpy(np.array(arr))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def save(ckpt_dir: str, state, generator_state: torch.Tensor,
         steps_done: int, records: dict | None):
    """Persist sampler state at a segment boundary (atomic).

    generator_state: the sampler's ``torch.Generator.get_state()`` (a CPU
    uint8 tensor, also for a CUDA generator). Every record value is
    persisted: arrays as they are, scalars (Python floats / ints, e.g.
    steps_per_sec) as 0-d arrays that ``load`` converts back. A value that
    does not convert to a numeric array raises here, naming the key."""
    flat = [a for _, a in flatten_with_paths(state)]
    kinds = {f"kind{i}": np.asarray(_kind(a)) for i, a in enumerate(flat)}
    _atomic_savez(os.path.join(ckpt_dir, "state.npz"),
                  generator_state=generator_state.cpu().numpy(),
                  steps_done=np.asarray(steps_done),
                  n_leaves=np.asarray(len(flat)), **kinds,
                  **{f"leaf{i}": _to_numpy(a) for i, a in enumerate(flat)})
    if records:
        out = {}
        for k, v in records.items():
            arr = np.asarray(v)
            if arr.dtype == object:
                raise TypeError(
                    f"checkpoint record {k!r}: value of type "
                    f"{type(v).__name__} does not convert to a numeric "
                    "array; records must be arrays or scalars")
            out[k] = arr
        _atomic_savez(os.path.join(ckpt_dir, "records.npz"), **out)


def exists(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "state.npz"))


def load(ckpt_dir: str, state_like):
    """Restore (state, generator_state, steps_done, records).

    ``state_like`` gives the structure; each tensor is restored to the
    device of its ``state_like`` leaf. Every leaf is checked against
    ``state_like``'s shape and type, naming the leaf by its path: a changed
    run configuration fails here with a readable error."""
    path = os.path.join(ckpt_dir, "state.npz")
    z = np.load(path)
    if "generator_state" not in z.files:
        what = ("a JAX PRNG key: it was written by the JAX package"
                if "key" in z.files else "no generator state")
        raise ValueError(
            f"checkpoint {path} holds {what}; checkpoints are not read "
            "across packages, so start this run in a new checkpoint_dir")
    flat = flatten_with_paths(state_like)
    if int(z["n_leaves"]) != len(flat):
        raise ValueError(
            f"checkpoint has {int(z['n_leaves'])} leaves, run config "
            f"produces {len(flat)}: configuration mismatch")
    leaves = []
    for i, (name, like) in enumerate(flat):
        arr, kind = z[f"leaf{i}"], str(z[f"kind{i}"])
        name = name or f"leaf{i}"
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {name}: stored shape {tuple(arr.shape)} != "
                f"configured {shape}; the run configuration changed since "
                "this checkpoint was written")
        if kind != _kind(like):
            raise ValueError(
                f"checkpoint leaf {name}: stored dtype {kind} != configured "
                f"{_kind(like)}; the run configuration changed since this "
                "checkpoint was written")
        leaves.append(_from_numpy(arr, like))
    state = unflatten(state_like, iter(leaves))
    generator_state = torch.from_numpy(np.array(z["generator_state"]))
    steps_done = int(z["steps_done"])
    records = {}
    rp = os.path.join(ckpt_dir, "records.npz")
    if os.path.exists(rp):
        try:
            rz = np.load(rp)
            # 0-d arrays are persisted scalars. np.load of an .npz is lazy:
            # a corrupt member only surfaces at rz[k], so extraction sits
            # inside the same guard as the header open
            records = {k: (rz[k].item() if rz[k].ndim == 0 else rz[k])
                       for k in rz.files}
        except Exception as e:
            raise ValueError(
                f"checkpoint records file {rp} is unreadable "
                f"({type(e).__name__}: {e}); delete it (state.npz alone "
                "resumes without histories) or restore it") from e
    return state, generator_state, steps_done, records


def validate_records(prior: dict, fresh: dict, *,
                     skip: tuple = ("oracle",)) -> None:
    """Check that resumed record histories concatenate with the records a
    fresh segment produces, naming the offending key.

    ``prior`` arrays carry a leading step axis accumulated so far; ``fresh``
    values are one segment's records [seg_len, ...]. Scalars in ``prior``
    (persisted throughput numbers) are ignored: they are recomputed every
    run. Keys in ``skip`` have their own cadence (the oracle logs at
    segment boundaries, not per step)."""
    fresh_keys = {k for k, v in fresh.items() if np.ndim(v) >= 1}
    prior_keys = {k for k, v in prior.items()
                  if np.ndim(v) >= 1 and k not in skip}
    missing = prior_keys - fresh_keys
    extra = fresh_keys - prior_keys
    if missing:
        raise ValueError(
            f"checkpoint records carry keys {sorted(missing)} the resumed "
            "run no longer produces; the run configuration changed since "
            "this checkpoint was written")
    if extra:
        raise ValueError(
            f"resumed run produces record keys {sorted(extra)} absent from "
            "the checkpoint; the run configuration changed since this "
            "checkpoint was written")
    for k in sorted(prior_keys):
        ps, fs = np.shape(prior[k])[1:], np.shape(fresh[k])[1:]
        if ps != fs:
            raise ValueError(
                f"checkpoint record {k!r}: stored per-step shape {ps} != "
                f"resumed run's {fs}; the run configuration changed since "
                "this checkpoint was written")
