"""Sampler harness: segmented runs with device-resident histories.

Counterpart of ``ppde_tpu/samplers/base.py``. ``num_steps`` splits into
``log_every``-sized segments. Inside a segment the step function runs in a
Python loop with no host synchronisation (no ``.item()``, ``bool(tensor)``
or ``.cpu()``): its work queues on the device. Each segment ends with one
``torch.cuda.synchronize()`` inside the timed window; then its records go to
the host. With ``checkpoint_dir`` the run persists its state, its
``Draws``' generator state and its records every ``checkpoint_every``
segments (``checkpoint.py``), and resumes from them. The run's spans
(``profiling``): ``sampler.setup`` up to the first step, ``sampler.step``
around each step, ``sampler.segment_end`` from a segment's last step to the
next one's first (sync, records, oracle, log, checkpoint) and
``sampler.finish`` around the records' assembly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ppde_tpu_torch import checkpoint as ckpt
from ppde_tpu_torch import profiling


@dataclasses.dataclass
class SamplerResult:
    """Per-chain bests, histories and the final population (host arrays)."""

    best_x: np.ndarray          # [n_chains, ...] per-chain argmax-energy state
    best_energy: np.ndarray     # [n_chains]
    best_fitness: np.ndarray    # [n_chains]
    energy_history: np.ndarray  # [n_records, n_chains]
    fitness_history: np.ndarray  # [n_records, n_chains]
    random_traj: np.ndarray | None  # [n_records_traj, ...] one chain's states
    final_x: np.ndarray         # [n_chains, ...] final population
    oracle_history: np.ndarray  # [n_logs, n_chains]
    n_accepted: np.ndarray | None = None  # [n_records] accepted per step
    # sampler throughput over the segments after the first (which pays the
    # kernels' first launches), each forced complete by a synchronize
    steps_per_sec: float = 0.0
    # end-to-end throughput of the steps run in this process, incl. the
    # per-segment host work (oracle, records, checkpoint saves)
    wall_steps_per_sec: float = 0.0


def segment_lengths(num_steps: int, log_every: int) -> list[int]:
    """Split num_steps into log_every-sized segments (+ remainder)."""
    out = [log_every] * (num_steps // log_every)
    if num_steps % log_every:
        out.append(num_steps % log_every)
    return out


def _sync(state) -> None:
    """Wait for the device that holds the state's first tensor."""
    t = state
    while isinstance(t, (tuple, list)):
        t = t[0]
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Draws:
    """The random numbers of sampler steps, drawn from one torch.Generator
    on the sampler's device. Each sampler documents the order in which its
    step asks for them, so that a test can replay another source (the JAX
    package's draws) through an object with the same methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def get_state(self) -> torch.Tensor:
        """The generator's state (a CPU uint8 tensor, also on CUDA)."""
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def path_lengths(self, n: int, high: int) -> torch.Tensor:
        """[n] integers in [1, high)."""
        return torch.randint(1, high, (n,), generator=self.generator,
                             device=self.device)

    def gumbel(self, shape) -> torch.Tensor:
        # -log(E), E ~ Exp(1): the Gumbel(0, 1) law in three launches
        e = torch.empty(shape, device=self.device)
        return e.exponential_(generator=self.generator).log_().neg_()

    def uniform(self, shape, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """U[low, high) of ``shape`` (an int n gives [n])."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        if (low, high) == (0.0, 1.0):
            return u
        return (u * (high - low) + low).clamp_(min=low)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def poisson(self, rate: torch.Tensor) -> torch.Tensor:
        """Poisson(rate) counts, elementwise, as float."""
        return torch.poisson(rate, generator=self.generator)

    def randint(self, high: int, shape) -> torch.Tensor:
        """Integers in [0, high)."""
        return torch.randint(0, high, shape, generator=self.generator,
                             device=self.device)


def run_segmented(*, step_fn: Callable, ctx: Any, init_state: Any,
                  draws: Any, num_steps: int, log_every: int,
                  oracle_fn: Callable | None = None,
                  log_fn: Callable | None = None,
                  quiet: bool = False, checkpoint_dir: str | None = None,
                  checkpoint_every: int = 1) -> tuple[Any, dict]:
    """Drive ``step_fn`` for ``num_steps`` in segments.

    step_fn: (ctx, state, draws) -> (state, ys); ys is a dict of per-step
    records (at minimum 'energy' and 'fitness', each [n_chains]).
    draws: the source of every random number a step uses (``Draws``).
    oracle_fn: (ctx, state) -> [n_chains] ground-truth scores.
    checkpoint_dir: if set, (state, generator state, step, records) persist
    every ``checkpoint_every`` segments, and the run resumes from an
    existing checkpoint: the oracle is not evaluated again at step 0 (its
    history comes from the checkpoint). ``draws`` must then have
    ``get_state`` / ``set_state``.
    """
    if checkpoint_dir is not None and not hasattr(draws, "get_state"):
        raise TypeError(
            f"a run with checkpoint_dir needs draws with get_state and "
            f"set_state; {type(draws).__name__} has none, so its random "
            "state cannot be checkpointed")
    state = init_state
    all_ys: list[dict] = []
    oracle_hist: list = []
    start_steps = 0
    resumed_with_records = False
    with profiling.span("sampler.setup"):
        if checkpoint_dir is not None and ckpt.exists(checkpoint_dir):
            state, gen_state, start_steps, prior = ckpt.load(checkpoint_dir,
                                                             init_state)
            draws.set_state(gen_state)
            if prior:
                oracle_hist = list(prior.pop("oracle", []))
                # persisted scalars (steps_per_sec etc.) are recomputed
                # each run; only array histories are carried into the
                # concat path
                prior = {k: v for k, v in prior.items() if np.ndim(v) >= 1}
                if prior:
                    all_ys.append(prior)
                    resumed_with_records = True
            if not quiet:
                print(f"[resume] restored checkpoint at step {start_steps} "
                      f"from {checkpoint_dir}", flush=True)
        else:
            if oracle_fn is not None:
                oracle_hist.append(oracle_fn(ctx, state).cpu().numpy())
            if log_fn is not None and not quiet:
                log_fn(0, state, None,
                       oracle_hist[-1] if oracle_hist else None)

    t0 = time.perf_counter()
    seg_times: list[tuple[int, float]] = []
    done = start_steps
    for seg_idx, length in enumerate(
            segment_lengths(num_steps - start_steps, log_every), 1):
        ts = time.perf_counter()
        seg: list[dict] = []
        for _ in range(length):
            with profiling.span("sampler.step"):
                state, ys = step_fn(ctx, state, draws)
            seg.append(ys)
        with profiling.span("sampler.segment_end"):
            _sync(state)
            seg_times.append((length, time.perf_counter() - ts))
            done += length
            ys_host = {k: torch.stack([y[k] for y in seg]).cpu().numpy()
                       for k in seg[0]}
            if resumed_with_records:
                # fail with a named key if the resumed config's records
                # can't concatenate onto the checkpointed histories
                ckpt.validate_records(all_ys[0], ys_host)
                resumed_with_records = False
            all_ys.append(ys_host)
            if oracle_fn is not None:
                oracle_hist.append(oracle_fn(ctx, state).cpu().numpy())
            if log_fn is not None and not quiet:
                log_fn(done, state, all_ys[-1],
                       oracle_hist[-1] if oracle_hist else None)
            if checkpoint_dir is not None and seg_idx % checkpoint_every == 0:
                ckpt.save(checkpoint_dir, state, draws.get_state(), done,
                          _records(all_ys, oracle_hist))
            seg.clear()  # the segment's device records are freed here
    with profiling.span("sampler.finish"):
        _sync(state)
        elapsed = time.perf_counter() - t0
        records = _records(all_ys, oracle_hist)
    # the first segment pays the first launches (and, on a fresh checkout,
    # the kernels' build): drop it from the throughput window when warm
    # segments exist
    warm = seg_times[1:] if len(seg_times) > 1 else seg_times
    warm_steps = sum(n for n, _ in warm)
    warm_time = sum(t for _, t in warm)
    records["steps_per_sec"] = warm_steps / max(warm_time, 1e-9)
    records["wall_steps_per_sec"] = (done - start_steps) / max(elapsed, 1e-9)
    return state, records


def _records(all_ys: list[dict], oracle_hist: list) -> dict:
    """The per-step records concatenated over segments, and the oracle's
    history stacked over its evaluations."""
    records = {}
    if all_ys:
        records = {k: np.concatenate([y[k] for y in all_ys], axis=0)
                   for k in all_ys[0]}
    records["oracle"] = (np.stack(oracle_hist, 0) if oracle_hist
                         else np.zeros((0,)))
    return records


def default_log(tag: str):
    """Reference-style quantile log lines (protein ppde.py:54-56,164-170)."""

    def log_fn(step, state, ys, oracle_scores):
        def q(v):
            return np.quantile(np.asarray(v, dtype=np.float64), [0.5, 0.9])

        parts = [f"[{tag} iter {step}]"]
        if ys is not None:
            eq, fq = q(ys["energy"][-1]), q(ys["fitness"][-1])
            parts.append(f"energy 50% {eq[0]:.3f} 90% {eq[1]:.3f};")
            parts.append(f"pred fit 50% {fq[0]:.3f} 90% {fq[1]:.3f};")
            if "accepted" in ys:
                parts.append(f"#accepted {int(ys['accepted'][-1].sum())};")
        if oracle_scores is not None:
            oq = q(oracle_scores)
            parts.append(f"oracle 50% {oq[0]:.3f} 90% {oq[1]:.3f}")
        print(" ".join(parts), flush=True)

    return log_fn


def update_best(best, new_e, new_fit, new_x):
    """Running per-chain argmax-energy tracker (first max wins: strict >,
    matching the reference's torch.max over history)."""
    best_e, best_fit, best_x = best
    better = new_e > best_e
    bx = torch.where(better.reshape((-1,) + (1,) * (new_x.ndim - 1)), new_x,
                     best_x)
    return (torch.where(better, new_e, best_e),
            torch.where(better, new_fit, best_fit), bx)


def package_result(*, e0, fit0, x0_traj_head, best, final_x, rec,
                   traj_key: str = "traj",
                   traj_tokens: bool = False) -> SamplerResult:
    """Assemble the standard SamplerResult from the records.

    traj_tokens: the per-step traj records are int token vectors [L]; the
    one-hot [n, L, V] trajectory is rebuilt here on the host. Other integer
    traj records (the MNIST samplers' uint8 images) become float32.
    """
    best_e, best_fit, best_x = (t.cpu().numpy() for t in best)
    traj = None
    if traj_key in rec:
        t = np.asarray(rec[traj_key])
        head = x0_traj_head.cpu().numpy()
        if traj_tokens:
            t = np.eye(head.shape[-1], dtype=np.float32)[t.astype(np.int64)]
        elif np.issubdtype(t.dtype, np.integer):
            t = t.astype(np.float32)  # uint8 binary images -> float
        traj = np.concatenate([head[None], t], 0)
    return SamplerResult(
        best_x=best_x, best_energy=best_e, best_fitness=best_fit,
        energy_history=np.concatenate(
            [e0.cpu().numpy()[None], rec["energy"]], 0),
        fitness_history=np.concatenate(
            [fit0.cpu().numpy()[None], rec["fitness"]], 0),
        random_traj=traj,
        final_x=final_x.cpu().numpy(),
        oracle_history=rec["oracle"],
        n_accepted=(rec["accepted"].sum(-1) if "accepted" in rec else None),
        steps_per_sec=rec["steps_per_sec"],
        wall_steps_per_sec=rec.get("wall_steps_per_sec", 0.0),
    )
