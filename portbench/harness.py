"""One run of one cell: set-up, the measured window, the judgement, the
metrics.

The window drives the users' own entry, ``samplers.protein.ppde.run``, as
the protein CLI calls it (PPDE-PAS, the whole sequence mutable, segments of
``log_every`` steps through ``base.run_segmented``, quiet, no oracle and no
checkpoints), on the energy the CLI assembles
(``runtime.build_protein_energy``) from a protein directory that
``proteins.py`` writes from the seed. So the program decides the energy's
pieces, chunks and precisions. The window is one call, sized from the
set-up's last warm call to fill ``seconds``; its rate is chains times steps
over the call's seconds, start to return.

A traced run (``trace``) runs a window of at most ``TRACE_SECONDS``
untraced, then the same window again under ``torch.profiler`` with the
spans of ``trace.py``, and reports the per-layer metrics instead of the
end-to-end ones: device times from the trace, host seconds from the
untraced window. Both kinds judge their (last) window's outputs
(``compare.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import (compare, experts, program_spans, proteins, reference,
                       trace, yardstick)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_SECONDS = 5.0   # longest traced window
SIZING_SECONDS = 0.25  # least length of the call that sizes the window
WINDOW_SPAN = "window.ppde_run"
# chains a block of the reference's autograd (an expert's module may ask
# for fewer)
REFERENCE_BLOCK = 256
FORBIDDEN = ("jax", "jaxlib", "flax", "ppde_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared as whole names (``ppde_tpu_torch`` is not ``ppde_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: str = ROOT) -> dict:
    """Everything a cell needs, found by name from ``BENCHMARK.json``: its
    entry, its configuration's file, its traffic's file
    (``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and
    the metrics it reports, end to end and per layer."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "cell": cell,
        "config": load_json(os.path.join(root, cfg["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters() -> dict:
    """Every kernel's launch counter (``trace.kernels()``), by key."""
    return {k: getattr(importlib.import_module(mod), attr)
            for k, (mod, _, attr) in trace.kernels().items()}


class Capture:
    """The energy's ``energy_and_grad``, passed through, keeping its last
    call's input and outputs (references only: no device work) and the
    number of calls."""

    def __init__(self, fn):
        self.fn, self.calls, self.last = fn, 0, None

    def __call__(self, params, x):
        out = self.fn(params, x)
        self.calls += 1
        self.last = (x, out)
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the CLI's ``--compute_dtype`` of the Potts and CNN terms, by the
# configuration's ``dtype``; each expert checks its own
COMPUTE_DTYPES = {"float32": "f32", "bfloat16": "bf16"}
SAMPLER = "PPDE-PAS"


def cli_settings(config: dict) -> dict:
    """The settings of the run that the configuration states, in the CLI's
    terms; a configuration the program cannot run as stated is refused."""
    s = config["sampler"]
    if s["sampler"] != SAMPLER:
        raise ValueError(f"sampler {s['sampler']!r}: the window drives "
                         f"{SAMPLER} alone")
    dts = {config["potts"]["dtype"], config["cnn"]["dtype"]}
    if len(dts) != 1 or not dts <= set(COMPUTE_DTYPES):
        raise ValueError(f"Potts and CNN dtypes {sorted(dts)}: the CLI runs "
                         f"both in one of {sorted(COMPUTE_DTYPES)}")
    for _, mod, cfg in experts.of(config):
        mod.check_dtype(cfg)
    return {"compute_dtype": COMPUTE_DTYPES[dts.pop()],
            "pas_length": int(s["pas_length"]),
            "nmut_threshold": int(s["nmut_threshold"]),
            "temp": float(s["temp"])}


def build(config: dict, traffic: dict, seed: int, tmp: str, device,
          log=None):
    """The protein directory from the seed and the energy the CLI
    assembles from it; returns (paths, energy, population). The program
    decides, as for the CLI's defaults, B's chunks and the max-pool's
    backward; each expert's module gives its own CLI term and arguments;
    the configuration states the compute type."""
    from ppde_tpu_torch import runtime

    name = traffic["protein"]
    t0 = time.perf_counter()
    paths = proteins.write(tmp, name, config, traffic, seed, device)
    t1 = time.perf_counter()
    terms, extra = ["potts"], {}
    for key, mod, cfg in experts.of(config):
        terms.append(mod.cli_term(cfg))
        extra.update(mod.cli_args(cfg, paths["experts"][key]))
    args = SimpleNamespace(
        protein_weights=tmp, protein=name,
        energy_function="product_of_experts",
        unsupervised_expert="+".join(terms),
        energy_lamda=float(config["energy_lamda"]),
        n_chains=int(traffic["n_chains"]), potts_npz=paths["potts"],
        compute_dtype=cli_settings(config)["compute_dtype"], cnn_chunk=0,
        pool_bwd="split", **extra)
    energy, _, _, _ = runtime.build_protein_energy(args, device)
    pop = runtime.make_initial_protein_population(paths["dir"],
                                                  args.n_chains, device)
    if log is not None:
        log(f"set-up: protein directory written {t1 - t0:.3f} s, energy "
            f"assembled {time.perf_counter() - t1:.3f} s")
    return paths, energy, pop


def sampler_call(energy, pop, steps: int, config: dict, traffic: dict,
                 gen, device):
    """One call of the users' entry, as the CLI makes it."""
    from ppde_tpu_torch.samplers.protein import ppde

    st = cli_settings(config)
    cfg = ppde.PPDEConfig(pas_length=st["pas_length"],
                          nmut_threshold=st["nmut_threshold"],
                          temp=st["temp"])
    return ppde.run(energy=energy, initial_population=pop, num_steps=steps,
                    min_pos=0, max_pos=pop.shape[1] - 1, oracle=None,
                    cfg=cfg, generator=gen,
                    log_every=int(traffic["log_every"]), quiet=True,
                    device=device)


def window_steps(seconds: float, per_step: float, log_every: int) -> int:
    """Whole segments that fill ``seconds`` at ``per_step`` seconds a step;
    at least one."""
    return max(1, int(seconds / per_step) // log_every) * log_every


def sampler_seed(seed: int) -> int:
    """The sampler's generator seed: another stream than the weights'."""
    return (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % 2 ** 63


def traced_call(call, tmp: str):
    """(result, Attribution, window (t0, t1) in trace microseconds) of
    ``call()`` under the profiler with the spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with trace.spans(), profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            res = call()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    events = trace.read_chrome_trace(path)
    os.remove(path)
    win = next(e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("ph") == "X")
    return res, trace.Attribution(events), (win["ts"],
                                            win["ts"] + win["dur"])


def run(cell_name: str, spec: dict, seed: int, seconds: float,
        traced: bool, device, t_start: float, readings: str | None = None,
        log=print) -> dict:
    """One run; returns the result line's object. ``readings`` ("program"
    or "control") adds, under ``readings``, every gap of the program (and
    the control's at the same states), with the look behind the
    gradient's."""
    config, traffic = spec["config"], spec["traffic"]
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell_name, spec, config, traffic, seed, seconds, traced,
                    device, t_start, readings, log, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell_name, spec, config, traffic, seed, seconds, traced, device,
         t_start, readings, log, tmp):
    log(f"set-up: start to build {time.perf_counter() - t_start:.3f} s")
    paths, energy, pop = build(config, traffic, seed, tmp, device, log)
    n, L, _ = pop.shape
    cap = Capture(energy.energy_and_grad)
    en = dataclasses.replace(energy, energy_and_grad=cap)
    log_every = int(traffic["log_every"])

    # warm-up: the window's shapes, twice, then a call of at least
    # SIZING_SECONDS (by the second call's pace) that sizes the window: a
    # fresh process's second call still pays tens of ms that later calls
    # do not (1024 chains: a 15-19 ms step read for 11-12)
    warm = int(traffic["warm_steps"])
    calls = []
    for k in (warm, warm, None):
        if k is None:
            k = max(warm, math.ceil(SIZING_SECONDS * (warm + 1)
                                    / calls[-1][1]))
        gen = torch.Generator(device=device).manual_seed(seed)
        _sync(device)
        t0 = time.perf_counter()
        sampler_call(en, pop, k, config, traffic, gen, device)
        _sync(device)
        calls.append((k, time.perf_counter() - t0))
    per_step = calls[-1][1] / (calls[-1][0] + 1)
    limit_s = min(seconds, TRACE_SECONDS) if traced else seconds
    steps = window_steps(limit_s, per_step, log_every)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (warm calls "
        + ", ".join(f"{k} steps {v:.3f} s" for k, v in calls)
        + f"); step {per_step * 1e3:.3f} ms; "
        f"window of {steps} steps")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def window():
        gen = torch.Generator(device=device).manual_seed(sampler_seed(seed))
        _sync(device)
        t0 = time.perf_counter()
        res = sampler_call(en, pop, steps, config, traffic, gen, device)
        return res, time.perf_counter() - t0

    # a traced run first runs the same window untraced: its seconds give
    # the step's host time, which the profiler's own cost would inflate
    res, window_s = window()
    before = counters()
    cap.calls = 0
    if traced:
        cap.fn = trace.energy_span(energy.energy_and_grad)
        (res, _), attr, (w0, w1) = traced_call(window, tmp)
    launches = {k: v - before[k] for k, v in counters().items()}
    energy_calls = cap.calls
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # the window's outputs to the host; the program's state freed
    x_last, (e_l, fit_l, grad_l) = cap.last
    last = {"e": e_l.float().cpu().numpy(), "fit": fit_l.float().cpu().numpy(),
            "grad": grad_l.float().cpu().numpy()}
    x_last = x_last.float().cpu().numpy()
    del cap, en, energy, pop, e_l, fit_l, grad_l
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    wt = reference.onehot(paths["wt"])
    moved = (res.final_x != wt[None]).any(-1).any(-1)
    run_numbers, run_ok, why = {}, True, ""
    try:
        run_numbers = yardstick.check_run(
            res.energy_history, res.best_energy, res.best_x, res.final_x,
            int(res.n_accepted.sum()), wt,
            config["sampler"]["nmut_threshold"], steps, n)
    except yardstick.CheckFailed as exc:
        run_ok, why = False, str(exc)

    t_ref = time.perf_counter()
    exps = experts.of(config)
    raw = reference.load(paths["dir"], "potts.npz", exps, device)
    block = min([REFERENCE_BLOCK]
                + [mod.REFERENCE_BLOCK for _, mod, _ in exps])

    def values(precision):
        ref = reference.Reference(raw, float(config["energy_lamda"]),
                                  precision=precision)
        return compare.evaluate(ref, x_last, res.best_x, res.final_x, block)

    ref_vals = values("reference")
    numbers = compare.gaps(last, res.best_energy, res.energy_history[-1],
                           moved, ref_vals)
    ok, checks = compare.judge(numbers, spec["limits"])
    checks["run_checks"] = {"value": why or "passed", "limit": "all pass"}
    for k, v in run_numbers.items():
        checks[k] = {"value": v, "limit": {
            "acceptance_rate": "inside (0, 1)",
            "max_distance_final": f"< {config['sampler']['nmut_threshold']}",
            "chains_moved": ">= 1"}[k]}
    ok = ok and run_ok
    control = None
    if readings == "control":
        # the control's values in the places of the program's outputs
        ctrl = values("control")
        control = compare.gaps(ctrl, ctrl["best_e"], ctrl["final_e"], moved,
                               ref_vals)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")

    run_rec = {
        "config": config, "chains": n, "L": L, "steps": steps,
        "energy_calls": energy_calls, "setup_s": setup_s, "window_s": window_s,
        "chain_steps_per_s": n * steps / window_s, "launches": launches,
        "trace": None,
    }
    out = {"correct": bool(ok), "attempted": n * steps,
           "failed": int((~np.isfinite(res.energy_history[1:])).sum())}
    if traced:
        missing = [k for k, c in launches.items()
                   if c > 0 and attr.by_span.get(trace.PREFIX + k, 0.0) <= 0]
        checks["unattributed_kernel_classes"] = {
            "value": len(missing), "limit": 0, "classes": missing}
        out["correct"] = out["correct"] and not missing
        busy = attr.busy_us(w0, w1) * 1e-6
        run_rec["trace"] = {
            "device_s": {("sampler" if k is None
                          else k.removeprefix(trace.PREFIX)): v * 1e-6
                         for k, v in attr.by_span.items()},
            "kernels": sum(attr.kernels_by_span.values()),
            "busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "host_window_s": window_s,
            "unmatched_launches": attr.unmatched,
        }
        log("trace: " + json.dumps(run_rec["trace"]))
        run_rec["trace"]["program"] = program_spans.read(attr, w0, w1)
        out["breakdown"] = {"device_ops": attr.top_ops(),
                            "idle_gaps": attr.idle_gaps(w0, w1)}
    metrics = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        v = reader(m["name"])(run_rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        out["device"]["busy_s"] = run_rec["trace"]["busy_s"]
        out["device"]["window_s"] = run_rec["trace"]["window_s"]
    if readings is not None:
        out["readings"] = {"program": numbers, "control": control}
    out["checks"] = checks  # last: each number compared beside its limit
    return out
