"""The port's instrumentation: spans, launch counters, and the reading of a
trace.

  * ``span(name)``: a named region. While a torch profiler records, it is
    ``torch.profiler.record_function(name)``, so the span lands in the
    profiler's Chrome trace beside the device activity, on its clock;
    otherwise it is one shared no-op context (no allocation, no dispatcher
    call). Nothing else switches it on.
  * ``grad_spans()`` and ``grad_span(t, name)``: the spans of a backward
    pass by the kind of the forward work it differentiates (see below).
  * ``count(name, n=1)`` and ``counters()``: the one registry of launch
    counters; ``counter_attributes`` keeps a module's old attribute names
    readable.
  * ``trace(dir)``: records a ``torch.profiler`` trace (CPU and CUDA
    activities) around any section and writes it into ``dir`` as a Chrome
    trace (``trace.json``).
  * ``device_by_span(dir)``: a ``trace`` directory's device time and
    kernels by the innermost program span open at each launch.

The program's spans (``SPANS``), where the work happens:

  sampler.setup        ``ppde.run`` up to the first step (the initial energy)
                       and ``base.run_segmented`` up to it (the oracle at 0)
  sampler.step         each outer step (``run_segmented``)
  sampler.segment_end  a segment's sync, records to the host, oracle, log
                       and checkpoint
  sampler.finish       ``_records`` and ``package_result``
  ppde.proposal        the forward path of a PPDE step (``make_step``)
  ppde.accept          the reverse path, MH, bests and the nmut reset
  energy               ``energy_and_grad`` of ``protein_poe`` and
                       ``protein_supervised``; inside it energy.cnn,
                       energy.potts and energy.esm2 or energy.msa (the
                       terms' sums stay in ``energy`` itself)
  esm2.<kind>          ESM2's forward (``models/esm2.py``): embed, norm (a
                       layer norm: ``ops/layer_norm_fused``), qkv (the three
                       projections), rotary (their head-major layout, q
                       scale and rotary: ``ops/rotary_fused``), attn_out
                       (head merge, o projection, residual), ffn (fc1, GELU,
                       fc2, residual), head (final and LM norms, lm_dense,
                       logits, log-softmax, PLL)
  esm2.backward        ``torch.autograd.grad`` of the transformer term
  esm2.bwd.<kind>      inside it, the backward of each forward kind
  msa.<kind>           the MSA Transformer expert's forward
                       (``models/msa_transformer.py::expert_score``): embed
                       (the chain's row 0 and the context rows), norm, qkv,
                       row (tied row attention: ``ops/row_attention_fused``),
                       col (column attention's head-major copies around
                       kernel C), attn_out, ffn, head
  msa.backward         ``torch.autograd.grad`` of its term
  msa.bwd.<kind>       inside it, the backward of each forward kind but
                       row, whose backward is kernel T' alone
  kernel.a, kernel.b,  inside each kernel wrapper, around its launch
  kernel.c, kernel.c_bwd,
  kernel.t, kernel.t_bwd

Backward spans: autograd runs a node's backward just after the tensor
hooks of the tensor it made. ``grad_span(t, name)`` hooks t so that, when
the backward of the work that made t begins, the open backward span closes
and ``name`` opens (``None`` only closes it); on CUDA the hooks run on
autograd's device thread, so a span opens and closes on one thread. The
hooks are registered only inside ``grad_spans()`` while a profiler
records, and each returns ``None``: the graph and the gradient are those of
an untraced run.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os

import torch
import torch.autograd.profiler as _autograd_profiler

SPANS = frozenset({
    "sampler.setup", "sampler.step", "sampler.segment_end", "sampler.finish",
    "ppde.proposal", "ppde.accept",
    "energy", "energy.cnn", "energy.potts", "energy.esm2", "energy.msa",
    "esm2.embed", "esm2.norm", "esm2.qkv", "esm2.rotary", "esm2.attn_out",
    "esm2.ffn", "esm2.head", "esm2.backward",
    "esm2.bwd.embed", "esm2.bwd.norm", "esm2.bwd.qkv", "esm2.bwd.rotary",
    "esm2.bwd.attn_out", "esm2.bwd.ffn", "esm2.bwd.head",
    "msa.embed", "msa.norm", "msa.qkv", "msa.row", "msa.col", "msa.attn_out",
    "msa.ffn", "msa.head", "msa.backward",
    "msa.bwd.embed", "msa.bwd.norm", "msa.bwd.qkv", "msa.bwd.col",
    "msa.bwd.attn_out", "msa.bwd.ffn", "msa.bwd.head",
    "kernel.a", "kernel.b", "kernel.c", "kernel.c_bwd", "kernel.t",
    "kernel.t_bwd",
})
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records now."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """``with span("energy"): ...``: a span in the trace while a profiler
    records, else the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# the backward spans: on while grad_spans() is open and a profiler records;
# the one open backward span, (name, record_function)
_grad_hooks = False
_open_grad: list = []


def _switch(name, grad):
    if _open_grad and _open_grad[-1][0] == name:
        return None
    if _open_grad:
        _open_grad.pop()[1].__exit__(None, None, None)
    if name is not None:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        _open_grad.append((name, rf))
    return None


def grad_span(t: torch.Tensor, name: str | None) -> torch.Tensor:
    """t, hooked (inside ``grad_spans()`` while a profiler records) so that
    the backward of the work that made t runs in the span ``name``."""
    if _grad_hooks and t.requires_grad:
        t.register_hook(functools.partial(_switch, name))
    return t


@contextlib.contextmanager
def grad_spans():
    """The block's forward passes hook their tensors (``grad_span``) when
    a profiler records; a backward span still open at the end is closed."""
    global _grad_hooks
    _grad_hooks = recording()
    try:
        yield
    finally:
        _grad_hooks = False
        _switch(None, None)


# the launch counters: name -> launches counted since the process started
_counts: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name`` (n = 0 declares it)."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


def counter_attributes(attrs: dict[str, str]):
    """A module ``__getattr__`` that reads the counters ``attrs`` maps the
    module's attribute names to (declared here at 0)."""
    for name in attrs.values():
        count(name, 0)

    def getattr_(attr):
        if attr in attrs:
            return _counts[attrs[attr]]
        raise AttributeError(attr)
    return getattr_


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace('/tmp/trace'): run()``.
    CUDA activity is recorded when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_by_span(log_dir: str) -> dict:
    """Device activity of ``trace(log_dir)``'s trace by the innermost
    program span open, on any host thread, at its launch: ``{span or None:
    {"us": device microseconds, "kernels": kernels}}``, and under
    ``"unmatched"`` the activities whose launch call is missing from the
    trace (the launch calls with the nearest correlation ids before and
    after bound its time; the innermost span open over both is taken)."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name") in SPANS), key=lambda e: e["ts"])
    starts = [s["ts"] for s in spans]
    parent, stack = [], []
    for i, s in enumerate(spans):
        while stack and _end(spans[stack[-1]]) < s["ts"]:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = e["ts"]
    ids = sorted(launch)

    def innermost(t0, t1):
        j = bisect.bisect_right(starts, t0) - 1
        j = j if j >= 0 else None
        while j is not None and _end(spans[j]) < t1:
            j = parent[j]
        return None if j is None else spans[j]["name"]

    out: dict = {"unmatched": 0}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        c = (e.get("args") or {}).get("correlation")
        if c in launch:
            name = innermost(launch[c], launch[c])
        else:
            out["unmatched"] += 1
            name = None
            if c is not None and ids:
                i = bisect.bisect_left(ids, c)
                lo, hi = launch[ids[max(i - 1, 0)]], launch[
                    ids[min(i, len(ids) - 1)]]
                name = innermost(min(lo, hi), max(lo, hi))
        row = out.setdefault(name, {"us": 0.0, "kernels": 0})
        row["us"] += float(e["dur"])
        row["kernels"] += e["cat"] == "kernel"
    return out


def _end(e) -> float:
    return e["ts"] + e["dur"]
