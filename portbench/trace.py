"""Spans by launch site, and the reading of a profiler trace.

``spans()`` opens a named span (``torch.profiler.record_function``) around
each entry of the program's kernel wrappers: kernel A
(``potts_fused.energy_and_grad``), kernel B
(``cnn_fused.ensemble_apply_and_grad``) and each expert module's
``KERNELS`` (``kernels()``), on whichever host thread calls them. The
harness opens ``ENERGY`` around the energy's ``energy_and_grad``. They are
installed from here, for a traced run only, and taken out after it.

``Attribution`` reads a Chrome trace of ``torch.profiler``: each device
activity (kernel, memcpy, memset) belongs to the innermost span that was
open, on any host thread, when the host launched it. The profiler's
correlation id links the activity to its launch call; where that call is
missing from the trace, the launch calls with the nearest ids before and
after it bound its time, and the innermost span open over both is taken.
"""
from __future__ import annotations

import bisect
import contextlib
import json

import torch

from portbench import experts

PREFIX = "portbench."
ENERGY = PREFIX + "energy"
# key -> (wrapper module, wrapper attribute, launch counter attribute); the
# key's span is PREFIX + key
KERNELS = {
    "kernel_a": ("ppde_tpu_torch.ops.potts_fused", "energy_and_grad",
                 "launches"),
    "kernel_b": ("ppde_tpu_torch.ops.cnn_fused", "ensemble_apply_and_grad",
                 "launches"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def kernels() -> dict:
    """A's and B's entries, then every expert module's, by key."""
    out = dict(KERNELS)
    for mod in experts.modules():
        out.update(mod.KERNELS)
    return out


def _spanned(name, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def spans():
    """The kernel wrappers, each inside a span of its own, for the time of
    the block."""
    import importlib

    saved = []
    try:
        for key, (mod_name, attr, _) in kernels().items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _spanned(PREFIX + key, fn))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def energy_span(fn):
    return _spanned(ENERGY, fn)


class Attribution:
    """Device activities of a trace by the span that launched them."""

    def __init__(self, events: list[dict]):
        self.spans = sorted(
            (e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)),
            key=lambda e: e["ts"])
        self.starts = [s["ts"] for s in self.spans]
        # the spans nest (a wrapper's span lies inside the energy's, on
        # autograd's thread too): each span's parent is the innermost span
        # that was open when it started
        self.parent: list[int | None] = []
        stack: list[int] = []
        for i, s in enumerate(self.spans):
            while stack and _end(self.spans[stack[-1]]) < s["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launches[c] = e["ts"]
        self.launch_ids = sorted(launches)
        self.launch_ts = launches
        self.device = sorted(
            (e for e in events if e.get("ph") == "X"
             and e.get("cat") in DEVICE_CATS),
            key=lambda e: e["ts"])
        self.host = sorted((e for e in events if e.get("ph") == "X"
                            and e.get("cat") in HOST_CATS),
                           key=lambda e: e["ts"])
        self.host_starts = [e["ts"] for e in self.host]
        self.by_span: dict[str | None, float] = {}  # device us per span
        self.kernels_by_span: dict[str | None, int] = {}
        self.unmatched = 0
        for e in self.device:
            s = self._span_of(e)
            self.by_span[s] = self.by_span.get(s, 0.0) + float(e["dur"])
            if e["cat"] == "kernel":
                self.kernels_by_span[s] = self.kernels_by_span.get(s, 0) + 1
        self._iv = None

    def _innermost(self, t0: float, t1: float):
        """The innermost span open over all of [t0, t1], or None."""
        i = bisect.bisect_right(self.starts, t0) - 1
        j = i if i >= 0 else None
        while j is not None and _end(self.spans[j]) < t1:
            j = self.parent[j]
        return None if j is None else self.spans[j]["name"]

    def _span_of(self, e):
        c = (e.get("args") or {}).get("correlation")
        t = self.launch_ts.get(c)
        if t is not None:
            return self._innermost(t, t)
        self.unmatched += 1
        if c is None or not self.launch_ids:
            return None
        i = bisect.bisect_left(self.launch_ids, c)
        lo = self.launch_ts[self.launch_ids[max(i - 1, 0)]]
        hi = self.launch_ts[self.launch_ids[min(i, len(self.launch_ids) - 1)]]
        return self._innermost(min(lo, hi), max(lo, hi))

    def intervals(self):
        """The union of device activity, as sorted disjoint [start, end]."""
        if self._iv is None:
            out = []
            for e in self.device:
                s, t = e["ts"], _end(e)
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], t)
                else:
                    out.append([s, t])
            self._iv = out
        return self._iv

    def busy_us(self, t0: float, t1: float) -> float:
        return sum(max(0.0, min(t, t1) - max(s, t0))
                   for s, t in self.intervals())

    def top_ops(self, n: int = 10):
        """[name, seconds] of the device activities that took most time."""
        tot: dict[str, float] = {}
        for e in self.device:
            tot[e["name"]] = tot.get(e["name"], 0.0) + float(e["dur"])
        return [[k[:120], v * 1e-6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost host operation open at t, on any thread."""
        i = bisect.bisect_right(self.host_starts, t) - 1
        while i >= 0 and t - self.host[i]["ts"] <= 1e7:  # 10 s back at most
            if _end(self.host[i]) >= t:
                return self.host[i]["name"][:120]
            i -= 1
        return "idle"

    def idle_gaps(self, t0: float, t1: float, n: int = 10):
        """[what the host was doing, seconds] of the longest gaps with no
        device activity inside [t0, t1], each named by the innermost host
        operation open at its middle."""
        gaps, prev = [], t0
        for s, t in self.intervals():
            if s > prev:
                gaps.append((prev, min(s, t1)))
            prev = max(prev, t)
        if t1 > prev:
            gaps.append((prev, t1))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:n]
        return [[self._host_at(0.5 * (a + b)), (b - a) * 1e-6]
                for a, b in gaps]


def _end(e) -> float:
    return e["ts"] + e["dur"]


def read_chrome_trace(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]
