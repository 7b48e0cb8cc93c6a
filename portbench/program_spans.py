"""The program's own spans in a traced window.

The program opens named spans where its work happens (``sampler.*``,
``ppde.*``, ``energy`` and ``energy.*``, ``kernel.*``, and inside each
expert the prefix its module gives, ``SPAN_PREFIX``) while a profiler
records. ``read`` takes them from the window's
``trace.Attribution`` (its host events, device activities and launch calls)
and gives:

  * the device seconds and kernels by the innermost program span open, on
    any host thread, at each activity's launch (the correlation id links an
    activity to its launch call; where that call is missing, the launch
    calls with the nearest ids before and after bound its time, and the
    innermost program span open over both is taken);
  * the device idle seconds inside [w0, w1] by the innermost program span
    open at each gap's middle;
  * the spans' entries by name.

Time outside every program span goes under ``OUTSIDE``. A trace of a
program without these spans gives empty tables.

``of_run`` gives the readers of ``metrics/`` these tables for a traced
run: ``run["trace"]["program"]``, which ``harness._run`` stores there.
"""
from __future__ import annotations

import bisect

from portbench import experts

PREFIXES = ("sampler.", "ppde.", "energy.", "kernel.")
OUTSIDE = "outside"


def prefixes() -> tuple[str, ...]:
    """The program's span prefixes: the sampler's, the energy's, the
    kernels', and every expert module's."""
    return PREFIXES + tuple(m.SPAN_PREFIX for m in experts.modules())


def is_program(name: str, pre: tuple[str, ...]) -> bool:
    return name == "energy" or name.startswith(pre)


class _Spans:
    """Program spans, nested by time across threads."""

    def __init__(self, host):
        pre = prefixes()
        self.spans = [e for e in host if e.get("cat") == "user_annotation"
                      and is_program(e.get("name", ""), pre)]  # by start
        self.starts = [s["ts"] for s in self.spans]
        self.parent: list[int | None] = []
        stack: list[int] = []
        for i, s in enumerate(self.spans):
            while stack and _end(self.spans[stack[-1]]) < s["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t0: float, t1: float) -> str:
        """The innermost program span open over all of [t0, t1]."""
        j = bisect.bisect_right(self.starts, t0) - 1
        j = j if j >= 0 else None
        while j is not None and _end(self.spans[j]) < t1:
            j = self.parent[j]
        return OUTSIDE if j is None else self.spans[j]["name"]


def of_run(run: dict) -> dict | None:
    """The program's tables of a traced run, or None (no trace)."""
    t = run.get("trace")
    return t.get("program") if t else None


def read(attr, w0: float, w1: float) -> dict:
    """The window's tables (seconds; [w0, w1] in trace microseconds)."""
    spans = _Spans(attr.host)
    entries: dict[str, int] = {}
    for s in spans.spans:
        entries[s["name"]] = entries.get(s["name"], 0) + 1
    device_s: dict[str, float] = {}
    kernels: dict[str, int] = {}
    unmatched = 0
    for e in attr.device:
        c = (e.get("args") or {}).get("correlation")
        t = attr.launch_ts.get(c)
        if t is not None:
            name = spans.innermost(t, t)
        else:
            unmatched += 1
            name = OUTSIDE
            if c is not None and attr.launch_ids:
                ids = attr.launch_ids
                i = bisect.bisect_left(ids, c)
                lo = attr.launch_ts[ids[max(i - 1, 0)]]
                hi = attr.launch_ts[ids[min(i, len(ids) - 1)]]
                name = spans.innermost(min(lo, hi), max(lo, hi))
        device_s[name] = device_s.get(name, 0.0) + float(e["dur"]) * 1e-6
        if e.get("cat") == "kernel":
            kernels[name] = kernels.get(name, 0) + 1
    idle_s: dict[str, float] = {}
    prev = w0
    for s, t in _busy(attr.device):
        if s > prev and prev < w1:
            _idle(spans, idle_s, prev, min(s, w1))
        prev = max(prev, t)
    if w1 > prev:
        _idle(spans, idle_s, prev, w1)
    return {"device_s": device_s, "kernels": kernels, "idle_s": idle_s,
            "entries": entries, "unmatched_launches": unmatched}


def _idle(spans, idle_s, a, b):
    name = spans.innermost(0.5 * (a + b), 0.5 * (a + b))
    idle_s[name] = idle_s.get(name, 0.0) + (b - a) * 1e-6


def _busy(device):
    """The union of device activity, as sorted disjoint [start, end]."""
    out: list[list[float]] = []
    for e in sorted(device, key=lambda e: e["ts"]):
        s, t = e["ts"], _end(e)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _end(e) -> float:
    return e["ts"] + e["dur"]
