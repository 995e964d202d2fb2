"""Reduction of a torch.profiler chrome trace to where the device's time
went. ``reduce_trace`` is a frozen copy of the program's
``cli/profile_step.py::reduce_trace`` (kernels attributed to the span whose
host interval holds the runtime call that launched them, by correlation
id), with the span names an argument; the kernel sums by name, the top
device operations and the idle gaps by host span are the benchmark's own.
All times here are seconds in total over the profiled steps.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _owned(intervals, n_owners: int) -> List[float]:
    """How long each owner's intervals cover the time line; a moment that
    several owners cover goes to the lowest owner index."""
    edges = sorted([(a, 1, o) for a, b, o in intervals if b > a]
                   + [(b, -1, o) for a, b, o in intervals if b > a])
    active = [0] * n_owners
    out = [0.0] * n_owners
    last = None
    for t, d, o in edges:
        if last is not None and t > last:
            top = next((i for i, c in enumerate(active) if c), None)
            if top is not None:
                out[top] += t - last
        active[o] += d
        last = t
    return out


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(trace: Dict, spans: Sequence[str], top: int = 10) -> Dict:
    """``trace``'s profiled steps (its ProfilerStep annotations) ->

    * ``steps``; ``window_s`` (first step's start to the last device event
      or step end) and ``busy_s`` (the union of device intervals), both for
      the whole traced window;
    * ``device_s``: per span, the busy time of the device events its host
      calls launched;
    * ``kernel_s``: each kernel name's device time;
    * ``device_ops``: the ``top`` kernels by device seconds over the window;
    * ``idle_gaps``: the device's idle time over the window, summed by the
      innermost host annotation open at each gap's middle (``host idle``
      where none is), the ``top`` largest."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in ev if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    n = max(len(steps), 1)
    first = min((e["ts"] for e in steps), default=None)
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and (first is None or e["ts"] >= first)]
    out: Dict = dict(steps=n)
    if not dev:
        return out
    spans = list(spans)
    marks = sorted((e["ts"], e["ts"] + e["dur"], spans.index(e["name"])) for e in ev
                   if e.get("cat") == "user_annotation" and e.get("name") in spans)
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    starts = [a for a, _, _ in marks]

    def owner(e) -> int:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0:  # the innermost span that holds the launch
                if marks[i][0] <= t <= marks[i][1]:
                    return marks[i][2]
                i -= 1
        return len(spans)

    owned = _owned([(e["ts"], e["ts"] + e["dur"], owner(e)) for e in dev], len(spans) + 1)
    lo = min(e["ts"] for e in dev + steps)
    hi = max(e["ts"] + e["dur"] for e in dev + steps)
    busy_us = sum(owned)
    kernels = defaultdict(float)
    for e in dev:
        if e.get("cat") == "kernel":
            kernels[e["name"]] += e["dur"]
    # idle gaps of the device, named by the host annotation open at their middle
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                  if e.get("cat") == "user_annotation"
                  and not str(e.get("name", "")).startswith("ProfilerStep#"))
    busy = _merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = [(lo, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])] + [(busy[-1][1], hi)]
    idle = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host idle"
        idle[name] += b - a
    us = 1e-6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    out.update(
        window_s=(hi - lo) * us, busy_s=busy_us * us,
        device_s={k: v * us for k, v in zip(spans, owned)},
        unattributed_s=owned[-1] * us,
        kernel_s={k: v * us for k, v in kernels.items()},
        device_ops=[[k[:160], v * us] for k, v in ranked[:top]],
        idle_gaps=[[k, v * us] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    )
    return out


def kernel_seconds(red: Dict, patterns: Sequence[str]) -> float:
    """Device seconds of the kernels whose names hold any of ``patterns``."""
    return sum(s for k, s in red.get("kernel_s", {}).items() if any(p in k for p in patterns))
