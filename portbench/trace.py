"""The traced stretch: ``torch.profiler`` over frames of the window's loop,
reduced to the device's busy time, its busiest operations and its idle
gaps labelled by what the host was doing.

The loop marks its own calls into the renderer with ``record_function``
spans (``SPANS``); each stretch of a gap in the device's timeline is
labelled by the innermost of those spans and the CUDA runtime call under
it that cover it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

STRETCH = "portbench.stretch"
SPANS = ("portbench.camera", "portbench.rasterize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


def profile(run_frames) -> dict:
    """Run ``run_frames(span)`` under the profiler inside the stretch span
    (``span(name)`` is the span context the loop wraps its calls in) and
    return ``summarize`` of its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(STRETCH):
            run_frames(record_function)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covering(spans, starts, t, back: int = 8):
    """The shortest (start, end, name) of ``spans`` (sorted by start;
    ``starts`` their starts) covering time t, or None. Spans of one kind
    nest a few deep at most, so only the ``back`` latest starts are
    looked at."""
    best = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in spans[max(0, i - back):i]:
        if t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best


def _label(spans, span_starts, runtime, runtime_starts, t) -> str:
    """What the host was doing at time t: the innermost benchmark span
    (or the loop between them) and the CUDA runtime call under it."""
    span = _covering(spans, span_starts, t)
    call = _covering(runtime, runtime_starts, t)
    label = span[2] if span else "portbench.loop"
    return label + "/" + call[2] if call else label


def summarize(events) -> dict:
    """{busy_s, window_s, device_ops, idle_gaps} of a chrome trace's events
    (times in microseconds): busy is the union of the device's kernels,
    copies and memsets inside the stretch span; device_ops the TOP
    operations by summed time; idle_gaps the TOP host labels by summed
    idle time."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    s0 = float(stretch[0]["ts"])
    s1 = s0 + float(stretch[0]["dur"])
    dev, ops = [], defaultdict(float)
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), s0)
        b = min(float(e["ts"]) + float(e["dur"]), s1)
        if b > a:
            dev.append((a, b))
            ops[e["name"][:NAME_CHARS]] += (b - a) * 1e-6
    busy = _merge(dev)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs if e.get("name") in SPANS)
    runtime = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in xs if e.get("cat") in RUNTIME_CATS)
    span_starts = [a for a, _, _ in spans]
    runtime_starts = [a for a, _, _ in runtime]
    edges = sorted([a for a, _, _ in spans + runtime]
                   + [b for _, b, _ in spans + runtime])
    gaps, t = defaultdict(float), s0
    for a, b in busy + [[s1, s1]]:
        if a > t:
            # split the gap where a host span or call starts or ends, and
            # give each piece the label of what covers its middle
            lo = bisect.bisect_right(edges, t)
            hi = bisect.bisect_left(edges, a)
            cuts = [t] + edges[lo:hi] + [a]
            for c0, c1 in zip(cuts, cuts[1:]):
                if c1 > c0:
                    gaps[_label(spans, span_starts, runtime, runtime_starts,
                                0.5 * (c0 + c1))] += (c1 - c0) * 1e-6
        t = max(t, b)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (s1 - s0) * 1e-6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
