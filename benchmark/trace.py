"""The traced window: a ``torch.profiler`` timeline and what is read off it.

The benchmark's own spans (``record_function``) mark the window and each
request or step. The timeline is exported as a Chrome trace under
``TMPDIR``, read back, and reduced to:

  * the device's busy time: the union of every kernel, copy and memset
    interval inside the window, so two overlapping streams count once;
  * each kernel's events (name, duration), for the rooflines;
  * the breakdown the result line carries: the ten device operations that
    took most time, and the idle gaps of the device by what the host was
    doing meanwhile (the innermost host span or call that covers the gap's
    middle).
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import tempfile
from typing import Dict, List, NamedTuple, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
GAPS_ATTRIBUTED = 500   # the longest gaps named by their host activity


class MeasurementError(RuntimeError):
    """The trace and the program's counters disagree: no reading."""
    code = 3


class Timeline(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]          # (name, seconds) each event
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def short(name: str) -> str:
    """A kernel's or call's name without its argument list (the first
    parenthesis that follows a name or a template's ``>``)."""
    m = re.search(r"(?<=[\w>])\(", name)
    return (name[:m.start()] if m else name)[:120]


@contextlib.contextmanager
def profiled(out: Dict):
    """Profile the block; on exit ``out["timeline"]`` holds its
    ``Timeline`` (the block must run ``window()`` once)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["timeline"] = reduce(events)


def window():
    """The span that marks the measured window inside ``profiled``."""
    return torch.profiler.record_function(WINDOW)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: List[Dict]) -> Timeline:
    """The window's timeline from Chrome trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window spans, "
                           f"not one")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, host = [], []
    for e in spans:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(a, w0), min(b, w1), e["name"]))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    per_op: Dict[str, float] = {}
    for a, b, name in dev:
        per_op[short(name)] = per_op.get(short(name), 0.0) + (b - a) * 1e-6
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return Timeline(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                    kernels=[(name, (b - a) * 1e-6) for a, b, name in dev],
                    device_ops=device_ops,
                    idle_gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost (shortest) host span covering each
    gap's middle; past the ``GAPS_ATTRIBUTED`` longest gaps, as "shorter
    gaps". One sweep over the gaps' middles in time order."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    named = sorted(gaps[:GAPS_ATTRIBUTED], key=lambda g: g[0] + g[1])
    host = sorted(host)
    by: Dict[str, float] = {}
    open_: List[Tuple[float, float, str]] = []  # (duration, end, name)
    j = 0
    for a, b in named:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            ha, hb, hn = host[j]
            heapq.heappush(open_, (hb - ha, hb, hn))
            j += 1
        while open_ and open_[0][1] <= mid:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "host (no traced call)"
        by[short(name)] = by.get(short(name), 0.0) + (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[GAPS_ATTRIBUTED:])
    if rest:
        by["shorter gaps"] = rest * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:10]


def count(kernels: List[Tuple[str, float]], pattern) -> Tuple[int, float]:
    """(events, seconds) of the kernels whose name ``pattern`` (a compiled
    regular expression) matches."""
    hits = [s for name, s in kernels if pattern.search(name)]
    return len(hits), sum(hits)


def kernel_time(ctx, main, reduce=None, counter: str = "") -> float:
    """Seconds of device time of one hand-written kernel in the window:
    its main function's events (``main``, a compiled pattern) and, where
    it splits, its reduction's (``reduce``). The main events must number
    the launches that the program's counter ``counter`` saw."""
    n, t = count(ctx.timeline.kernels, main)
    if n != ctx.launches.get(counter, 0):
        raise MeasurementError(
            f"{counter}: {n} kernel events in the trace, "
            f"{ctx.launches.get(counter, 0)} launches counted")
    if reduce is not None:
        t += count(ctx.timeline.kernels, reduce)[1]
    return t


def idle_share(ctx):
    """Percent of the window in which the device ran nothing."""
    if ctx.timeline is None:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy_s / ctx.timeline.window_s)


def peak_share(ctx):
    """Percent of the card's TF32 peak that the window's FLOPs are."""
    from benchmark.work import PEAK_FLOPS
    if ctx.timeline is None:
        return None
    return 100.0 * ctx.work["flops"] / (ctx.timeline.window_s * PEAK_FLOPS)


def roofline(ctx, op: str, main, reduce=None, counter: str = ""):
    """Percent: the least time of the window's ``op`` calls (the larger of
    FLOPs over the peak and bytes over HBM's rate, summed over the calls)
    over the kernel's device time; None where no such call was needed."""
    calls = [c for c in ctx.work["calls"] if c.op == op]
    if ctx.timeline is None or not calls:
        return None
    t = kernel_time(ctx, main, reduce, counter)
    return 100.0 * sum(c.bound_s() for c in calls) / t if t > 0 else None
