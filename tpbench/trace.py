"""Steps under ``torch.profiler``, reduced to what the per-layer readers
and the result's ``breakdown`` take: the traced window's wall time, the
device's busy time (the union of every kernel, copy and memset), the
NCCL kernels' time, the device operations that took most time, and the
idle gaps summed by the host operation that was running while the device
waited.  The window is the span the host marks around its steps; device
operations are clipped to it, so that its busy time never exceeds it."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
WINDOW = "tpbench.window"


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_op_at(t: float, ops, starts) -> str:
    """The innermost host operation running at ``t`` (µs): of the
    operations ``ops`` (sorted by start, ``starts`` their starts) that
    contain ``t``, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(ops[max(0, i - 512):i]):
        if b >= t:
            return name
    return "no host op"


def reduce_events(events: list, wall_s: float) -> dict:
    """The trace's complete events (``ph == "X"``) reduced (module
    docstring); times in seconds.  Where the trace holds the host's
    ``WINDOW`` span, the window is that span and device operations count
    only inside it; else the window is ``wall_s`` and every operation
    counts."""
    dev, ops, lo, hi = [], [], float("-inf"), float("inf")
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW):
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            wall_s = (hi - lo) / 1e6
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if a < b:
                dev.append((a, b, e.get("name", "")))
        elif e.get("cat") == "cpu_op":
            ops.append((a, b, e.get("name", "")))
    ops.sort()
    starts = [a for a, _, _ in ops]
    merged = _merged([[a, b] for a, b, _ in dev])
    busy_us = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name[:160]] += b - a
    gaps = defaultdict(float)
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        gaps[_host_op_at((end + start) / 2, ops, starts)] += start - end
    nccl_us = sum(b - a for a, b, name in dev if name.startswith("nccl"))

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"wall_s": wall_s, "busy_s": busy_us / 1e6,
            "nccl_s": nccl_us / 1e6, "device_ops": top(by_name),
            "idle_gaps": top(gaps)}


def profile_steps(step, k: int, sync) -> dict:
    """``k`` calls of ``step``, each followed by ``sync``, under the
    profiler; the trace goes through a file in ``TMPDIR`` that is removed
    after it is read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t = time.perf_counter()
            for _ in range(k):
                step()
                sync()
            wall_s = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json", prefix="tpbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = reduce_events(events, wall_s)
    out["steps"] = k
    return out
