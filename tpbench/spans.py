"""The program's spans in the profiled steps' trace, reduced per span: the
device time each span owns, forward and backward, the exchange's exposed
device time, and each step's host duration and device idle time.  One
rank's events (``torch.profiler``'s chrome trace, ``trace.profile_steps``);
times in seconds.

* A program span is a ``user_annotation`` whose name starts with one of
  ``PREFIXES`` (the names ``repro_torch.runtime.telemetry`` documents).
  Other annotations, the harness's window and the collective backends'
  own, are not spans.
* A device operation (``trace.DEVICE_CATS``) is launched by the
  ``cuda_runtime`` or ``cuda_driver`` event with the same
  ``correlation``.  It belongs to the innermost program span open on the
  launching thread at the launch.  A launch inside an
  ``autograd::engine::evaluate_function`` belongs to ``<span>.bwd``, the
  span of the forward op with that event's ``Sequence number``: autograd
  links each backward node to the op that made it, so the program marks
  no backward span.  What matches no span is ``unattributed``.
* Each operation is counted once: its time, clipped to the harness's
  window, is shared with the operations running beside it, so the spans'
  times and ``unattributed`` sum to the device's busy time.
* The exchange's exposed time is the union of the device intervals under
  ``tp.split*`` and ``tp.gather*`` (forward and ``.bwd``) less the part
  that device work of any other span covers.
* A step is a ``tp.train_step`` span: its host duration is enqueue to
  return; its device idle time is the idle inside its own stretch of the
  device's timeline, from the span's start to the end of the last
  operation launched inside it (the harness's time between steps is
  outside every step).

The program's ``SpanLog`` of its set-up (``collect``) is read apart: host
times of ``prepare_bundle``'s stages.

The readers in ``metrics/`` (``nn_phase_ms``, ``attention_ms``,
``agg_ms``, ``exchange_exposed_ms``, ``step_dispatch_ms``,
``step_idle_ms``, ``prepare_chunk_s``) take two keys of a rank's record:
``trace["spans"]``, this module's ``reduce`` of the profiled steps' events,
and ``prepare_spans``, the ``collect``ed records of ``prepare_bundle``.
The harness's records carry them where ``trace.profile_steps`` stores
``reduce(events)`` under ``"spans"`` and ``engine.Program`` runs
``prepare_bundle`` inside ``collect()``, keeping the list as
``prepare_spans``; ``BENCHMARK.json`` names none of these metrics until
then, and each reader returns None on a record without its key.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

from .trace import DEVICE_CATS, TOP, WINDOW, _merged

PREFIXES = ("tp.", "gnn.", "gat.", "agg.", "optim.", "prepare.")
STEP = "tp.train_step"
BWD = ".bwd"
UNATTRIBUTED = "unattributed"
EXCHANGE = ("tp.split", "tp.gather")
BACKWARD = "autograd::engine::evaluate_function"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
AGG = re.compile(r"agg\.r\d+\.c\d+")
OPS_PER_SPAN = 5


class _Nested:
    """Intervals of one thread that nest: the innermost one around a
    time, by the enclosing links."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.items]
        self.parent, stack = [], []
        for i, (a, b, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i][2] if i >= 0 else None


def _overlap(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _length(merged) -> float:
    return sum(b - a for a, b in merged)


def _shares(ops) -> dict:
    """Each label's share of the union of ``ops`` ((start, end, label)):
    a stretch run by k operations gives each of them 1/k of it."""
    edges = sorted([(a, 1, lab) for a, _, lab in ops]
                   + [(b, -1, lab) for _, b, lab in ops])
    out, active = defaultdict(float), defaultdict(int)
    n, prev = 0, None
    for t, d, lab in edges:
        if n and t > prev:
            share = (t - prev) / n
            for k, m in active.items():
                out[k] += share * m
        active[lab] += d
        if not active[lab]:
            del active[lab]
        n += d
        prev = t
    return out


def _exposure(ops) -> tuple:
    """(the exchange's device time, the part of it no other span's device
    work covers) of ``ops`` ((start, end, label))."""
    ex = _merged([[a, b] for a, b, lab in ops if lab.startswith(EXCHANGE)])
    rest = _merged([[a, b] for a, b, lab in ops
                    if not lab.startswith(EXCHANGE)])
    return _length(ex), _length(ex) - _overlap(ex, rest)


def _top(d: dict, k: int) -> list:
    return [[name, v / 1e6] for name, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


class Timeline:
    """One rank's trace parsed: the harness's window, the program's spans
    and autograd's backward events (``evals``: name and sequence number)
    by thread, the launches by correlation, the forward op's span of each
    sequence number (``forward``), and the device operations."""

    def __init__(self, events: list):
        self.lo, self.hi = float("-inf"), float("inf")
        spans, evals = defaultdict(list), defaultdict(list)
        self.spans, self.evals, self.dev, fwd_ops = [], [], [], []
        self.launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), e.get("name", "")
            a = float(e["ts"])
            b = a + float(e.get("dur", 0))
            th = (e.get("pid"), e.get("tid"))
            args = e.get("args") or {}
            if cat == "user_annotation":
                if name == WINDOW:
                    self.lo, self.hi = a, b
                elif name.startswith(PREFIXES):
                    spans[th].append((a, b, name))
                    self.spans.append((a, b, name))
            elif cat == "cpu_op" and "Sequence number" in args:
                if name.startswith(BACKWARD):
                    evals[th].append((a, b, args["Sequence number"]))
                    self.evals.append((name, args["Sequence number"]))
                else:
                    fwd_ops.append((th, a, args["Sequence number"]))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[args["correlation"]] = (th, a)
            elif cat in DEVICE_CATS:
                self.dev.append((a, b, name, args.get("correlation")))
        self._nest = {th: _Nested(v) for th, v in spans.items()}
        self._bwd = {th: _Nested(v) for th, v in evals.items()}
        # the forward op that made a backward node: the latest-starting op
        # outside the backward with its sequence number
        self.forward = {}
        for th, t, seq in sorted(fwd_ops, key=lambda x: x[1]):
            if self._at(self._bwd, th, t) is None:
                self.forward[seq] = self._at(self._nest, th, t)

    @staticmethod
    def _at(table, th, t):
        return table[th].at(t) if th in table else None

    def label(self, th, t: float) -> str:
        """The span that owns what thread ``th`` launches at ``t``."""
        seq = self._at(self._bwd, th, t)
        if seq is not None:
            owner = self.forward.get(seq)
            return owner + BWD if owner else UNATTRIBUTED
        return self._at(self._nest, th, t) or UNATTRIBUTED


def reduce(events: list) -> dict:
    """The trace's events reduced (module docstring)."""
    tl = Timeline(events)
    lo, hi = tl.lo, tl.hi
    ops, launched = [], []
    per_label = defaultdict(lambda: defaultdict(float))
    for a, b, name, corr in tl.dev:
        a, b = max(a, lo), min(b, hi)
        if a >= b:
            continue
        launch = tl.launches.get(corr)
        lab = tl.label(*launch) if launch else UNATTRIBUTED
        ops.append((a, b, lab))
        launched.append(launch[1] if launch else None)
        per_label[lab][name[:160]] += b - a
    merged = _merged([[a, b] for a, b, _ in ops])
    shares = _shares(ops)

    exchange = _exposure(ops)

    host_s, calls, steps = defaultdict(float), defaultdict(int), []
    for a, b, name in tl.spans:
        host_s[name] += (b - a) / 1e6
        calls[name] += 1
        if name == STEP and lo <= a and b <= hi:
            steps.append((a, b))
    steps.sort()
    step_ops = [[] for _ in steps]
    starts = [a for a, _ in steps]
    for op, t in zip(ops, launched):
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= steps[i][1]:
            step_ops[i].append(op)
    step_idle = []
    for (a, _), mine in zip(steps, step_ops):
        end = max([b for _, b, _ in mine], default=a)
        step_idle.append(((end - a) - _overlap(merged, [[a, end]])) / 1e6)

    return {"steps": len(steps), "busy_s": _length(merged) / 1e6,
            "device_s": {k: v / 1e6 for k, v in sorted(shares.items())},
            "ops": {k: _top(v, OPS_PER_SPAN)
                    for k, v in sorted(per_label.items())},
            "unattributed_ops": _top(per_label.get(UNATTRIBUTED, {}), TOP),
            "exchange_s": exchange[0] / 1e6,
            "exchange_exposed_s": exchange[1] / 1e6,
            "step_exchange_exposed_s": [_exposure(m)[1] / 1e6
                                        for m in step_ops],
            "host_s": dict(sorted(host_s.items())),
            "calls": dict(sorted(calls.items())),
            "step_host_s": [(b - a) / 1e6 for a, b in steps],
            "step_idle_s": step_idle}


@contextlib.contextmanager
def collect():
    """The program's ``SpanLog`` records of the block (``[name, parent,
    start_ns, end_ns]`` each), in a list filled when the block ends; it
    stays empty where the program has no spans."""
    from repro_torch.runtime import telemetry as T
    out = []
    if not hasattr(T, "collect_spans"):
        yield out
        return
    with T.collect_spans() as log:
        yield out
    out.extend(log.records)


# --- what the readers in ``metrics/`` take ---------------------------------

def of_rank0(run):
    """Rank 0's span reduction, or None where the run was not traced or
    its program marked no step."""
    tr = run["ranks"][0]["trace"]
    sp = tr.get("spans") if tr else None
    return sp if sp and sp["steps"] else None


def device_ms(run, match) -> float | None:
    """Device milliseconds a step under the spans whose names ``match``
    (a predicate on a forward span's name), forward and ``.bwd``; None
    where no such span ran."""
    sp = of_rank0(run)
    if sp is None or not any(match(n) for n in sp["host_s"]):
        return None
    total = sum(v for k, v in sp["device_s"].items()
                if k != UNATTRIBUTED and match(k.removesuffix(BWD)))
    return total / sp["steps"] * 1e3


def prepare_s(run, stages) -> float | None:
    """Host seconds of the set-up ``stages`` on the slowest rank; None
    where a rank's program logged none of them."""
    out = []
    for r in run["ranks"]:
        recs = [x for x in r.get("prepare_spans") or [] if x[0] in stages]
        if not recs:
            return None
        out.append(sum(b - a for _, _, a, b in recs) / 1e9)
    return max(out)
