"""Run-time collective audit: what one step really issues, against the
collective ledger.

The :class:`~repro_torch.runtime.telemetry.CommLedger` is filled by the
choke point (``runtime/collectives.py``) as it runs; nothing forces it to
agree with the collectives the step hands to the process group.  This
module counts those from below the choke point and diffs the two — the
port's counterpart of the reference's ``repro.analysis.jaxpr_audit``,
which walks the traced program instead:

* :func:`census` runs one step under ``torch.profiler`` and counts the
  ``c10d::`` dispatcher ops (``c10d::alltoall_base_``,
  ``c10d::allgather_``, ``c10d::allreduce_``, ...): every spelling of a
  collective — ``torch.distributed``'s API, its functional collectives,
  DTensor's reductions — reaches the process group through one of them.
  It counts per (op, dtype, pass): the dtype from the op's operand, or
  for a tensor-list op from the backend's event of the same call
  (``gloo:*`` / ``nccl:*``); the pass is ``backward`` for an op that ran
  inside one of autograd's ``evaluate_function`` records, on whatever
  thread — autograd runs a CUDA backward on a thread of its own, which a
  ``TorchDispatchMode`` such as ``CommDebugMode`` does not see, and the
  profiler does.
* :func:`audit` diffs a census against a ledger of the same step:

  - a collective the ledger did not record → ``unledgered_collective``
    (a call bypassed the choke point);
  - a ledger entry no call made → ``phantom_ledger_entry``.

Exactness contract, as the reference's: exact for the data-moving ops —
``all_to_all`` (forward ``calls`` against the forward pass,
``mirrored_calls`` against the backward one), ``all_gather`` (and the
LM's gathers under their own op kinds: ``param_gather``, serving's
``cache_place``, ``softmax_gather``, ``conv_gather`` and
``last_gather``, and megatron's
``tp_gather``) and its mirror, the reduce-scatter, and
``ppermute`` as a send and a receive — and one-directional for ``psum`` /
``grad_psum`` / ``tp_psum`` (megatron's row-parallel sum, an all-reduce
forward and another, its mirror, backward): the ledger may not claim more
all-reduces than ran, but
all-reduces it does not record are expected (below).  A checkpoint's
rerun of forward collectives (``recomputed_calls``) runs in the backward
pass.  Any other collective (broadcast, barrier, ...) has no ledger op
kind and is always unledgered.

Stated departures the audit knows about:

* on gloo the all-gather's backward is an all-reduce and a slice, not a
  reduce-scatter (ROADMAP queue 3 item 4): there its ``mirrored_calls``
  are held against backward all-reduces;
* the constraint backend's reductions are DTensor's all-reduces, with no
  ``psum`` entry (``runtime/telemetry.py``): all-reduces beyond the
  ledger's are not findings;
* the out-of-core epoch (``core/stream.py``) runs its split's transpose
  by hand, outside autograd, and records it as a backward call
  (``telemetry.backward_scope``): audit it with ``by_pass=False``, which
  holds each data op's forward and backward calls together.

The profiler records each call's op, operands and thread, not its process
group, so the census does not split an (op, dtype) by group: the ledger's
entries are summed over their axis labels to the census's key, and a
hybrid step's model- and data-axis all-gathers are held together.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..runtime import telemetry as T

__all__ = ["AuditFinding", "Census", "audit", "assert_clean", "census",
           "expected_from_ledger", "C10D_OPS", "DATA_OPS"]

#: c10d dispatcher op → census op kind.
C10D_OPS = {
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier",
    "monitored_barrier_": "barrier",
}

#: Census ops held exactly, both directions.
DATA_OPS = ("all_to_all", "all_gather", "reduce_scatter", "send", "recv")

#: The profiler's dtype names → the ledger's (numpy's).
_DTYPES = {"float": "float32", "double": "float64", "c10::Half": "float16",
           "c10::BFloat16": "bfloat16", "long int": "int64",
           "int": "int32", "short int": "int16", "signed char": "int8",
           "unsigned char": "uint8", "bool": "bool"}

_BACKWARD_RECORD = "autograd::engine::evaluate_function"
_BACKEND_PREFIXES = ("gloo:", "nccl:")


@dataclasses.dataclass(frozen=True)
class _Event:
    name: str
    thread: int
    start: int
    end: int
    dtypes: tuple


def _events(prof) -> list[_Event]:
    """The profile's host-side records (a backend's kernels on the card
    carry the same names as its host records, and no operands)."""
    from torch.autograd import DeviceType
    return [_Event(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns(),
                   tuple(e.dtypes()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def _tensor_dtype(dtypes) -> str | None:
    for d in dtypes:
        if d in _DTYPES:
            return _DTYPES[d]
    return None


@dataclasses.dataclass
class Census:
    """Collectives issued, per (op, dtype, pass) → calls, and the threads
    each pass issued them on."""

    counts: dict = dataclasses.field(default_factory=dict)
    threads: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_events(cls, events: list[_Event]) -> "Census":
        c10d = sorted((e for e in events if e.name.startswith("c10d::")
                       and e.name[6:] in C10D_OPS), key=lambda e: e.start)
        backend = sorted((e for e in events
                          if e.name.startswith(_BACKEND_PREFIXES)),
                         key=lambda e: e.start)
        backward = collections.defaultdict(list)
        for e in events:
            if e.name.startswith(_BACKWARD_RECORD):
                backward[e.thread].append((e.start, e.end))
        counts: dict = {}
        threads: dict = collections.defaultdict(set)
        b = 0
        for e in c10d:
            # each call's backend event starts after the c10d op does:
            # the calls are synchronous, so the order pairs them
            while b < len(backend) and backend[b].start < e.start:
                b += 1
            dtype = _tensor_dtype(e.dtypes)
            if dtype is None and b < len(backend):
                dtype = _tensor_dtype(backend[b].dtypes)
            b += 1
            bwd = any(s <= e.start and e.end <= t
                      for s, t in backward[e.thread])
            key = (C10D_OPS[e.name[6:]], dtype or "?",
                   "backward" if bwd else "forward")
            counts[key] = counts.get(key, 0) + 1
            threads[key[2]].add(e.thread)
        return cls(counts, {p: sorted(t) for p, t in threads.items()})

    def get(self, op: str, dtype: str, pass_: str | None = None) -> int:
        return sum(n for (o, d, p), n in self.counts.items()
                   if o == op and d == dtype and pass_ in (None, p))

    def as_dict(self) -> dict:
        """``{"op|dtype|pass": calls}``, sorted."""
        return {"|".join(k): n for k, n in sorted(self.counts.items())}


def census(fn: Callable, *args, **kwargs) -> tuple[Any, Census]:
    """(``fn(*args, **kwargs)``, the census of the collectives it issued),
    forward and backward.  A CUDA device is synchronized before the
    profiler stops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return out, Census.from_events(_events(prof))


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One disagreement between the census and the ledger."""

    kind: str        # unledgered_collective | phantom_ledger_entry
    op: str
    dtype: str
    pass_: str       # forward | backward | any
    expected: float  # what the ledger implies
    actual: float    # what the census counted
    detail: str = ""

    def format(self) -> str:
        return (f"{self.kind}: op={self.op} dtype={self.dtype} "
                f"pass={self.pass_} ledger={self.expected:g} "
                f"census={self.actual:g}"
                + (f" — {self.detail}" if self.detail else ""))


def _gloo() -> bool:
    return dist.is_initialized() and dist.get_backend() == "gloo"


def expected_from_ledger(ledger: T.CommLedger, *,
                         gloo: bool | None = None) -> tuple[dict, dict]:
    """What the ledger implies the census holds: ({(op, dtype, pass):
    calls} of the data ops, exact; {dtype: calls} of all-reduces,
    a lower bound).  A forward op's ``calls`` go to the forward pass, its
    ``mirrored_calls`` to the backward one under the op the mirror runs:
    the all-to-all's is an all-to-all, the all-gather's (and that of every
    op kind with an all-gather's cost) a reduce-scatter (an all-reduce on gloo), the ppermute's a
    ppermute: a send and a receive each.  ``recomputed_calls`` (a
    checkpoint's rerun) go to the backward pass under the forward op.
    ``h2d`` is not a collective and is skipped."""
    gloo = _gloo() if gloo is None else gloo
    exact: dict = collections.Counter()
    reduces: dict = collections.Counter()
    for (op, _, dtype), e in ledger.entries().items():
        if op == "all_to_all":
            exact[(op, dtype, "forward")] += e.calls
            exact[(op, dtype, "backward")] += e.mirrored_calls \
                + e.recomputed_calls
        elif op == "ppermute":
            for p2p in ("send", "recv"):
                exact[(p2p, dtype, "forward")] += e.calls
                exact[(p2p, dtype, "backward")] += e.mirrored_calls \
                    + e.recomputed_calls
        elif T.OP_COST.get(op) == "all_gather":
            op = "all_gather"
            exact[(op, dtype, "forward")] += e.calls
            exact[(op, dtype, "backward")] += e.recomputed_calls
            if gloo:
                exact[("all_reduce", dtype, "backward")] += e.mirrored_calls
            else:
                exact[("reduce_scatter", dtype, "backward")] += \
                    e.mirrored_calls
        elif op == "psum_scatter":
            exact[("reduce_scatter", dtype, "forward")] += e.calls
        elif op in ("psum", "grad_psum", "tp_psum"):
            reduces[dtype] += e.calls + e.mirrored_calls + e.recomputed_calls
    return ({k: v for k, v in exact.items() if v},
            {k: v for k, v in reduces.items() if v})


def _without_passes(counts: dict) -> dict:
    """The data ops' calls of both passes together, under pass ``any``."""
    out: dict = collections.Counter()
    for (op, dtype, pass_), n in counts.items():
        out[(op, dtype, "any" if op in DATA_OPS else pass_)] += n
    return out


def audit(cen: Census, ledger: T.CommLedger, *, gloo: bool | None = None,
          by_pass: bool = True) -> list[AuditFinding]:
    """Diff the census of one step against the ledger of the same step
    (empty list: clean).  See the module docstring for the contract;
    ``by_pass=False`` for a backward run by hand."""
    exact, reduces = expected_from_ledger(ledger, gloo=gloo)
    counts = cen.counts
    if not by_pass:
        exact, counts = _without_passes(exact), _without_passes(counts)
    findings = []
    held = set(exact)
    held |= {k for k in counts if k[0] in DATA_OPS}
    for key in sorted(held):
        op, dtype, pass_ = key
        want, have = exact.get(key, 0.0), counts.get(key, 0)
        if op == "all_reduce":
            # the gloo all-gather mirrors: at least that many backward
            # all-reduces; the rest of them may be psums
            if have < want:
                findings.append(AuditFinding(
                    "phantom_ledger_entry", "all_gather", dtype, pass_,
                    want, have,
                    f"the ledger records {want:g} all-gather backward "
                    f"calls, which gloo runs as all-reduces, but the step "
                    f"ran {have:g} backward all-reduces"))
            continue
        if have > want:
            findings.append(AuditFinding(
                "unledgered_collective", op, dtype, pass_, want, have,
                f"the step issued {have:g} {op} ({pass_}) but the ledger "
                f"accounts for {want:g} — a collective bypassed "
                f"runtime/collectives.py"))
        elif want > have:
            findings.append(AuditFinding(
                "phantom_ledger_entry", op, dtype, pass_, want, have,
                f"the ledger accounts for {want:g} {op} ({pass_}) but the "
                f"step issued {have:g} — a record with no call"))
    for dtype, want in sorted(reduces.items()):
        have = cen.get("all_reduce", dtype) - exact.get(
            ("all_reduce", dtype, "backward"), 0.0)
        if want > have:
            findings.append(AuditFinding(
                "phantom_ledger_entry", "psum", dtype, "any", want, have,
                f"the ledger's psum and grad_psum calls exceed the step's "
                f"all-reduces (the reverse is expected: DTensor's "
                f"reductions are out of ledger scope)"))
    for (op, dtype, pass_), have in sorted(cen.counts.items()):
        if op not in DATA_OPS and op != "all_reduce":
            findings.append(AuditFinding(
                "unledgered_collective", op, dtype, pass_, 0.0, have,
                f"{op} has no ledger op kind: a collective outside the "
                f"choke point's vocabulary"))
    return findings


def assert_clean(cen: Census, ledger: T.CommLedger, *, tag: str = "",
                 gloo: bool | None = None, by_pass: bool = True) -> None:
    """Raise AssertionError listing every finding."""
    findings = audit(cen, ledger, gloo=gloo, by_pass=by_pass)
    if findings:
        head = f"collective audit failed{f' [{tag}]' if tag else ''}:"
        raise AssertionError(
            "\n  ".join([head] + [f.format() for f in findings]))
