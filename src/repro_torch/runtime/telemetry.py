"""Collective telemetry: per-(op, axis, dtype) byte counters of one step.

The paper's quantitative claim is about wire bytes: TP's gather/split
moves V·D/N bytes per device whatever the graph's skew (Fig. 8, §3.2).
Every byte the port moves between ranks goes through
:mod:`repro_torch.runtime.collectives`, which reports each call here —
but for the constraint backend's reductions, which DTensor runs
(:func:`repro_torch.runtime.constraint.replicate`; see below).

Usage::

    with telemetry.collect_comm() as ledger:
        train_step(params, opt_state)        # exactly one step
    ledger.wire_bytes(op="all_to_all", axis="model", train=True)

Keys, counters and the ring cost model are the JAX package's
(``repro.runtime.telemetry``), so ``as_dict()`` of the two compares as a
plain dict:

* **Keys** — ``(op kind, axis label, dtype)``; the dtype label is the
  numpy name (``"float32"``).  Multi-axis labels join with ``+``; an axis
  query matches a label it equals or names a ``+`` component of.
* **Bytes** — ``payload_bytes`` is the per-device input operand;
  ``wire_bytes`` is its per-device ring-algorithm traffic
  (:func:`ring_wire_factor`).
* **Mirrors** — ``mirrored_calls`` / ``mirrored_wire_bytes`` count the
  collectives the backward pass runs; ``train=True`` queries add them.

How the port's semantics differ from the reference's:

* **Execution time, not trace time.**  The reference records while a
  program traces, once, and multiplies the bodies of scans by their trip
  count.  The port runs every chunk's call eagerly, so it records every
  execution: a ledger collects over exactly one step, and nothing
  replaces the reference's loop multiplier.
* **Mirrors are recorded when they run.**  The reference declares at
  each forward call whether autodiff will emit the mirrored collective
  (``mirror=``).  Here the backward of the all-to-all records itself
  (``record(..., backward=True)``), so those declarations — such as layer
  0's ``mirror=False`` in the naive forward — are checked against what
  autograd really does.  It records into the ledgers its forward saw
  (``ledgers=``): autograd runs a CUDA backward on its own thread, where
  the collecting context is not active.
* **The replicated parameters' gradient all-reduce is counted.**  The
  reference leaves it out of its ledger scope (it is an implicit
  ``shard_map`` transpose there).  The port runs it explicitly and
  records it under its own op kind, ``grad_psum``, at the ring cost of a
  ``psum``, so the reference's keys are unchanged.  Under hybrid DP×TP it
  spans every rank, model and replicas, in one call keyed
  ``grad_psum|model+data`` (``model+pod+data``) with the group size N·R.
* **The loss sums travel stacked.**  (loss, correct, count) go in one
  psum of 12 bytes per axis group where the reference makes three scalar
  psums of the same bytes: one call on ``psum|model`` and, under hybrid
  DP×TP, one on the replica axes (``psum|data``, ``psum|pod+data``).
* **Layout transitions (the constraint backend) run, and record, their
  collectives.**  The reference's partitioner materializes a transition's
  collectives itself, and :func:`implied_collectives` is what it reports
  for them at trace time.  The port runs each transition through
  :mod:`repro_torch.runtime.collectives` (``runtime/constraint.py``), so
  the records are the choke point's own, made when the collectives run;
  :func:`implied_collectives` stays the specification they are held to,
  and :func:`record_transition` adds the transition itself
  (:class:`TransitionRecord`) to the ledgers.  Under that backend:

  - GAT's two O(V) score all-gathers are run and recorded
    (``all_gather|model``), as the explicit backend records them; the
    reference's partitioner makes them unrecorded.
  - The DP baseline's replica gathers are run and recorded
    (``all_gather|data``, ``pod``) as the explicit backend's; the
    reference's constraint DP forward lets the partitioner gather the
    rows unrecorded.
  - There are no ``psum`` or ``grad_psum`` entries: the loss sums and the
    parameter gradients are DTensor's own reductions
    (``constraint.replicate``), which the ledger does not see and a
    ``CommDebugMode`` census counts.
* **A hand-run backward records as one.**  The out-of-core epoch
  (:mod:`repro_torch.core.stream`) runs the split's transpose itself, as
  a gather outside autograd.  The reference's ``mirror_scope`` drops that
  call, since the forward split declared its mirror; here nothing was
  declared, so :func:`backward_scope` records it as the backward call of
  its key — what autograd's mirror records in the in-memory epoch.

* **The sharded LM** (``repro_torch.sharding``) records what its
  per-rank program runs, where the reference's partitioner records
  nothing but its explicit sharder's collectives:

  - each parameter gathered at use (FSDP over the data axes, heads, FFN,
    vocab and experts over the model axis) is a ``param_gather`` entry
    of its axis, at an all-gather's ring cost; its backward is the
    gradients' reduce-scatter (the mirror);
  - the loss's summed cross-entropy and token count travel as one
    stacked ``psum`` over every rank (``model+data``), and each MoE
    layer's router mass, assignment counts and token count as one more;
    the gradients of the axes a parameter is replicated over are one
    ``grad_psum`` per axis (and dtype);
  - the plain ``Sharder``'s transitions, which XLA chooses for the
    reference, are the staging of ``constraint.move_local``: q, k and v
    move to the fitted head layouts by an all-to-all where the heads
    divide the model axis and an all-gather of the sequence where they
    do not, the output back by an all-to-all or a slice; mamba2's x and
    dt by an all-to-all, B and C by an all-gather, its conv's halo by a
    ppermute; the plain MoE gathers the routing and the token rows over
    the token axes and the expert outputs over the model axis;
  - a repeated layer group records each repeat's calls, where the
    reference traces its layer scan's body once (no ``loop_scope``
    there): R× its entries;
  - ring attention skips the last rotation, whose chunk no step reads:
    2(n − 1) ppermutes a layer, forward and mirrored, against the
    reference's 2n;
  - sharded serving records three gathers under op kinds of their own,
    each at an all-gather's ring cost: ``cache_place``, a prefill's move
    of the prompt's positions a cache keeps (gathered over the sequence
    and whatever axes the cache's layout does not keep, then sliced to
    the rank's block); ``softmax_gather``, a decode step's partial max,
    sum and output of each rank's slots of a split sequence (one per
    attention layer, whatever the caches' length); ``conv_gather``, a
    decode step's mamba2 conv output over the channels.  The reference's
    partitioner picks these moves itself and records none of them;
  - the **megatron** strategy (column- and row-parallel NN phase) keeps
    every model-parallel leaf in its model shard at use, so it makes no
    ``param_gather`` over the model axis (only the FSDP gathers over the
    data axes), and records two op kinds of its own over ``model``:
    ``tp_psum``, the row-parallel sum, an all-reduce at a ``psum``'s ring
    cost whose backward is an all-reduce too (its mirror), and
    ``tp_gather``, a column-split activation gathered whole, at an
    all-gather's cost.  Payload and wire bytes as for every key: the
    per-device operand, and its ring traffic 2(n − 1)/n (``tp_psum``) or
    (n − 1)/n of the result (``tp_gather``).  One forward (or decode step)
    records ``tp_psum`` calls: 1 for the vocab-split embedding's lookup
    (fp32 rows, (B_l, S, D)) where the axis divides the vocabulary; 1 an
    attention layer (the out-projection; the shared block at each use)
    where it divides the heads; 1 an MLP (the down projection) where it
    divides d_ff; a MoE layer 1 for the routed combine where it divides
    the experts and 1 for the shared experts where it divides their
    width; a mamba2 layer 1 for the gated norm's per-token mean square
    (fp32, (B_l, S, 1)) where it divides the heads and 1 for ``out_proj``
    where it divides d_inner — each (B_l, S, D) in the compute dtype but
    those two fp32 ones.  ``tp_gather``: 1 for the vocab-split logits (in
    the compute dtype, before the fp32 cast), 1 a mamba2 layer for its
    fused in-projection where the axis divides its width; a decode step
    adds the head-local q, k and v gathered for a cache that holds the
    heads whole (1 per tensor a layer), and an MLA decode over a sequence
    split on the model axis its latent query and rope query (2 a
    layer).  A mamba2 layer's conv output is a ``conv_gather`` (1 a layer
    where the axis divides the conv channels), in the forward too;
  - **recomputation**: a checkpointed unit (``remat``) reruns its
    collectives in the backward pass; they are recorded when they run,
    as ``recomputed_calls`` / ``recomputed_wire_bytes`` of their key
    (:func:`recompute_scope`; shown by ``as_dict`` only where non-zero,
    added by ``train=True`` queries).  The port has no ``loop_scope``
    and records every execution, so a step's ledger counts each
    recomputed call once more; the ring's own per-step checkpoint holds
    no collective.

Host→device staging (the out-of-core path) is counted beside the
collectives under op kind :data:`H2D_OP` (:func:`record_h2d`).

When no ledger is collecting, a collective pays one ``ContextVar`` read
(:func:`active_ledgers`) and nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from contextvars import ContextVar
from typing import Iterator, Mapping

import torch

__all__ = ["CommEntry", "CommLedger", "H2D_OP", "TelemetryError",
           "TransitionRecord", "active_ledgers", "backward_scope",
           "collect_comm", "implied_collectives", "normalize_spec",
           "recompute_scope", "record", "record_h2d", "record_transition",
           "ring_wire_factor"]


class TelemetryError(RuntimeError):
    """A collective could not be accounted while a ledger was collecting —
    raised instead of silently skipping its bytes."""


#: Op kinds :func:`record` accepts, each with the collective whose ring
#: cost it pays: the reference's five, the gradient all-reduce, the
#: sharded LM's parameter gather and its serving's three gathers (a
#: prefill's cache placement, a decode step's split-softmax partials and
#: its conv output over the channels), and the megatron strategy's
#: row-parallel sum and column-split gather.
OP_COST = {"psum": "psum", "all_gather": "all_gather",
           "all_to_all": "all_to_all", "ppermute": "ppermute",
           "psum_scatter": "psum_scatter", "grad_psum": "psum",
           "param_gather": "all_gather", "cache_place": "all_gather",
           "softmax_gather": "all_gather", "conv_gather": "all_gather",
           "tp_psum": "psum", "tp_gather": "all_gather"}


#: Ledger op kind of host→device staging (out-of-core streaming).  Not a
#: collective: no ring factor and no backward, so not in ``OP_COST``.
#: Keys are ``("h2d", label, dtype)``; payload and wire bytes are both the
#: bytes copied.
H2D_OP = "h2d"


def ring_wire_factor(op: str, g: int) -> float:
    """Ring-algorithm per-device wire-byte factor on the RESULT size:

      all_gather      (g−1)/g      psum (all-reduce)   2(g−1)/g
      psum_scatter    (g−1)        all_to_all          (g−1)/g
      ppermute        1
    """
    if op == "ppermute":
        return 1.0
    if g <= 1:
        return 0.0
    return {"all_gather": (g - 1) / g,
            "psum": 2 * (g - 1) / g,
            "psum_scatter": float(g - 1),
            "all_to_all": (g - 1) / g}[op]


@dataclasses.dataclass
class CommEntry:
    """Accumulated counters for one (op, axis label, dtype) key."""

    calls: float = 0.0            # forward collective executions
    payload_bytes: float = 0.0    # per-device input payload, forward
    wire_bytes: float = 0.0       # per-device ring wire bytes, forward
    mirrored_calls: float = 0.0   # backward-pass executions
    mirrored_wire_bytes: float = 0.0
    recomputed_calls: float = 0.0  # forward calls rerun by a checkpoint
    recomputed_wire_bytes: float = 0.0

    def merge(self, other: "CommEntry") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> dict:
        """The counters; the recomputed ones only where non-zero, so an
        entry without recomputation reads as the reference's."""
        d = dataclasses.asdict(self)
        if not (self.recomputed_calls or self.recomputed_wire_bytes):
            del d["recomputed_calls"], d["recomputed_wire_bytes"]
        return d


def normalize_spec(spec) -> tuple:
    """Canonical hashable form of a spec (a tuple of entries, each
    ``None``, an axis name or a tuple of names): tuple entries stay tuples
    of ``str``, scalars become ``str``, and trailing ``None`` dims
    (replicated) are dropped, so ``("model", None)`` and ``("model",)``
    compare equal."""
    entries = []
    for e in tuple(spec):
        if e is None:
            entries.append(None)
        elif isinstance(e, (tuple, list)):
            entries.append(tuple(str(a) for a in e))
        else:
            entries.append(str(e))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class TransitionRecord:
    """One constraint-backend layout transition, as run
    (``layout_cast``/``note_transition``).  Not serialized by ``as_dict``
    and not merged by ``merge_from``: ledgers compare counters."""

    shape: tuple        # global shape
    dtype: str
    src_spec: tuple     # normalize_spec() form
    dst_spec: tuple
    mirror: bool
    anchored: bool      # True iff layout_cast anchored the source layout


def _axis_label(axes) -> str:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return "+".join(axes)


def _label_matches(label: str, axis: str | None) -> bool:
    return axis is None or axis == label or axis in label.split("+")


class CommLedger:
    """Per-(op, axis, dtype) collective counters of the collected calls."""

    def __init__(self) -> None:
        self._entries: dict[tuple[str, str, str], CommEntry] = {}
        self._transitions: list[TransitionRecord] = []

    def add(self, op: str, axes, dtype: str, *, payload: float, wire: float,
            calls: float = 1.0, backward: bool = False,
            recomputed: bool = False) -> None:
        """Count ``calls`` executions of one collective.  ``backward=True``:
        they ran in the backward pass, and count as mirrored calls and
        wire bytes only; ``recomputed=True``: a checkpoint reran a forward
        call in the backward pass, counted as recomputed calls and wire
        bytes only."""
        key = (op, _axis_label(axes), str(dtype))
        entry = self._entries.setdefault(key, CommEntry())
        if recomputed:
            entry.recomputed_calls += calls
            entry.recomputed_wire_bytes += wire * calls
        elif backward:
            entry.mirrored_calls += calls
            entry.mirrored_wire_bytes += wire * calls
        else:
            entry.calls += calls
            entry.payload_bytes += payload * calls
            entry.wire_bytes += wire * calls

    def add_transition(self, rec: TransitionRecord) -> None:
        self._transitions.append(rec)

    def transitions(self) -> tuple[TransitionRecord, ...]:
        """The layout transitions run while collecting (constraint
        backend only; empty for the explicit backend)."""
        return tuple(self._transitions)

    def _select(self, op: str | None, axis: str | None):
        for (kop, klabel, _), entry in self._entries.items():
            if (op is None or kop == op) and _label_matches(klabel, axis):
                yield entry

    def wire_bytes(self, op: str | None = None, axis: str | None = None, *,
                   train: bool = False) -> float:
        """Per-device ring wire bytes; ``train=True`` adds the backward
        pass's (forward + backward of one step: the mirrors and the
        recomputed forward calls)."""
        return sum(e.wire_bytes + (e.mirrored_wire_bytes
                                   + e.recomputed_wire_bytes
                                   if train else 0.0)
                   for e in self._select(op, axis))

    def payload_bytes(self, op: str | None = None,
                      axis: str | None = None) -> float:
        return sum(e.payload_bytes for e in self._select(op, axis))

    def call_count(self, op: str | None = None, axis: str | None = None, *,
                   train: bool = False) -> float:
        return sum(e.calls + (e.mirrored_calls + e.recomputed_calls
                              if train else 0.0)
                   for e in self._select(op, axis))

    def entries(self) -> dict[tuple[str, str, str], CommEntry]:
        return dict(self._entries)

    def as_dict(self) -> dict:
        """JSON-friendly view: ``{"op|axis|dtype": {counters...}}``."""
        return {"|".join(k): v.as_dict()
                for k, v in sorted(self._entries.items())}

    @classmethod
    def from_dict(cls, d: Mapping[str, Mapping[str, float]]) -> "CommLedger":
        """Inverse of :meth:`as_dict`; also reads the reference's."""
        ledger = cls()
        for key, counters in d.items():
            parts = key.split("|")
            if len(parts) != 3:
                raise TelemetryError(
                    f"malformed ledger key {key!r} (want 'op|axis|dtype')")
            ledger._entries[tuple(parts)] = CommEntry(**dict(counters))
        return ledger

    def merge_from(self, other: "CommLedger") -> "CommLedger":
        """Accumulate ``other``'s counters into this ledger."""
        for key, entry in other._entries.items():
            self._entries.setdefault(key, CommEntry()).merge(entry)
        return self

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)


_LEDGERS: ContextVar[tuple[CommLedger, ...]] = ContextVar(
    "repro_torch_comm_ledgers", default=())
_AS_BACKWARD: ContextVar[bool] = ContextVar("repro_torch_as_backward",
                                           default=False)
_RECOMPUTING: ContextVar[bool] = ContextVar("repro_torch_recomputing",
                                           default=False)


@contextlib.contextmanager
def collect_comm(ledger: CommLedger | None = None) -> Iterator[CommLedger]:
    """Collect the collectives run inside the block.  Nested contexts
    stack: every active ledger receives every record."""
    ledger = CommLedger() if ledger is None else ledger
    token = _LEDGERS.set(_LEDGERS.get() + (ledger,))
    try:
        yield ledger
    finally:
        _LEDGERS.reset(token)


def active_ledgers() -> tuple[CommLedger, ...]:
    return _LEDGERS.get()


@contextlib.contextmanager
def ledgers_scope(ledgers: tuple[CommLedger, ...]) -> Iterator[None]:
    """Collect into exactly ``ledgers`` inside the block: for a backward,
    which autograd runs on a thread of its own for CUDA tensors, with the
    ledgers its forward saw (:func:`active_ledgers`)."""
    token = _LEDGERS.set(tuple(ledgers))
    try:
        yield
    finally:
        _LEDGERS.reset(token)


@contextlib.contextmanager
def backward_scope() -> Iterator[None]:
    """Record the collectives run inside the block as backward calls of
    their keys (``mirrored_calls`` and ``mirrored_wire_bytes``).

    For a backward run by hand, outside autograd: the out-of-core epoch's
    split-transpose is a gather applied to the hand-propagated cotangent,
    and it is the split's backward.  The reference's ``mirror_scope``
    suppresses that call instead, because its forward split declared the
    mirror at trace time; the port declares nothing and records each
    backward when it runs, so the call is recorded, as a backward one.
    Either way one step's ledger equals the in-memory epoch's."""
    token = _AS_BACKWARD.set(True)
    try:
        yield
    finally:
        _AS_BACKWARD.reset(token)


@contextlib.contextmanager
def recompute_scope(ledgers: tuple[CommLedger, ...]) -> Iterator[None]:
    """Record the forward collectives run inside the block, into
    ``ledgers`` (those the first run saw: autograd recomputes a CUDA
    backward on a thread of its own), as recomputed calls of their keys:
    a checkpointed unit rerun in the backward pass.  The mirrors that the
    rerun's own autograd nodes would record never run (the backward uses
    the first run's nodes), so none are counted twice."""
    token = _RECOMPUTING.set(True)
    try:
        with ledgers_scope(ledgers):
            yield
    finally:
        _RECOMPUTING.reset(token)


def record(op: str, axes, x: torch.Tensor, *, group_size: int,
           backward: bool = False,
           ledgers: tuple[CommLedger, ...] | None = None) -> None:
    """Report one execution of a collective into every active ledger, or
    into ``ledgers`` where given.

    ``x`` is the per-device input operand (only its shape and dtype are
    read); ``group_size`` the number of ranks taking part.
    ``backward=True`` for the mirrored collective a backward pass runs,
    and inside :func:`backward_scope`.  No-op when no ledger is
    collecting."""
    if ledgers is None:
        ledgers = _LEDGERS.get()
    if not ledgers:
        return
    backward = backward or _AS_BACKWARD.get()
    recomputed = not backward and _RECOMPUTING.get()
    if op not in OP_COST:
        raise TelemetryError(f"unknown collective op kind {op!r} "
                             f"(known: {sorted(OP_COST)})")
    payload = float(math.prod(x.shape)) * x.element_size()
    dtype = str(x.dtype).removeprefix("torch.")
    # the ring factor is defined on the RESULT size: all_gather grows the
    # input g×, psum_scatter shrinks it g×, the rest preserve it
    if OP_COST[op] == "all_gather":
        wire = (group_size - 1) * payload
    elif op == "psum_scatter":
        wire = ring_wire_factor(op, group_size) * payload / group_size
    else:
        wire = ring_wire_factor(OP_COST[op], group_size) * payload
    for ledger in ledgers:
        ledger.add(op, axes, dtype, payload=payload, wire=wire,
                   backward=backward, recomputed=recomputed)


# ---------------------------------------------------------------------------
# Constraint-backend layout transitions
# ---------------------------------------------------------------------------

def _spec_placement(spec, ndim: int) -> dict[str, int]:
    """axis name → array dim it shards, for one spec."""
    entries = list(spec) + [None] * (ndim - len(spec))
    out: dict[str, int] = {}
    for dim, entry in enumerate(entries):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[a] = dim
    return out


def implied_collectives(shape, itemsize: int, src_spec, dst_spec,
                        axis_sizes: Mapping[str, int]) -> list[tuple]:
    """The collectives of the layout transition ``src_spec → dst_spec``
    of a global array, staged as the transitions run:

    * an axis present only in ``src`` → the replica all-gather that drops
      it, innermost (last-listed) axis first, as ``replica_gather``;
    * then an axis sharding a different dim on each side → its all-to-all
      (the paper's gather/split, ``(a, None) ↔ (None, a)``);
    * an axis present only in ``dst`` → a local slice, free (nothing).

    Returns ``[(op, axis, payload_bytes, wire_bytes), ...]``, bytes per
    device, in the ring model of :func:`record`."""
    ndim = len(shape)
    src = _spec_placement(src_spec, ndim)
    dst = _spec_placement(dst_spec, ndim)
    for a in set(src) | set(dst):
        if a not in axis_sizes:
            raise TelemetryError(
                f"layout transition names mesh axis {a!r} but the active "
                f"mesh only has axes {sorted(axis_sizes)}")
    total = float(math.prod(shape)) * itemsize
    current = dict(src)
    out: list[tuple] = []

    def sharded_by(axes) -> float:
        return float(math.prod(axis_sizes[a] for a in axes))

    removed = [a for a in src if a not in dst]
    for a in reversed(removed):
        del current[a]
        g = axis_sizes[a]
        result = total / sharded_by(current)
        out.append(("all_gather", a, result / g,
                    ring_wire_factor("all_gather", g) * result))
    for a in src:
        if a in dst and src[a] != dst[a]:
            g = axis_sizes[a]
            result = total / sharded_by(current)
            out.append(("all_to_all", a, result,
                        ring_wire_factor("all_to_all", g) * result))
    return out


def record_transition(shape, dtype: str, src_spec, dst_spec, *,
                      mirror: bool = True, anchored: bool = False) -> None:
    """Add a layout transition (a :class:`TransitionRecord`) to every
    active ledger, one record each time it runs.  Its collectives are not
    counted here: they record themselves when they run, through
    :mod:`repro_torch.runtime.collectives` — the forward at the forward
    call, the backward when autograd runs it, into the ledgers its forward
    saw.  No-op when no ledger is collecting."""
    ledgers = _LEDGERS.get()
    if not ledgers:
        return
    rec = TransitionRecord(
        shape=tuple(shape), dtype=dtype,
        src_spec=normalize_spec(src_spec), dst_spec=normalize_spec(dst_spec),
        mirror=mirror, anchored=anchored)
    for ledger in ledgers:
        ledger.add_transition(rec)


def record_h2d(tensors, *, label: str = "host") -> None:
    """Report one host→device staging of ``tensors`` (a sequence) into
    every active ledger: their total bytes under ``(H2D_OP, label,
    dtype)``, the dtype the first tensor's, with ``payload == wire`` and
    no backward.  Call it once per staging, each time it runs.  No-op when
    no ledger is collecting."""
    ledgers = _LEDGERS.get()
    if not ledgers:
        return
    payload = float(sum(t.numel() * t.element_size() for t in tensors))
    dtype = str(tensors[0].dtype).removeprefix("torch.")
    for ledger in ledgers:
        ledger.add(H2D_OP, label, dtype, payload=payload, wire=payload)
