"""Roofline terms of a dry-run record — the port of
``repro/launch/roofline.py``.

Per (arch × shape × mesh), all quantities per device:

  compute    = FLOPs / peak FLOP rate
  memory     = bytes / memory bandwidth
  collective = Σ collective wire bytes / link bandwidth

The port carries one set of peaks, the H100 SXM's from its data sheet
(:data:`H100_SXM`): 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3 and
450e9 B/s of NVLink a direction (900 GB/s both ways).  :func:`derive_terms`
takes the peaks as an argument.

Stated departure: torch has no HLO, so there is no ``hlo_census``.
:func:`census` builds the same dict (``flops``, ``bytes``, ``collectives``
with the reference's five HLO kinds, ``total`` and ``counts``) from the
per-rank program itself, run once (``launch/dryrun.py``):

* **collectives** — the run's :class:`~repro_torch.runtime.telemetry
  .CommLedger`: each key's ring wire bytes and calls, forward, backward
  (the mirrors) and a checkpoint's reruns, under the HLO kind the
  collective runs as — the mapping of ``analysis/audit.py``: an op kind
  with an all-reduce's cost (``psum``, ``grad_psum``, ``tp_psum``) is an
  ``all-reduce``, one with an all-gather's cost (``all_gather``,
  ``param_gather``, ``cache_place``, ``softmax_gather``, ``conv_gather``,
  ``last_gather``, ``tp_gather``) an ``all-gather`` whose backward mirror is a
  ``reduce-scatter``, ``all_to_all`` an ``all-to-all`` both ways,
  ``ppermute`` a ``collective-permute`` and ``psum_scatter`` a
  ``reduce-scatter``.  ``h2d`` is not a collective.
* **flops** — ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  run: the matmuls and batched products (2·m·n·k each), attention's SDPA
  and convolutions; elementwise ops count nothing, as the reference's
  census counts its ``dot`` ops alone.
* **bytes** — the eager byte model (:class:`ByteCounter`): every aten op
  an eager program dispatches materialises its output, so each op moves
  the bytes of its tensor inputs and of its outputs.  Ops that move no
  data count nothing: a view (its output aliases an input and it writes
  none), an allocation (``empty*``), a query of a tensor's metadata (no
  tensor out); a collective (``c10d``) reads its input and writes its
  output buffers.  A broadcast operand (a dim of stride 0) counts its
  distinct elements once.  The reference models XLA's
  post-fusion buffer traffic instead, which fuses elementwise chains; the
  eager model is an upper bound on the port's own traffic, not the
  reference's figure.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..runtime.telemetry import OP_COST, ring_wire_factor

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the HLO kind → the ledger's ring-cost op
_RING_OP = {"all-gather": "all_gather", "all-reduce": "psum",
            "reduce-scatter": "psum_scatter", "all-to-all": "all_to_all",
            "collective-permute": "ppermute"}

# a ledger op's ring cost → (its HLO kind, its backward mirror's)
_KINDS = {"psum": ("all-reduce", "all-reduce"),
          "all_gather": ("all-gather", "reduce-scatter"),
          "all_to_all": ("all-to-all", "all-to-all"),
          "ppermute": ("collective-permute", "collective-permute"),
          "psum_scatter": ("reduce-scatter", "all-gather")}


class Peaks(NamedTuple):
    """One device's peak rates: FLOP/s, memory B/s, link B/s."""
    flops: float
    hbm: float
    link: float


#: NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core FLOP/s, HBM3
#: bandwidth, NVLink 4 per direction (900 GB/s both ways).
H100_SXM = Peaks(flops=989e12, hbm=3.35e12, link=450e9)


def _wire_factor(kind: str, g: int) -> float:
    """Ring-algorithm per-device wire-byte factor on the RESULT size, by
    HLO kind (``runtime.telemetry.ring_wire_factor`` under its op name):
      all-gather       (g−1)/g     all-reduce   2(g−1)/g
      reduce-scatter   (g−1)       all-to-all   (g−1)/g
      collective-permute  1
    """
    return ring_wire_factor(_RING_OP[kind], g)


def _moves_bytes(func, ins, outs) -> bool:
    """Whether the aten op ``func`` reads or writes tensor data (module
    docstring)."""
    if not outs or func._opname.startswith(("empty", "new_empty")):
        return False
    if func.namespace == "c10d" or any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments):
        return True
    held = {t.untyped_storage()._cdata for t in ins}
    return not all(t.untyped_storage()._cdata in held for t in outs)


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast dim (stride 0)
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "silu", "gelu", "erf", "rsqrt", "sqrt",
                   "softplus", "_softmax", "_log_softmax", "logsumexp"}


class ByteCounter(TorchDispatchMode):
    """The eager byte model: Σ over the aten ops dispatched inside the mode
    of their tensor inputs' and outputs' bytes (:func:`_moves_bytes`,
    :func:`_distinct_bytes`).  Beside
    it, ``transcendentals``: the elements the exp, log, tanh, sigmoid,
    silu, gelu, erf, sqrt, rsqrt and softmax ops produce."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs or {}))[0]
               if isinstance(t, torch.Tensor)]
        if _moves_bytes(func, ins, outs):
            self.bytes += sum(_distinct_bytes(t) for t in ins + outs)
        if func._opname.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def ledger_collectives(ledger) -> dict:
    """The census' ``collectives`` of a ledger: wire bytes by HLO kind,
    ``total``, and ``counts`` (calls) by kind."""
    coll = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0.0 for k in _COLLECTIVES}
    for (op, _, _), e in ledger.entries().items():
        if op not in OP_COST:
            continue
        fwd, bwd = _KINDS[OP_COST[op]]
        coll[fwd] += e.wire_bytes + e.recomputed_wire_bytes
        counts[fwd] += e.calls + e.recomputed_calls
        coll[bwd] += e.mirrored_wire_bytes
        counts[bwd] += e.mirrored_calls
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    coll["counts"] = counts
    return coll


def census(ledger, flops: float, nbytes: float) -> dict:
    """The reference's census dict from one run's ledger, FLOP count and
    byte count (module docstring)."""
    return {"flops": float(flops), "bytes": float(nbytes),
            "collectives": ledger_collectives(ledger)}


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_ratio: float           # MODEL_FLOPS / (FLOPs × chips)
    coll_breakdown: dict

    def as_dict(self):
        return dataclasses.asdict(self)


def derive_terms(arch: str, shape: str, mesh_name: str, chips: int,
                 census: dict, model_flops: float,
                 peaks: Peaks = H100_SXM) -> RooflineTerms:
    """``census``: :func:`census` of one rank's program — every quantity
    per device, so each term is the quantity over the per-device peak of
    ``peaks``.  ``model_flops`` is global, so the useful-compute ratio
    divides by (per-device FLOPs × chips).  The ``hlo_*`` field names are
    the reference's, kept so that ``launch/report.py`` reads both
    packages' records."""
    flops = float(census["flops"])
    mem_bytes = float(census["bytes"])
    coll = census["collectives"]
    coll_total = float(coll.get("total", 0))
    compute_s = flops / peaks.flops
    memory_s = mem_bytes / peaks.hbm
    collective_s = coll_total / peaks.link
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=mem_bytes, coll_bytes=coll_total,
        model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        flops_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        coll_breakdown={k: coll[k] for k in _COLLECTIVES} | {
            "counts": coll["counts"]},
    )


def model_flops_for(cfg, shape) -> float:
    """6·N·D convention (N = active params, D = tokens processed).
    Decode steps process global_batch tokens; train includes the 3× of
    backward (6·N·D already counts fwd+bwd for training; for pure forward
    (prefill/decode) we use 2·N·D)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one new token per sequence
    return 2.0 * n_active * tokens
