"""Host→device staging for the out-of-core epoch (``core.stream``).

The out-of-core epoch keeps the features and the per-chunk aggregation
inputs in host memory and walks them through a **double-buffered
prefetch**: while the compute stream works on staged item ``c``, item
``c+1``'s copy runs on a second CUDA stream, the copy stream.

* :func:`stage` — copy one host tree (a tensor, a dict, list or tuple of
  them, or a dataclass holding them) to the device and record its bytes
  (:func:`repro_torch.runtime.telemetry.record_h2d`).  On a card the
  copies are issued with ``non_blocking=True`` on the copy stream, from
  pinned memory only: a pageable source makes the copy synchronous, so it
  raises.  It returns a :class:`Staged` item, whose :meth:`Staged.take`
  makes the consumer's stream wait for the copies' event.  Each staged
  tensor is marked as used by the consumer's stream (``record_stream``):
  without that, the caching allocator could hand a consumed buffer back
  to the copy stream while a kernel on the compute stream still reads it.
* :func:`prefetched` — at most ``depth`` staged items ahead of the
  consumer (``depth=2``: the item being consumed and the one in flight).
* :func:`pinned` — the host tensors of a tree in pinned memory, where they
  feed a card: done once, when the host store is built.
* :func:`global_zeros` — a zero buffer on the device, with no host copy.
* :func:`sync_for_collectives` — the barrier the reference places between
  collective-bearing phases.

The reference donates each consumed buffer back to XLA to hold device
residency at two staged items; ``donation_supported`` has no counterpart
here.  The caching allocator reuses a consumed buffer once its last
reference drops and the compute stream has passed its last use (the
``record_stream`` mark).  Nothing in the epoch calls
``torch.cuda.synchronize()``: it would serialize the copies with the
compute.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterable, Iterator

import torch
import torch.distributed as dist

from . import telemetry as T

__all__ = ["Staged", "global_zeros", "pinned", "prefetched", "stage",
           "sync_for_collectives", "tree_tensors"]


def _map(fn, tree):
    """``fn`` over the tensors of ``tree``: a tensor, or dicts, lists,
    tuples and dataclasses holding tensors, at any depth (other leaves are
    kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def tree_tensors(tree) -> list:
    """The tensors of ``tree`` (as :func:`stage` takes it), in the order
    :func:`stage` copies them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_tensors(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tree_tensors(getattr(tree, f.name))]
    return []


class Staged:
    """One staged item: its device tree and, on a card, the event at which
    its copies have landed."""

    def __init__(self, value, ready: torch.cuda.Event | None = None,
                 consumer: torch.cuda.Stream | None = None):
        self._value, self._ready, self._consumer = value, ready, consumer

    def take(self):
        """Make the consumer's stream wait for the copies, and hand the
        tree over: this item keeps no reference to it, so the buffers are
        freed when the consumer drops them."""
        value, self._value = self._value, None
        if self._ready is not None:
            self._consumer.wait_event(self._ready)
        return value


def pinned(tree: Any, device) -> Any:
    """``tree`` with every host tensor in pinned memory when ``device`` is
    a card (tensors already pinned are kept); ``tree`` itself otherwise."""
    if torch.device(device).type != "cuda":
        return tree
    return _map(lambda t: t if t.is_pinned() else t.pin_memory(), tree)


def stage(tree: Any, device, *, label: str = "host",
          copy_stream: torch.cuda.Stream | None = None) -> Staged:
    """Stage the host tensors of ``tree`` on ``device`` and record their
    bytes under ``("h2d", label, dtype)``, every time it runs.

    On a CUDA ``device`` the copies run on ``copy_stream`` and every
    source must be pinned CPU memory; the current stream at the call is
    the consumer's.  Elsewhere it is a plain copy."""
    device = torch.device(device)
    leaves = tree_tensors(tree)
    if device.type != "cuda":
        T.record_h2d(leaves, label=label)
        return Staged(_map(lambda t: t.to(device, copy=True), tree))
    if copy_stream is None:
        raise ValueError("stage: staging to a CUDA device needs the copy "
                         "stream (copy_stream=)")
    for t in leaves:
        if t.device.type != "cpu" or not t.is_pinned():
            raise ValueError(
                f"stage: a {tuple(t.shape)} {t.dtype} source on {t.device} "
                f"that is not pinned host memory — its copy to {device} "
                f"would not run asynchronously.  Pin the host store once "
                f"(Tensor.pin_memory()), not per copy")
    T.record_h2d(leaves, label=label)
    consumer = torch.cuda.current_stream(device)
    with torch.cuda.stream(copy_stream):
        out = _map(lambda t: t.to(device, non_blocking=True), tree)
    ready = torch.cuda.Event()
    ready.record(copy_stream)
    for t in tree_tensors(out):
        t.record_stream(consumer)
    return Staged(out, ready, consumer)


def prefetched(items: Iterable[Any], stage_fn: Callable[[Any], Any], *,
               depth: int = 2) -> Iterator[Any]:
    """Yield ``stage_fn(item)`` for each item, keeping up to ``depth``
    staged items in flight ahead of the consumer.

    ``depth=2`` is the double buffer: when the caller receives item
    ``c``, item ``c+1`` has already been staged, so its copy overlaps the
    caller's compute on ``c``.  The generator holds at most ``depth``
    staged items."""
    if depth < 1:
        raise ValueError(f"prefetched depth must be >= 1, got {depth}")
    buf: collections.deque = collections.deque()
    for item in items:
        buf.append(stage_fn(item))
        if len(buf) > depth - 1:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def global_zeros(shape, device, dtype=torch.float32) -> torch.Tensor:
    """A zero buffer of ``shape`` allocated on ``device`` (no host copy)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def sync_for_collectives(x: Any, group=None) -> Any:
    """Barrier before the next collective-bearing phase, where the
    reference places one: over gloo at more than one process.  There a
    CUDA operand's stream is synchronized before gloo reads it from the
    host; CPU operands are complete when their op returns, and NCCL runs
    its collectives in stream order, so everywhere else (one rank
    included) it returns ``x`` at once."""
    if dist.is_initialized() and dist.get_world_size(group) > 1 \
            and dist.get_backend(group) == "gloo":
        for t in tree_tensors(x):
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
    return x
