"""The comparison that decides ``correct``.

The numbers, each read from the program's first steps against the
reference's on the same inputs:

* ``loss_gap``: the largest relative gap between the two losses over the
  first steps; ``loss1_gap``: the first step's alone (the forward at the
  initial weights);
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  program's first gradient (as AdamW got it: its first moment after one
  step over 1 − β1) and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
  ``grad_median_gap``: the median of those gaps over the moved leaves;
* ``update_gap``: the same for the parameters' change over the first
  steps, the largest over the moved leaves; ``update_median_gap``: their
  median.

A moved leaf is one whose reference gradient is at least a thousandth of
the median leaf's: a leaf whose gradient is nought moves by weight decay
alone, or not at all, and its change is not compared.  A cell compares
the numbers its ``tpbench/limits/<cell>.json`` names, each against its
limit, set in ``PERF.md`` from the program's readings on a dozen seeds
and from the lower-precision control's and the faults'.  A reading that
is not finite fails.
"""
from __future__ import annotations

import math
import statistics

import torch

NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
         "update_gap", "update_median_gap")
MOVED = 1e-3


def flatten(tree, prefix: str = "") -> dict:
    """A parameter tree's leaves by dotted path (``layers.0.w``)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def _gaps(got: dict, ref: dict, keys) -> list:
    keys = list(keys)
    floor = statistics.median(ref[k] for k in keys)
    return [abs(got[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys]


def readings(prog: dict, ref: dict) -> dict:
    """The numbers of ``prog`` against ``ref``; each is a dict of
    ``losses`` (a list), ``grad1`` and ``delta`` (leaves by path)."""
    if len(prog["losses"]) != len(ref["losses"]) or \
            set(prog["grad1"]) != set(ref["grad1"]):
        raise ValueError("the program's and the reference's readings do "
                         "not cover the same steps and leaves")
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    g_ref, g_got = _norms(ref["grad1"]), _norms(prog["grad1"])
    floor = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= MOVED * floor]
    grads = dict(zip(g_ref, _gaps(g_got, g_ref, g_ref)))
    updates = _gaps(_norms(prog["delta"]), _norms(ref["delta"]), moved)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(grads.values()),
            "grad_median_gap": statistics.median(grads[k] for k in moved),
            "update_gap": max(updates),
            "update_median_gap": statistics.median(updates)}


def detail(prog: dict, ref: dict) -> dict:
    """Where the numbers come from: each step's relative loss gap, and
    each leaf's gradient and change gaps over its own reference norm."""
    def gaps(key):
        got, want = _norms(prog[key]), _norms(ref[key])
        return {k: abs(got[k] - want[k]) / max(want[k], 1e-30)
                for k in want}
    return {"loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(prog["losses"], ref["losses"])],
            "grad_gaps": gaps("grad1"), "update_gaps": gaps("delta"),
            "grad_norms": _norms(ref["grad1"]),
            "update_norms": _norms(ref["delta"])}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number that ``limits`` names finite and
    at most its limit; ``checks`` maps each to its value and limit."""
    unknown = set(limits) - set(NAMES)
    if unknown or not limits:
        raise ValueError(f"limits name {sorted(unknown)}; the numbers are "
                         f"{NAMES}")
    checks = {k: {"value": values[k], "limit": limits[k]}
              for k in NAMES if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
