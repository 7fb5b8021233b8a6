"""Faults planted under the timed path, for the checks that show the
comparison fails them (``tpbench/tests``, ``tpbench/control.py``); the
benchmark's command plants none.

* ``unchanged``: the step returns the state it was given;
* ``half_batch``: half of the training vertices left out, the mean loss
  taken over the rest;
* ``exchange``: the all-to-alls between ranks left out (each returns what
  it was to send).
"""
from __future__ import annotations

import dataclasses

import torch

FAULTS = ("unchanged", "half_batch", "exchange")
_saved: dict = {}


def half(mask: torch.Tensor) -> torch.Tensor:
    """Every other vertex of ``mask`` (by index) kept, the rest dropped."""
    keep = torch.nonzero(mask)[::2, 0]
    out = torch.zeros_like(mask)
    out[keep] = mask[keep]
    return out


def plant_input(fault: str, bundle):
    """The bundle the program is built from, with ``fault`` planted in it
    or in the collectives under it."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of "
                         f"{FAULTS}")
    if fault == "half_batch":
        return dataclasses.replace(bundle, train_mask=half(bundle.train_mask))
    if fault == "exchange":
        from repro_torch.runtime import collectives as C
        _saved.setdefault("all_to_all", C.all_to_all)
        C.all_to_all = lambda x, *args, **kwargs: x.clone()
    return bundle


def plant_step(fault: str, train_step):
    """``train_step`` with ``fault`` planted in what it returns."""
    if fault == "unchanged":
        def step(params, state):
            return (params, state) + (train_step(params, state)[2],)
        return step
    return train_step


def clear() -> None:
    """Undo what :func:`plant_input` patched."""
    if "all_to_all" in _saved:
        from repro_torch.runtime import collectives as C
        C.all_to_all = _saved.pop("all_to_all")
