"""Spread one port test module over several test files.

pytest-xdist's ``--dist loadfile`` hands out files largest first by item
count, so a file of many items runs before the long reference files of
fewer.  A port test module whose items are many is therefore kept as a
non-test module (``tests/torch_*_cases.py``) and collected through small
``tests/test_torch_*.py`` files, each taking a part of its tests:

    import torch_lm_moe_cases as h
    globals().update(take_tests(h, "test_capacity", "test_moe_activation"))
    globals().update(take_tests(h, "test_moe_apply_across_capacity",
                                cf=(1.0, 2.0)))

Every test keeps its name, its body and its parameters; a file takes the
parameter values its keyword arguments name (all of them where it names
none), so every case runs in exactly one file.  A module fixture that
does the work of all of a module's cases at once (a spawn of ranks, a
reference child) reads the cases of its own file from the test module
(``request.module``), so each file runs its own cases only.
"""
from __future__ import annotations

import types

import pytest
from _pytest.mark.structures import ParameterSet


def _values(value, n: int) -> tuple:
    """The ``n`` components of a parametrize value (a ``pytest.param``'s
    values)."""
    if isinstance(value, ParameterSet):
        return tuple(value.values)
    return tuple(value) if n > 1 else (value,)


def _kept(mark, keep: dict):
    """``mark`` (a parametrize mark) with its values restricted to
    ``keep``; None where no value is left."""
    names, values = mark.args[0], list(mark.args[1])
    names = [n.strip() for n in names.split(",")] \
        if isinstance(names, str) else list(names)
    ids = mark.kwargs.get("ids")
    sel = []
    for i, v in enumerate(values):
        comps = _values(v, len(names))
        if all(comps[names.index(k)] in allowed
               for k, allowed in keep.items() if k in names):
            sel.append(i)
    if not sel:
        return None
    kwargs = dict(mark.kwargs)
    if isinstance(ids, (list, tuple)):
        kwargs["ids"] = [ids[i] for i in sel]
    return pytest.mark.parametrize(mark.args[0], [values[i] for i in sel],
                                   **kwargs).mark


def _argnames(fn) -> set:
    """The arguments ``fn``'s parametrize marks name."""
    out = set()
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = mark.args[0]
            out.update(n.strip() for n in names.split(",")) \
                if isinstance(names, str) else out.update(names)
    return out


def _copy(fn, keep: dict):
    """A copy of the test ``fn`` with its parameters restricted to
    ``keep``, or None where a parametrized argument keeps no value."""
    marks = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            mark = _kept(mark, keep)
            if mark is None:
                return None
        marks.append(mark)
    new = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                             fn.__defaults__, fn.__closure__)
    new.__dict__.update(fn.__dict__)
    new.__doc__, new.__qualname__ = fn.__doc__, fn.__qualname__
    new.__module__ = fn.__module__
    new.__kwdefaults__ = fn.__kwdefaults__
    new.pytestmark = marks
    return new


def take_tests(module, *names: str, **keep) -> dict:
    """The tests ``names`` of ``module``, each restricted to the parameter
    values ``keep`` names (argument → allowed values), as name → function;
    a test left with no case is left out.  Where no test is named: every
    test of ``module`` parametrized over an argument ``keep`` names (every
    test, where ``keep`` is empty too)."""
    if not names:
        names = tuple(n for n, fn in vars(module).items()
                      if n.startswith("test_") and callable(fn)
                      and (not keep or keep.keys() & _argnames(fn)))
    out = {}
    for name in names:
        fn = _copy(getattr(module, name), {k: tuple(v)
                                           for k, v in keep.items()})
        if fn is not None:
            out[name] = fn
    return out
