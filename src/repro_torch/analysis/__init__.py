"""Static and run-time checks of the port's distributed disciplines.

* :mod:`repro_torch.analysis.lint` — an AST linter over the source tree
  (rules RT001–RT005 and W100, the reference's table; CLI:
  ``scripts/lint_dist_torch.py``): collectives only through
  ``runtime/collectives.py``, DTensor moving no data outside
  ``constraint.replicate``, explicit ``mirror=`` on layout transitions,
  the process group opened only by ``runtime/distributed.py``.
* :mod:`repro_torch.analysis.audit` — the collectives one step really
  issues, counted by ``torch.profiler`` below the choke point, forward
  and backward, diffed against the collective ledger (the counterpart of
  the reference's ``jaxpr_audit``).  It imports torch, so it is not
  imported here: the linter runs without it.
"""
from . import lint  # noqa: F401

__all__ = ["audit", "lint"]
