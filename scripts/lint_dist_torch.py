#!/usr/bin/env python
"""Distributed-discipline linter CLI for the PyTorch port.

Runs the AST rule registry in ``repro_torch.analysis.lint`` and exits
nonzero iff any *error*-severity finding survives (``# lint-ok: RULE``
suppressions honored; ``warn`` rules such as W100 report but never fail):

    python scripts/lint_dist_torch.py                  # src/repro_torch
    python scripts/lint_dist_torch.py --json out.json  # + machine-readable
    python scripts/lint_dist_torch.py --rules          # the rule table
    python scripts/lint_dist_torch.py path/to/file.py  # lint something else
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.analysis import lint  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AST linter for the port's distributed disciplines")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write findings as a JSON artifact")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.rules:
        for rule in lint.all_rules():
            print(f"{rule.id}  [{rule.severity}]  {rule.invariant}")
        return 0

    paths = args.paths or [os.path.join(_ROOT, "src", "repro_torch")]
    findings = lint.lint_paths(paths)

    errors = [f for f in findings if f.severity == "error"]
    warns = [f for f in findings if f.severity != "error"]
    for f in findings:
        print(f.format())

    if args.json:
        artifact = {
            "rules": {r.id: {"severity": r.severity,
                             "invariant": r.invariant}
                      for r in lint.all_rules()},
            "findings": [f.as_dict() for f in findings],
            "counts": {"error": len(errors), "warn": len(warns)},
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(artifact, fh, indent=2, sort_keys=True)
            fh.write("\n")

    print(f"lint_dist_torch: {len(errors)} error(s), {len(warns)} "
          f"warning(s) across {len(paths)} path(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
