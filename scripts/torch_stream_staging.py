#!/usr/bin/env python3
"""Controls of the staging check of ``chip_smoke.py`` phase 9, on one GPU.

    python3 scripts/torch_stream_staging.py

``chip_smoke._staging_check`` stages 8 distinct pinned buffers through
``runtime.streaming.prefetched`` under a slow consumer and a slow producer
and holds every device checksum to its host source's.  This script runs
it as the code stands, then twice with one safeguard of ``stage`` patched
out at run time, and shows that the check sees each loss:

* no ``record_stream``: the copy stream reuses a consumed buffer while the
  compute stream still reads it (the slow consumer's checksums differ);
* no wait in ``Staged.take``: the compute stream reads a buffer before its
  copy lands (the slow producer's checksums differ).

Exits 0 when the check passes as committed and fails under each patch.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402


def _take_without_wait(self):
    value, self._value = self._value, None
    return value


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.runtime import streaming as RS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print("as committed:")
    CS._staging_check(dev)
    caught = 0
    for name, patch in (
            ("no record_stream", mock.patch.object(
                torch.Tensor, "record_stream", lambda self, stream: None)),
            ("no wait in Staged.take", mock.patch.object(
                RS.Staged, "take", _take_without_wait))):
        print(f"patched, {name}:")
        with patch:
            try:
                CS._staging_check(dev)
                print(f"  {name}: not seen by the check")
            except AssertionError:
                print(f"  {name}: seen by the check")
                caught += 1
        torch.cuda.synchronize()
    return 0 if caught == 2 else 1


if __name__ == "__main__":
    sys.exit(main())
