"""Rank 0's ring wire bytes of one training step, forward and backward,
as the program's collective ledger counts them
(``repro_torch.runtime.telemetry.CommLedger.wire_bytes(train=True)``),
in MB (10^6 bytes)."""


def read(run):
    r0 = run["ranks"][0]
    if not r0["trace"] or r0["shapes"]["world"] == 1:
        return None
    return r0["trace"]["wire_bytes"] / 1e6
