"""Host seconds of the program's ``prepare_bundle`` (placement included,
ending in a device synchronise), on the slowest rank."""


def read(run):
    return max(r["prepare_s"] for r in run["ranks"])
