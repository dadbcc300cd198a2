"""Milliseconds a call spends writing its CSV, the mean over the window's
calls: the banded and streamed engines' own ``CSV write`` phase (the
writer's busy time), else the benchmark's ``csv`` span around the CLI's
``write_aji_csv``."""


def read(run):
    if not run.spans:
        return None
    per_call = (run.spans.phase_per_call("CSV write")
                or run.spans.per_call("csv"))
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
