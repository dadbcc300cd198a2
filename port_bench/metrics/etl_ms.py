"""Milliseconds a call spends in the databases' ``load_presence`` (the
benchmark's ``etl`` span), the mean over the window's calls."""


def read(run):
    per_call = run.spans.per_call("etl") if run.spans else []
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
