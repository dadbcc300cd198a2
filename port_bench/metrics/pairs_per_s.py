"""Genome pairs of AJI written per second: the pairs of every call of the
window that succeeded, over the window (its start to the end of its last
call)."""


def read(run):
    done = sum(ok for ok, _ in run.calls)
    if not run.calls or run.window_s <= 0:
        return None
    return done * run.pairs_per_call / run.window_s
