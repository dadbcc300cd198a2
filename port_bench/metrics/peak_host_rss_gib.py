"""The process's peak resident set during the window, in GiB."""


def read(run):
    return run.peak_rss_bytes / 2**30 if run.peak_rss_bytes else None
