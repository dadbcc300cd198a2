"""Phase timing + peak-RSS reporting.

Equivalent of the reference's timer_impl / PRINT_RUNTIME_MEMUSED
(utils.hpp:100-200): every pipeline phase prints elapsed wall-clock and peak
resident set size.
"""

from __future__ import annotations

import contextlib
import resource
import sys
import time


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


@contextlib.contextmanager
def phase_timer(label: str, out=sys.stdout, enabled: bool = True):
    start = time.monotonic()
    yield
    if enabled:
        elapsed_ms = (time.monotonic() - start) * 1000.0
        print(
            f"{label}: {elapsed_ms:.1f} ms; peak RSS {peak_rss_mb():.1f} MB",
            file=out,
        )
