"""Double formatting byte-compatible with fmt's default ``{}`` for double.

The reference writes its CSV with ``fmt::print("{}", value)``
(src/main.cpp:160-174), which emits the shortest round-trip decimal and drops
a trailing ``.0`` for integral values (``0`` not ``0.0``).  Python's ``repr``
is also shortest-round-trip with the same fixed/exponent switchover, so the
only adjustment needed is stripping the trailing ``.0``.
"""

from __future__ import annotations

import math


def format_double(x: float) -> str:
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    s = repr(float(x))
    if s.endswith(".0"):
        s = s[:-2]
    return s
