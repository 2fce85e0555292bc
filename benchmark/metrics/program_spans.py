"""What the readers of the port's own trace spans share (not a metric):
the device's idle time under a named host span, and the count of spans
whose name starts with a prefix, in the traced window of a
:class:`benchmark.tracing.Trace`.  The port opens its spans only while a
profiler runs; a program that opens none gives None and 0."""

import numpy as np

from benchmark import arith


def idle_under(trace, name: str):
    """Microseconds of the window in which no device activity runs while
    a host span ``name`` is open: the device's gaps intersected with the
    union of those spans (|gaps| + |spans| - |gaps or spans|).  None
    where the trace holds no such span."""
    spans = trace.host[[n == name for n in trace.host_names]].reshape(-1, 2)
    if len(spans) == 0:
        return None
    lo, hi = trace.lo, trace.hi
    gaps = arith.gaps(trace.device, lo, hi)
    return (arith.union_length(gaps, lo, hi)
            + arith.union_length(spans, lo, hi)
            - arith.union_length(np.concatenate([gaps, spans]), lo, hi))


def count(trace, prefix: str) -> int:
    """Host spans whose name starts with ``prefix`` and that begin inside
    the window."""
    starts = trace.host[:, 0]
    return sum(n.startswith(prefix) and trace.lo <= t < trace.hi
               for n, t in zip(trace.host_names, starts))
