"""learn.loop_idle_ms: device idle time inside the CD loop's sweeps (the
gaps between device intervals of the traced window that fall under the
port's ``slim.cd.sweep`` spans: each sweep's host work, its launches and
its liveness wait), ms per block sweep of the traced learns.  None where
the trace holds no such span."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    sweeps = sum(u.stats["sweeps"] for u in run.units if u.stats is not None)
    if run.trace is None or run.kind != "learn" or sweeps == 0:
        return None
    idle = spans.idle_under(run.trace, "slim.cd.sweep")
    return None if idle is None else 1e-3 * idle / sweeps
