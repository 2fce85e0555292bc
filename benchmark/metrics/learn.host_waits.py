"""learn.host_waits: the learn's main thread's blocking waits on the
device, counted as the port's ``slim.wait.*`` spans in the traced window
(the sweep loop's liveness checks and sweep bounds, the harvest's fetches
and drains, the screen's copies, the phase clock's syncs), per traced
learn.  None where the trace holds no such span."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    learns = sum(u.stats is not None for u in run.units)
    if run.trace is None or run.kind != "learn" or learns == 0:
        return None
    waits = spans.count(run.trace, "slim.wait.")
    return waits / learns if waits else None
