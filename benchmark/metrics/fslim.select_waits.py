"""fslim.select_waits: the FSLIM selection's blocking waits on the device,
counted as the port's ``slim.wait.select`` spans (one a selected block:
the fetch of its union count) in the traced window, per traced learn.
None where the trace holds no such span."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    learns = sum(u.stats is not None for u in run.units)
    if run.trace is None or run.kind != "learn" or learns == 0:
        return None
    waits = spans.count(run.trace, "slim.wait.select")
    return waits / learns if waits else None
