"""fslim.select_idle_ms: device idle time under the port's
``slim.cd.select`` spans (FSLIM's neighbour selection: each block's
top-k launches and the host's wait for its union count), ms per traced
learn.  None where the trace holds no such span."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    learns = sum(u.stats is not None for u in run.units)
    if run.trace is None or run.kind != "learn" or learns == 0:
        return None
    idle = spans.idle_under(run.trace, "slim.cd.select")
    return None if idle is None else 1e-3 * idle / learns
