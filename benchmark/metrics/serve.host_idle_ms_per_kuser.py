"""serve.host_idle_ms_per_kuser: device idle time inside the port's
predict calls (the gaps between device intervals of the traced window that
fall under its ``slim.predict`` spans: the route's set-up, each user
block's launches, the lists' copies to the host), ms per 1,000 users
served in the window.  None where the trace holds no such span."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    users = sum(u.work for u in run.units)
    if run.trace is None or run.kind != "serve" or users == 0:
        return None
    idle = spans.idle_under(run.trace, "slim.predict")
    return None if idle is None else 1e-3 * idle / (users / 1e3)
