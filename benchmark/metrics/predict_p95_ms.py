"""predict_p95_ms: the 95th percentile of request latency over every
request of the window, each from send to lists on the host."""

from benchmark import arith


def read(run):
    if run.kind != "serve":
        return None
    return 1e3 * arith.percentile([u.t1 - u.t0 for u in run.units], 95)
