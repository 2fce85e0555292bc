"""serve.split_reuse_pct: the share of the dense route's bfloat16 splits
of W that the port served from its kept split of a resident W, in the
traced window: 100 x ``slim.predict.split_hit`` spans / (those + the
``slim.predict.split`` spans of the splits it made).  None where the
window holds neither (a program that keeps no split opens neither)."""

from pathlib import Path

from benchmark import harness

spans = harness.load(Path(__file__).with_name("program_spans.py"),
                     "bench_metric_program_spans")


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    hits = spans.count(run.trace, "slim.predict.split_hit")
    made = spans.count(run.trace, "slim.predict.split") - hits
    return 100.0 * hits / (hits + made) if hits + made else None
