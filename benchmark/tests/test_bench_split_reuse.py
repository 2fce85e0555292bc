"""``serve.split_reuse_pct`` on hand-made traces: the share of the dense
route's splits of W served from the kept split, from the port's
``slim.predict.split`` and ``slim.predict.split_hit`` spans; None where
the window holds neither, where there is no trace, and in a learn."""

import pytest

from test_bench_program_spans import learn_run, reader, serve_run, span


def _calls(*names):
    """One request a 100 us slot, its dense set-up holding a span of each
    name; the last starts after the window and is not counted."""
    host = []
    for k, name in enumerate(names + ("slim.predict.split",)):
        t = 100 * k + (0 if k < len(names) else 1000)
        host += [span("slim.predict", t, 90),
                 span("slim.predict.dense", t + 5, 20),
                 span(name, t + 10, 10 if name == "slim.predict.split" else 0)]
    return host


@pytest.mark.parametrize("names,want", [
    (("slim.predict.split_hit",) * 4, 100.0),
    (("slim.predict.split",) + ("slim.predict.split_hit",) * 3, 75.0),
    (("slim.predict.split",) * 2, 0.0)])
def test_split_reuse_is_the_share_of_hits(names, want):
    assert reader("serve.split_reuse_pct")(serve_run(_calls(*names))) == \
        pytest.approx(want)


def test_split_reuse_reads_none_without_split_spans():
    read = reader("serve.split_reuse_pct")
    assert read(serve_run([span("bench.request", 0, 1000),
                           span("slim.predict", 0, 250)])) is None
    no_trace = serve_run(_calls("slim.predict.split_hit"))
    no_trace.trace = None
    assert read(no_trace) is None
    assert read(learn_run(_calls("slim.predict.split_hit"))) is None
