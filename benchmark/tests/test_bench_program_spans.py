"""The readers of the port's own trace spans (``metrics/program_spans.py``
and the metrics that use it) on hand-made traces: device gaps inside,
outside and straddling the spans, the division by sweeps or users, and
None where there is no trace or no ``slim.*`` span."""

import pytest

from benchmark import harness, tracing
from benchmark.loops import Unit
from conftest import ROOT

# the window is [0, 1000) us; the device runs [100, 300) and [500, 600),
# so its gaps are [0, 100), [300, 500) and [600, 1000)
DEVICE = [("kernel", "void group_kernel<true,128>(...)", 100, 200),
          ("gpu_memcpy", "Memcpy DtoH", 500, 100)]


def reader(name):
    return harness.Bench(ROOT).reader(name)


def trace(host):
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
               "ts": 0.0, "dur": 1000.0}]
    for cat, name, ts, dur in DEVICE + host:
        events.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                       "dur": dur})
    return tracing.parse(events)


def span(name, ts, dur):
    return ("user_annotation", name, ts, dur)


LEARN_SPANS = [
    span("bench.learn", 0, 1000),
    span("slim.learn", 10, 980),
    span("slim.cd.sweep", 50, 100),     # straddles the first gap: 50
    span("slim.cd.sweep", 350, 100),    # inside the second gap: 100
    span("slim.cd.sweep", 550, 30),     # under the copy: 0
    span("slim.cd.sweep", 700, 100),    # two overlapping spans inside
    span("slim.cd.sweep", 750, 150),    # the last gap: 200 once
    span("slim.wait.live", 420, 20),
    span("slim.wait.live", 780, 10),
    span("slim.wait.live", 880, 10),
    span("slim.wait.lap", 300, 5),
    span("slim.wait.tmax", 40, 5),
    span("slim.wait.fetch", 1100, 5),   # after the window
    ("cpu_op", "aten::item", 420, 20),
]


def learn_run(host, sweeps=(20, 15)):
    units = [Unit(0, 0.0005, 1000, stats={"sweeps": s, "phases": {}})
             for s in sweeps]
    return harness.Run("c", "learn", 1.0, 0.0, 0.001, units, 0,
                       trace=trace(host))


def serve_run(host, users=(1500, 1500)):
    units = [Unit(0, 0.0005, u, route="dense") for u in users]
    return harness.Run("c", "serve", 1.0, 0.0, 0.001, units, 0,
                       trace=trace(host))


def test_idle_under_counts_gaps_inside_and_straddling_the_spans_only():
    spans = harness.load(ROOT / "benchmark" / "metrics" / "program_spans.py",
                         "bench_metric_program_spans")
    t = trace(LEARN_SPANS)
    assert spans.idle_under(t, "slim.cd.sweep") == pytest.approx(350.0)
    # a span over the whole window sees every gap: 100 + 200 + 400
    assert spans.idle_under(t, "bench.learn") == pytest.approx(700.0)
    assert spans.idle_under(t, "slim.predict") is None
    assert spans.count(t, "slim.wait.") == 5
    assert spans.count(t, "slim.cd.") == 5


@pytest.mark.parametrize("name", ["learn.loop_idle_ms",
                                  "learn.loop_idle_ms.host_paced"])
def test_loop_idle_is_per_sweep_of_the_traced_learns(name):
    read = reader(name)
    assert read(learn_run(LEARN_SPANS)) == pytest.approx(350e-3 / 35)
    assert read(learn_run(LEARN_SPANS, sweeps=(70,))) == pytest.approx(
        350e-3 / 70)
    assert read(learn_run([span("bench.learn", 0, 1000)])) is None
    assert read(learn_run(LEARN_SPANS, sweeps=(0,))) is None
    no_trace = learn_run(LEARN_SPANS)
    no_trace.trace = None
    assert read(no_trace) is None
    assert read(serve_run(LEARN_SPANS)) is None


@pytest.mark.parametrize("name", ["learn.host_waits",
                                  "learn.host_waits.host_paced"])
def test_host_waits_are_the_wait_spans_of_the_window_per_learn(name):
    read = reader(name)
    assert read(learn_run(LEARN_SPANS)) == pytest.approx(5 / 2)
    assert read(learn_run(LEARN_SPANS, sweeps=(9, 9, 9, 9, 9))) == \
        pytest.approx(1.0)
    bare = [s for s in LEARN_SPANS if not s[1].startswith("slim.wait.")]
    assert read(learn_run(bare)) is None
    assert read(learn_run([span("bench.learn", 0, 1000)])) is None
    no_trace = learn_run(LEARN_SPANS)
    no_trace.trace = None
    assert read(no_trace) is None


def test_serve_host_idle_is_per_thousand_users():
    read = reader("serve.host_idle_ms_per_kuser")
    host = [span("bench.request", 0, 1000),
            span("slim.predict", 0, 250),       # the first gap: 100
            span("slim.predict", 400, 600),     # [400, 500) and the last
            span("slim.predict.dense", 400, 50),
            span("slim.wait.lists", 900, 50)]
    assert read(serve_run(host)) == pytest.approx(0.6 / 3)
    assert read(serve_run(host, users=(600,))) == pytest.approx(0.6 / 0.6)
    assert read(serve_run([span("bench.request", 0, 1000)])) is None
    assert read(serve_run(host, users=(0,))) is None
    no_trace = serve_run(host)
    no_trace.trace = None
    assert read(no_trace) is None
    assert read(learn_run(host)) is None
