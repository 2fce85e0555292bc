"""The metric arithmetic on hand-made timings and traces: window rates,
percentiles over all requests, the interval union behind the idle share,
the spread that sets a bound, and the readers that use them."""

import statistics

import numpy as np
import pytest

from benchmark import arith, harness, tracing
from benchmark.loops import Unit
from conftest import ROOT


def reader(name):
    return harness.Bench(ROOT).reader(name)


def serve_run(latencies, users=100, gap=0.0):
    """Back-to-back requests of the given latencies from t = 0."""
    units, t = [], 0.0
    for lat in latencies:
        units.append(Unit(t, t + lat, users, route="dense"))
        t += lat + gap
    return harness.Run("c", "serve", 1.0, 0.0, units[-1].t1, units, 0)


def test_rate_is_over_the_whole_window():
    assert arith.rate(30, 0.0, 10.0) == 3.0
    with pytest.raises(ValueError):
        arith.rate(1, 2.0, 2.0)


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    steady = serve_run([0.01] * 400)
    stalled = serve_run([0.01] * 370 + [0.2] * 30)
    users, p95 = reader("predict_users_per_s"), reader("predict_p95_ms")
    assert users(steady) == pytest.approx(100 / 0.01)
    assert users(stalled) < 0.5 * users(steady)
    assert p95(steady) == pytest.approx(10.0)
    assert p95(stalled) > 10 * p95(steady)


def test_percentile_is_over_every_request():
    v = list(range(1, 101))
    assert arith.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert arith.percentile([5.0], 95) == 5.0


def test_learn_rate_counts_columns_over_the_window():
    units = [Unit(0.0, 5.0, 1000), Unit(5.0, 11.0, 1000)]
    run = harness.Run("c", "learn", 1.0, 0.0, 11.0, units, 0)
    assert reader("learn_cols_per_s")(run) == pytest.approx(2000 / 11.0)
    assert reader("predict_users_per_s")(run) is None


def test_interval_union_and_gaps_on_a_hand_made_trace():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert arith.union_length(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert arith.idle_pct(iv, 0, 10) == pytest.approx(50.0)
    np.testing.assert_allclose(arith.gaps(iv, 0, 10), [[3, 5], [6, 9]])
    np.testing.assert_allclose(arith.merge(iv, 1, 10),
                               [[1, 3], [5, 6], [9, 10]])
    assert arith.union_length([], 0, 1) == 0.0


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 30.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert arith.spread(v) == pytest.approx((q3 - q1) / med)


def chrome(events):
    out = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
            "ts": 0.0, "dur": 1000.0}]
    for cat, name, ts, dur in events:
        out.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                    "dur": dur})
    out.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1})
    return out


def test_trace_parse_busy_idle_and_gaps_by_host_activity():
    t = tracing.parse(chrome([
        ("kernel", "void wg_gemm_kernel<2>(Gemm)", 100, 200),
        ("kernel", "void group_kernel<false>(...)", 250, 100),
        ("gpu_memcpy", "Memcpy DtoH", 600, 100),
        ("kernel", "outside", 1100, 50),
        ("gpu_user_annotation", "bench.learn", 0, 1000),
        ("user_annotation", "bench.learn", 0, 1000),
        ("cpu_op", "aten::item", 400, 150),
        ("cuda_runtime", "cudaStreamSynchronize", 420, 100),
    ]))
    assert t.window_s() == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(350e-6)
    assert t.device_s(["wg_gemm", "group_kernel"]) == pytest.approx(300e-6)
    idle = dict(t.idle_gaps())
    # gaps: [0,100) and [700,1000) under the span alone, [350,600) whose
    # middle falls in the synchronize inside aten::item
    assert idle["bench.learn"] == pytest.approx(400e-6)
    assert idle["cudaStreamSynchronize"] == pytest.approx(250e-6)
    ops = dict(t.device_ops())
    assert ops["Memcpy DtoH"] == pytest.approx(100e-6)
    assert "outside" not in ops


def test_trace_readers_on_a_hand_made_trace():
    t = tracing.parse(chrome([("kernel", "void wg_gemm_kernel<2>(G)", 0,
                                400)]))
    units = [Unit(0, 0.0005, 1000, stats={"sweeps": 20, "phases": {
        "gram": 1.0, "solve": 3.0, "assembly": 0.5, "harvest": 0.25}})] * 2
    run = harness.Run("c", "learn", 1.0, 0.0, 0.001, units, 0, trace=t)
    assert reader("device_idle_pct.learn")(run) == pytest.approx(60.0)
    assert reader("device_idle_pct.serve")(run) is None
    assert reader("learn.sweep_kernel_ms")(run) == pytest.approx(
        400e-3 / 40)
    assert reader("learn.sweeps")(run) == 20
    assert reader("learn.assembly_s")(run) == pytest.approx(0.75)
    assert reader("learn.gram_s")(run) == 1.0
    run = harness.Run("c", "serve", 1.0, 0.0, 0.001, [
        Unit(0, 1, 500, route="native"), Unit(1, 2, 500, route="dense")],
        0, trace=t)
    assert reader("serve.device_ms_per_kuser")(run) == pytest.approx(0.4)
    assert reader("serve.native_route_pct")(run) == 50.0


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        tracing.parse([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                        "dur": 1}])
