"""learn.loop_idle_ms.host_paced: learn.loop_idle_ms in the learn cells
whose solve the host loop paces, reported apart so that their wider spread
sets a bound of its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("learn.loop_idle_ms.py"),
                    "bench_metric_learn.loop_idle_ms").read
