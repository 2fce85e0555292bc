"""learn.host_waits.host_paced: learn.host_waits in the learn cells whose
solve the host loop paces, reported apart so that their wider spread sets
a bound of its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("learn.host_waits.py"),
                    "bench_metric_learn.host_waits").read
