"""learn.sweeps.host_paced: learn.sweeps in the learn cells whose solve the
host loop paces, reported apart so that their wider spread sets a bound of
its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("learn.sweeps.py"),
                    "bench_metric_learn.sweeps").read
