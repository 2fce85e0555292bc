"""learn.solve_s.host_paced: learn.solve_s in the learn cells whose solve the
host loop paces, reported apart so that their wider spread sets a bound of
its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("learn.solve_s.py"),
                    "bench_metric_learn.solve_s").read
