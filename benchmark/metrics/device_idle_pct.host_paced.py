"""device_idle_pct.host_paced: device_idle_pct.learn in the learn cells whose
solve the host loop paces, reported apart so that their wider spread sets a
bound of its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("device_idle_pct.learn.py"),
                    "bench_metric_device_idle_pct.learn").read
