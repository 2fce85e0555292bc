"""learn.sweep_kernel_ms.host_paced: learn.sweep_kernel_ms in the learn cells
whose solve the host loop paces, reported apart so that their wider spread
sets a bound of its own."""

from pathlib import Path

from benchmark import harness

read = harness.load(Path(__file__).with_name("learn.sweep_kernel_ms.py"),
                    "bench_metric_learn.sweep_kernel_ms").read
