"""The benchmark of ``slim_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload ml20m.learn --seed 7 --seconds 30 --trace 0

Loads and warms up the cell named in ``BENCHMARK.json`` (set-up), measures
for ``--seconds``, checks the window's outputs against the plain reference
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window), ``device`` and, with ``--trace 1``, ``breakdown``;
last ``checks``, each number compared beside its limit, which also end
standard error.

It needs the card: with no CUDA device, or fewer than the cell asks for,
it exits with code 2 and prints no result.  It exits with code 3 if JAX or
the JAX package was loaded.  Build caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness

    harness.log(f"torch imported at {time.perf_counter() - T_START:.3f} s")
    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.banned_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
