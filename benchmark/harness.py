"""One run of one cell: find the cell's configuration, traffic mix and
metric readers by the names in ``BENCHMARK.json``, build and warm up the
inputs, measure for ``seconds``, read the metrics, judge the outputs
against the plain reference, and make the result line.

Everything that belongs to one configuration, mix or metric lives in a
file of its own under the benchmark's folder:

* ``configs/<config>.json``: shapes, SLIM settings and the served
  model's size;
* ``traffic/<mix>.json``: the mix's kind and parameters;
* ``kinds/<kind>.py``: the traffic of that kind and its comparison with
  the plain reference (what it provides: :mod:`.loops`);
* ``limits/<cell>.json``: the cell's ``control`` (a name in its kind's
  ``CONTROLS``) and the ``limits`` of the numbers its comparison gives;
* ``metrics/<metric>.py``: ``read(run)`` returns the metric's value from a
  :class:`Run`, or None where it finds nothing to read.

The comparison runs after the window, once the program's device state is
freed, and is not counted in ``setup_s``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import loops, tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = ("jax", "jaxlib", "flax", "slim_tpu")
# seconds of the window a --trace 1 run traces: the trace of a whole
# window of small steps takes minutes to write and read
TRACE_SECONDS = 10


@dataclasses.dataclass
class Run:
    """What one run measured, as the metric readers see it."""
    cell: str
    kind: str                 # what a unit is: "learn" or "serve"
    setup_s: float
    start: float              # the window, host clock (s)
    end: float
    units: list
    memory_peak_bytes: int
    trace: tracing.Trace | None = None


class Bench:
    """The manifest and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.manifest["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def kind(self, name: str):
        """The module ``kinds/<name>.py``."""
        return load(self.dir / "kinds" / f"{name}.py", "bench_kind_" + name)

    def metrics(self, section: str, cell: str) -> list:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that
        ``cell`` reports."""
        e2e = {m["name"]: m for m in self.manifest["end_to_end"]}

        def reports(m):
            if "workloads" in m:
                return cell in m["workloads"]
            return section == "end_to_end" or reports(e2e[m["moves"]])

        return [m for m in self.manifest[section] if reports(m)]

    def reader(self, name: str):
        return load(self.dir / "metrics" / f"{name}.py",
                    "bench_metric_" + name).read


def load(path: Path, name: str):
    """The module of the file ``path``, loaded once under ``name``."""
    name = name.replace(".", "_").replace("-", "_")
    mod = _loaded.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod


_loaded: dict = {}


def compare(limits: dict, kind, t, dev) -> dict:
    """{name: {"value", "limit"}} of the traffic ``t``'s kept outputs,
    judged by its kind's comparison against the plain reference."""
    got = kind.judge(t, t.outputs(), dev)
    return {k: {"value": got[k], "limit": lim}
            for k, lim in limits["limits"].items()}


def read_metrics(bench: Bench, section: str, run: Run) -> dict:
    """{name: {"value", "unit"}} of every metric of ``section`` the cell
    reports whose reader finds something to read."""
    out = {}
    for m in bench.metrics(section, run.cell):
        v = bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of BANNED (compared as
    whole names: ``slim_tpu_torch`` is not ``slim_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, dev, t_start: float) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``t_start`` is the process's start on the host clock."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    kind = bench.kind(mix["kind"])
    limits = bench.limits(name)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)       # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(dev)
    t = kind.Traffic(cfg, mix, seed, dev)
    log(f"inputs ready at {time.perf_counter() - t_start:.3f} s")
    t.warm()
    setup_s = time.perf_counter() - t_start
    log(f"warmed up at {setup_s:.3f} s")
    cap = tracing.Capture(dev) if trace else None
    if cap is not None:
        # the traced window is the window's first TRACE_SECONDS; the rest
        # runs untraced, so the run does the same work as an untraced one
        with cap:
            start, end, units = loops.window(
                t, min(seconds, TRACE_SECONDS), span=cap.span)
        left = seconds - (time.perf_counter() - start)
        rest = loops.window(t, left)[2] if left > 0 else []
        log(f"traced window {end - start:.3f} s, {len(units)} units; "
            f"{len(rest)} more untraced")
    else:
        start, end, units = loops.window(t, seconds)
        rest = []
        log(f"window {end - start:.3f} s, {len(units)} units")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(name, t.KIND, setup_s, start, end, units, peak,
              cap.trace if cap is not None else None)
    section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(bench, section, run)
    device = dict(device_info(dev), memory_peak_bytes=int(peak))
    out = {}
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s())
        out["breakdown"] = run.trace.breakdown()
    t.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = compare(limits, kind, t, dev)
    log(f"reference comparison {time.perf_counter() - t0:.3f} s")
    failed = sum(u.failed for u in units + rest)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return dict(correct=correct, attempted=len(units) + len(rest),
                failed=failed,
                metrics=metrics, device=device, **out, checks=checks)
