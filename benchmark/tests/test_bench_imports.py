"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or the JAX package slim_tpu (compared as whole names, since the port
slim_tpu_torch begins with slim_tpu), and a reference that imports nothing
of the program; and no run without a card."""

import ast
import json
import os
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

PROBE = """
import importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from benchmark import control, gen, harness, loops, tracing
import slim_tpu_torch.api, slim_tpu_torch.predict
bench = harness.Bench(Path({root!r}))
m = bench.manifest
for w in m["workloads"]:
    bench.config(w["config"]); bench.limits(w["name"])
    bench.kind(bench.traffic(w["traffic"])["kind"])
for metric in m["end_to_end"] + m["per_layer"]:
    bench.reader(metric["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    names = top_level_after(PROBE.format(
        root=str(ROOT), run=str(ROOT / "benchmark" / "run.py")))
    assert "slim_tpu_torch" in names and "benchmark" in names
    assert not names & set(harness.BANNED)


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "slim_tpu_torchish", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert not set(harness.banned_modules()) & {"slim_tpu_torchish",
                                                 "jaxtyping_like"}
    monkeypatch.setitem(sys.modules, "slim_tpu.ops", object())
    assert "slim_tpu" in harness.banned_modules()


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{path.name}: relative import"
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("__future__", "numpy", "torch"), \
                    f"{path.name} imports {mod}"
    names = top_level_after(
        f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
        "import benchmark.reference.learn, benchmark.reference.serve; "
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert "slim_tpu_torch" not in names and not names & set(harness.BANNED)


def test_run_exits_nonzero_and_prints_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml1m.learn",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
