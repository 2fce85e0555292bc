"""bench_torch.py, the port's benchmark, on the CPU: its JSON line and its
baseline cache.

The SLIM_BENCH_SMALL workload (943 x 1,682, 100k ratings) takes about two
minutes a learn on the port's plain CPU path, so the run here keeps the
script's every step but swaps its workload for the vendored synth set."""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from slim_tpu_torch import native  # noqa: E402
from slim_tpu_torch.io.readers import read_matrix  # noqa: E402

# bench.py's keys, tpu_learn_s renamed learn_s
KEYS = {"metric", "value", "unit", "vs_baseline", "learn_s",
        "predict_users_per_sec", "predict_vs_baseline",
        "cpu_baseline_columns_per_sec", "cpu_predict_users_per_sec",
        "objective", "cpu_objective", "model_nnz", "ncols", "device",
        "cpu_baseline_threads"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synth():
    return read_matrix(os.path.join(REPO, "tests", "data", "synth-train.ijv"),
                       fmt="ijv")


def test_bench_torch_cpu_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setenv("SLIM_BENCH_SMALL", "1")
    monkeypatch.setenv("SLIM_BENCH_REPS", "1")
    monkeypatch.setattr(bench_torch, "load_workload",
                        lambda: (_synth(), "synth", False))
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("learn: min ")
    out = json.loads(lines[-1])
    assert set(out) == KEYS and out["device"] == "cpu"
    assert out["metric"] == "synth_cd_item_columns_per_sec"
    assert out["value"] == out["ncols"] / out["learn_s"]
    np.testing.assert_allclose(out["objective"], out["cpu_objective"],
                               rtol=1e-4)
    assert out["cpu_baseline_threads"] == os.cpu_count()
    for k in KEYS - {"metric", "unit", "device"}:
        assert np.isfinite(out[k]) and out[k] > 0, k


def test_bench_torch_baseline_cache(monkeypatch, tmp_path):
    """The cached baseline is read back only for its own signature (the
    workload, the CPU count and the CPU model), and never from the JAX
    bench's bench_baseline.json."""
    cache = tmp_path / "build" / "bench_torch_baseline.json"
    monkeypatch.setattr(bench_torch, "BASELINE_CACHE", str(cache))
    assert os.path.basename(bench_torch.BASELINE_CACHE) != \
        "bench_baseline.json"
    trn = _synth().infer_ncols()
    model, _, _ = native.cd_learn(trn)
    calls = []
    orig = native.cd_learn
    monkeypatch.setattr(native, "cd_learn",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    first = bench_torch.bench_cpu(trn, model, cached=True)
    assert len(calls) == 1 and cache.exists()
    assert json.loads(cache.read_text())["sig"]["cpu_model"] == \
        native.cpu_model()
    assert bench_torch.bench_cpu(trn, model, cached=True) == first
    assert len(calls) == 1
    monkeypatch.setattr(native, "cpu_model", lambda: "another CPU")
    bench_torch.bench_cpu(trn, model, cached=True)
    assert len(calls) == 2
    bench_torch.bench_cpu(trn, model, cached=False)
    assert len(calls) == 3


@pytest.mark.parametrize("knob,shape,nnz,digest", [
    ("SLIM_BENCH_SMALL", (943, 1682), 45955,
     "b7833efc16d1559b1eea9c4702f3e10a"),
    ("SLIM_BENCH_LARGE", (50000, 10000), 1271091,
     "c8f7b26f5e1e9fdcee8992b6d633a8df")])
def test_bench_workloads_are_fixed_matrices(monkeypatch, knob, shape, nnz,
                                            digest):
    """The SMALL and LARGE workloads draw their items from numpy 2.0's zipf
    stream (datagen.zipf), so each is the stored matrix under any numpy."""
    import hashlib

    monkeypatch.setenv(knob, "1")
    mat, _, cached = bench_torch.load_workload()
    assert not cached and mat.shape == shape and mat.nnz == nnz
    got = hashlib.sha256(mat.indptr.astype("<i8").tobytes()
                         + mat.indices.astype("<i4").tobytes()
                         + mat.values().astype("<f4").tobytes())
    assert got.hexdigest()[:32] == digest
