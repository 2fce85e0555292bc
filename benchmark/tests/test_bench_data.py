"""The harness is driven by data: a configuration, a traffic mix, a kind of
traffic or a metric is a new file and a new entry, found by its name.
The generators draw what the port's datagen draws, and every seed gets
the same work."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import gen, harness

CPU = torch.device("cpu")


def run(scratch, cell, seconds=0.3, seed=3000000007, trace=False):
    bench = harness.Bench(scratch.root)
    return harness.run_cell(bench, cell, seed, seconds, trace, CPU,
                            time.perf_counter())


@pytest.mark.parametrize("cell", ["small.learn", "small.serve",
                                  "small.unpinned"])
def test_a_new_configuration_runs_by_name(small, cell):
    out = run(small, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_new_mix_and_a_new_metric_are_found_by_name(small):
    root = small.root / "benchmark"
    (root / "traffic" / "serve_pairs.json").write_text(json.dumps(
        {"kind": "serve", "resident": True,
         "request_users": {"fixed": 2}, "nrcmds": 5}))
    (root / "metrics" / "predict_p50_ms.py").write_text(
        "from benchmark import arith\n\n\ndef read(run):\n"
        "    return 1e3 * arith.percentile([u.t1 - u.t0 for u in run.units],"
        " 50)\n")
    small.add_cell("small.pairs", "small", "serve_pairs")
    m = small.manifest
    m["end_to_end"].append({"name": "predict_p50_ms", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["small.pairs"]})
    small.save(m)
    out = run(small, "small.pairs")
    assert out["correct"]
    assert {"predict_p50_ms", "predict_p95_ms", "setup_s"} <= set(
        out["metrics"])
    assert "predict_p50_ms" not in run(small, "small.serve")["metrics"]


BLOCKS_KIND = '''"""Kind learn_blocks: the learn kind at the mix's block size."""

import dataclasses
from pathlib import Path

from benchmark import harness

learn = harness.load(Path(__file__).with_name("learn.py"),
                     "bench_kind_learn")


class Traffic(learn.Traffic):
    SPAN = "bench.learn_blocks"

    def __init__(self, cfg, mix, seed, dev):
        super().__init__(cfg, mix, seed, dev)
        self.slim = dataclasses.replace(self.slim,
                                        block_size=mix["block_size"])


judge, CONTROLS = learn.judge, learn.CONTROLS
'''


def test_a_new_kind_of_traffic_is_found_by_name(small, monkeypatch):
    from slim_tpu_torch import api

    root = small.root / "benchmark"
    (root / "kinds" / "learn_blocks.py").write_text(BLOCKS_KIND)
    (root / "traffic" / "learn_blocks.json").write_text(json.dumps(
        {"kind": "learn_blocks", "block_size": 32}))
    small.add_cell("small.blocks", "small", "learn_blocks",
                   like="ml20m.learn", limits="ml1m.learn")
    sizes = []
    learn = api.learn

    def spy(A, cfg, **kw):
        sizes.append(cfg.block_size)
        return learn(A, cfg, **kw)

    monkeypatch.setattr(api, "learn", spy)
    out = run(small, "small.blocks")
    assert out["correct"] and out["failed"] == 0
    assert {"learn_cols_per_s", "setup_s"} <= set(out["metrics"])
    assert set(sizes) == {32} and len(sizes) == out["attempted"] + 1
    assert run(small, "small.learn")["correct"]
    assert set(sizes) == {32, 64}


def test_the_traced_run_reports_the_cells_layer_metrics(small):
    out = run(small, "small.learn", trace=True)
    assert out["correct"]
    assert {"learn.gram_s", "learn.solve_s", "learn.sweeps",
            "learn.assembly_s"} <= set(out["metrics"])
    assert "learn_cols_per_s" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("shape", [(300, 120, 6000, 3),
                                   (2000, 700, 40000, 3000000001),
                                   (50, 40, 2000, 0)])
def test_the_matrix_is_the_ports_synth_implicit(shape):
    from slim_tpu_torch.datagen import synth_implicit

    nrows, ncols, nnz, seed = shape
    want = synth_implicit(nrows, ncols, nnz, seed)
    indptr, indices = gen.implicit_matrix(nrows, ncols, nnz, seed)
    np.testing.assert_array_equal(indptr, want.indptr)
    np.testing.assert_array_equal(indices, want.indices)
    assert want.data is None


@pytest.mark.parametrize("shape", [(300, 120, 6000, 3),
                                   (2000, 700, 40000, 3000000001)])
def test_the_matrix_holds_the_configurations_ratings(shape):
    from slim_tpu_torch.datagen import synth_implicit

    nrows, ncols, nnz, seed = shape
    indptr, indices = gen.implicit_matrix(nrows, ncols, nnz, seed,
                                          distinct=nnz)
    assert indptr[-1] == nnz == len(indices)
    rows = np.repeat(np.arange(nrows), np.diff(indptr))
    key = rows.astype(np.int64) * ncols + indices
    assert (np.diff(key) > 0).all()
    want = synth_implicit(nrows, ncols, nnz, seed)
    assert want.indptr[-1] < nnz
    first = np.repeat(np.arange(nrows), np.diff(want.indptr)) * ncols \
        + want.indices
    assert np.isin(first, key).all()
    again = gen.implicit_matrix(nrows, ncols, nnz, seed, distinct=nnz)
    np.testing.assert_array_equal(again[1], indices)


def test_bucket_search_is_searchsorted():
    rng = np.random.default_rng(1)
    for ncols, exp in ((3706, 0.6), (200, 0.6), (64, 2.5)):
        p = 1.0 / np.arange(1, ncols + 1) ** exp
        cdf = np.cumsum(p / p.sum())
        r = np.concatenate([rng.random(100_000), cdf[:-1],
                            np.nextafter(cdf[:-1], 1), [0.0]])
        r = r[r < 1]
        np.testing.assert_array_equal(gen.bucket_search(cdf)(r),
                                      np.searchsorted(cdf, r))


def test_the_served_model_has_its_size_and_no_diagonal():
    n, nnz = 200, 5000
    pop = gen.popularity(n, 0.6)
    indptr, indices, data = gen.serve_model(n, nnz, pop, 11, CPU)
    assert indptr[-1] == nnz and len(indices) == nnz
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert not (indices == rows).any() and (data >= 1e-3).all()
    assert (data <= 1).all()
    key = rows.astype(np.int64) * n + indices
    assert (np.diff(key) > 0).all()
    np.testing.assert_array_equal(
        np.diff(indptr), gen.row_counts(pop, nnz, n - 1))
    again = gen.serve_model(n, nnz, pop, 11, CPU)
    np.testing.assert_array_equal(again[1], indices)


def test_every_seed_gets_the_same_request_sizes():
    spec = {"log_uniform": [1, 1024], "cycle": 256}
    a = gen.request_plan(6040, spec, 1)
    b = gen.request_plan(6040, spec, 3000000002)
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert [len(x) for x in a] != [len(x) for x in b]
    assert min(map(len, a)) == 1 and max(map(len, a)) <= 1024
    fixed = gen.request_plan(1000, {"fixed": 64}, 5)
    assert {len(x) for x in fixed} == {64}
    assert set(np.concatenate(fixed)) == set(range(1000))


def test_sub_rows_takes_the_rows_in_order():
    indptr = np.array([0, 2, 2, 5])
    indices = np.array([1, 3, 0, 2, 4], dtype=np.int32)
    ptr, idx = gen.sub_rows(indptr, indices, np.array([2, 0, 1, 2]))
    np.testing.assert_array_equal(ptr, [0, 3, 5, 5, 8])
    np.testing.assert_array_equal(idx, [0, 2, 4, 1, 3, 0, 2, 4])


def test_a_relabelled_matrix_is_the_same_log_in_another_order():
    indptr, indices = gen.implicit_matrix(400, 150, 8000, 0)
    new_row, new_col = gen.relabel_maps(400, 150, 3000000003)
    a_ptr, a_idx = gen.relabel(indptr, indices, new_row, new_col)
    again = gen.relabel_maps(400, 150, 3000000003)
    np.testing.assert_array_equal(again[1], new_col)
    np.testing.assert_array_equal(
        np.diff(a_ptr)[new_row], np.diff(indptr))
    np.testing.assert_array_equal(
        np.bincount(a_idx, minlength=150)[new_col],
        np.bincount(indices, minlength=150))
    rows = np.repeat(np.arange(400), np.diff(a_ptr))
    assert (np.diff(rows * 150 + a_idx) > 0).all()
    assert not np.array_equal(a_idx, indices)
