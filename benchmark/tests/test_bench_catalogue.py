"""The sparse reference (``reference/sparse_learn.py``, through the kind
``catalogue_learn``) on the CPU: it agrees with the dense reference
(``reference/learn.py``) column by column, the port's long-tail learn on
the compact path reads sound against it, and models that are not the
optimum read ``correct`` false, as does the TF32 control.  The cell's own
wiring runs through the harness on a small scratch configuration."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import gen, harness
from benchmark.reference import learn as ref_learn
from benchmark.reference import sparse_learn as ref_sparse
from conftest import ROOT
from test_bench_faults import (SEEDS, altered, assert_control_fails,
                               half_left_out, readings, unchanged)

CPU = torch.device("cpu")
# The solver stops a column when a sweep moves it by less than
# sqrt(optTol) = 3.2e-4; one exact CD step from where it stopped is of
# that order, so a sound model reads under 1e-3.
KKT_TOL = 1e-3
SLIM = dict(l1r=1.0, l2r=1.0, optTol=1e-7, block_size=128,
            compact_threshold=256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kind():
    return harness.Bench(ROOT).kind("catalogue_learn")


def traffic(users, items, ratings, seed=11):
    """What the kind's ``judge`` reads of a run's traffic: a seeded
    long-tail implicit matrix (rank^-0.6 items)."""
    from slim_tpu_torch.config import SlimConfig

    indptr, indices = gen.implicit_matrix(users, items, ratings, seed, 0.6,
                                          distinct=ratings)
    return type("T", (), dict(slim=SlimConfig(**SLIM), indptr=indptr,
                              indices=indices, nrows=users, ncols=items))()


def drawn(n, seed=4):
    """A drawn nonnegative model with no diagonal, as host CSR arrays."""
    return gen.serve_model(n, 12 * n, gen.popularity(n, 0.6), seed, CPU)


def stepped(t, model):
    """``model`` after one exact CD update of every coordinate."""
    n = t.ncols
    G = ref_learn.gram(t.indptr, t.indices, n, CPU)
    ent = ref_learn.model_entries(*model, CPU)
    keys, vals = [], []
    for c0 in range(0, n, 256):
        c1 = min(c0 + 256, n)
        W = ref_learn._dense_cols(ent, c0, c1, n, CPU)
        new, _ = ref_learn.coordinate_steps(G, W, c0, 1.0, 1.0)
        r, c = new.nonzero(as_tuple=True)
        keys.append(r * n + c + c0)
        vals.append(new[r, c].float())
    key, o = torch.sort(torch.cat(keys))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount((key // n).numpy(), minlength=n), out=indptr[1:])
    return (indptr, (key % n).to(torch.int32).numpy(),
            torch.cat(vals)[o].numpy())


@pytest.mark.parametrize("which", ["drawn", "stepped"])
def test_the_sparse_reference_agrees_with_the_dense_one(which):
    """Every column's step length within 1e-9 of the largest, and the same
    bad entries, in blocks narrower than the catalogue."""
    t = traffic(400, 900, 9000)
    model = drawn(t.ncols)
    if which == "stepped":
        model = stepped(t, model)
    G = ref_learn.gram(t.indptr, t.indices, t.ncols, CPU)
    want = ref_learn.step_norms(G, ref_learn.model_entries(*model, CPU),
                                t.ncols, 1.0, 1.0)
    R = ref_sparse.Ratings(t.indptr, t.indices, t.ncols, CPU)
    got = ref_sparse.step_norms(
        R, [ref_sparse.model_entries(*model, CPU)], 1.0, 1.0, cols=256)[0]
    assert want.max() > 0.1
    assert np.abs(got - want).max() <= 1e-9 * want.max()
    bad = dict(kind().judge(t, [model], CPU))
    assert bad["bad_entries"] == ref_learn.bad_entries(*model, t.ncols)
    assert abs(bad["kkt_step"] - want.max()) <= 1e-9 * want.max()


@pytest.fixture(scope="module")
def tail():
    """The port's learn of an 800 x 3,000 long-tail matrix with a compact
    threshold of 256: one full-width block, unions 256-2,048 wide."""
    from slim_tpu_torch import api
    from slim_tpu_torch.config import SlimConfig
    from slim_tpu_torch.types import CSR

    t = traffic(800, 3000, 24000)
    A = CSR.from_arrays(t.nrows, t.ncols, t.indptr, t.indices)
    model, stats = api.learn(A, SlimConfig(**SLIM), device="cpu")
    return t, kind().learn.model_arrays(model), stats


def test_a_long_tail_learn_passes_the_sparse_reference(tail):
    t, model, stats = tail
    widths = stats["union_widths"]
    assert len(widths) >= 4 and min(widths) < 1024 < max(widths)
    got = kind().judge(t, [model], CPU)
    assert got["bad_entries"] == 0 and got["kkt_step"] < KKT_TOL, got


@pytest.mark.parametrize("fault", [half_left_out, altered])
def test_a_model_that_is_not_the_optimum_is_not_correct(tail, fault):
    from slim_tpu_torch.types import CSR

    t, model, _ = tail
    m = fault(CSR.from_arrays(t.ncols, t.ncols, *model))
    got = kind().judge(t, [kind().learn.model_arrays(m)], CPU)
    assert got["bad_entries"] > 0 or got["kkt_step"] >= KKT_TOL, got


@pytest.fixture
def csmall(scratch):
    """A small catalogue cell on the scratch copy, with amzbook.learn's
    metrics and limits."""
    scratch.add_config("csmall", base="amzbook", users=300, items=700,
                       ratings=6000, slim={"block_size": 64,
                                           "compact_threshold": 128})
    scratch.add_cell("csmall.learn", "csmall", "catalogue_learn_loop",
                     like="amzbook.learn", limits="amzbook.learn")
    return scratch


def run(scratch):
    return harness.run_cell(harness.Bench(scratch.root), "csmall.learn",
                            3000000023, 0.2, False, CPU, time.perf_counter())


def test_the_cell_runs_through_the_harness(csmall):
    out = run(csmall)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert {"learn_cols_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_learn_is_not_correct(csmall, monkeypatch, fault):
    from slim_tpu_torch import api

    learn = api.learn

    def broken(*a, **kw):
        model, stats = learn(*a, **kw)
        return fault(model), stats

    monkeypatch.setattr(api, "learn", broken)
    out = run(csmall)
    assert not out["correct"], out["checks"]


def test_the_catalogue_control_fails_at_a_test_size(scratch):
    """At a long-tail size whose popular items hold counts above TF32's
    exact integers (2,048), as the cell's do: the program reads under the
    cell's limit and the TF32 control over it."""
    scratch.add_config("cmid", base="amzbook", users=30000, items=1000,
                       ratings=300000, slim={"block_size": 256})
    scratch.add_cell("cmid.learn", "cmid", "catalogue_learn_loop",
                     like="amzbook.learn", limits="amzbook.learn")
    assert_control_fails(readings(scratch, "cmid.learn", 0, CPU))


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload",
         "amzbook.learn", "--seeds", ",".join(map(str, SEEDS)),
         "--seconds", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1800, check=True)
    lim = harness.Bench(ROOT).limits("amzbook.learn")["limits"]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == len(SEEDS)
    assert_control_fails((r["program"], r["control_numbers"], lim)
                         for r in rows)
