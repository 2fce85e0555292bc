"""The comparison fails what it must.  A run is driven through the harness
on the CPU at a small size with the timed path broken underneath (the
program's entry replaced by one that returns its state unchanged, drops
half of the batch, or alters one answer where it is produced), and
``correct`` has to come out false; the sound path has to come out true.
The cells run on one card, so no exchange between cards exists to leave
out.  The controls (a lower precision in the program's place) are read
at a size a test run holds, three seeds each; on the card, at each cell's
own size."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, loops
from conftest import ROOT

CPU = torch.device("cpu")
SEEDS = (3000000011, 3000000012, 3000000013)


def run(scratch, cell):
    return harness.run_cell(harness.Bench(scratch.root), cell, 3000000009,
                            0.2, False, CPU, time.perf_counter())


def csr(indptr, indices, data, n):
    from slim_tpu_torch.types import CSR

    return CSR.from_arrays(n, n, indptr, indices, data)


def unchanged(model):
    """The zero model the solve starts from."""
    n = model.ncols
    return csr(np.zeros(n + 1, np.int64), np.zeros(0, np.int32),
               np.zeros(0, np.float32), n)


def half_left_out(model):
    """The target columns of the second half never solved."""
    keep = model.indices < model.ncols // 2
    rows = np.repeat(np.arange(model.nrows), np.diff(model.indptr))[keep]
    indptr = np.zeros(model.nrows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=model.nrows), out=indptr[1:])
    return csr(indptr, model.indices[keep], model.values()[keep],
               model.ncols)


def altered(model):
    """The largest weight written half again as large."""
    data = model.values().copy()
    data[np.argmax(data)] *= 1.5
    return csr(model.indptr, model.indices, data, model.ncols)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_learn_is_not_correct(small, monkeypatch, fault):
    from slim_tpu_torch import api

    learn = api.learn

    def broken(*a, **kw):
        model, stats = learn(*a, **kw)
        return fault(model), stats

    monkeypatch.setattr(api, "learn", broken)
    out = run(small, "small.learn")
    assert not out["correct"], out["checks"]


def lists_unchanged(ids, scores, counts):
    return np.full_like(ids, -1), np.zeros_like(scores), np.zeros_like(counts)


def lists_half_left_out(ids, scores, counts):
    ids, scores, counts = ids.copy(), scores.copy(), counts.copy()
    h = len(ids) // 2
    ids[h:], scores[h:], counts[h:] = -1, 0.0, 0
    return ids, scores, counts


def lists_altered(ids, scores, counts):
    ids = ids.copy()
    u = int(np.argmax(counts))
    others = np.setdiff1d(np.arange(ids.max() + 2), ids[u])
    ids[u, 0] = others[0]
    return ids, scores, counts


@pytest.mark.parametrize("cell", ["small.serve", "small.unpinned"])
@pytest.mark.parametrize("fault", [lists_unchanged, lists_half_left_out,
                                   lists_altered])
def test_a_broken_request_is_not_correct(small, monkeypatch, cell, fault):
    from slim_tpu_torch import api

    get_topn = api.get_topn
    monkeypatch.setattr(api, "get_topn",
                        lambda *a, **kw: fault(*get_topn(*a, **kw)))
    out = run(small, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["small.learn", "small.serve",
                                  "small.unpinned"])
def test_the_sound_path_is_correct(small, cell):
    assert run(small, cell)["correct"]


def readings(scratch, cell, seconds, dev):
    """(program numbers, control numbers, limits) of ``cell`` per seed."""
    bench = harness.Bench(scratch.root)
    cfg = bench.config(bench.cell(cell)["config"])
    kind = bench.kind(bench.traffic(bench.cell(cell)["traffic"])["kind"])
    lim = bench.limits(cell)
    for seed in SEEDS:
        t = kind.Traffic(cfg, bench.traffic(bench.cell(cell)["traffic"]),
                         seed, dev)
        t.warm()
        loops.window(t, seconds)
        yield (*control.readings(kind, t, lim["control"], dev),
               lim["limits"])


def assert_control_fails(rows):
    for prog, ctrl, lim in rows:
        assert all(prog[k] <= lim[k] for k in lim), (prog, lim)
        assert any(ctrl[k] > lim[k] for k in lim), (ctrl, lim)


@pytest.mark.parametrize("base", ["ml1m", "ml20m"])
def test_the_learn_control_fails_at_a_test_size(scratch, base):
    scratch.add_config("mid", base=base, users=3000, items=600,
                       ratings=150000, slim={"block_size": 128})
    scratch.add_cell("mid.learn", "mid", "learn_loop")
    assert_control_fails(readings(scratch, "mid.learn", 0, CPU))


@pytest.mark.parametrize("base", ["ml1m", "ml20m"])
def test_the_serve_control_fails_at_a_test_size(scratch, base):
    scratch.add_config("mid", base=base, users=1500, items=400,
                       ratings=60000, serve_model_nnz=20000)
    scratch.add_cell("mid.serve", "mid", "serve_unpinned")
    assert_control_fails(readings(scratch, "mid.serve", 0.2, CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ml1m.learn", "ml20m.learn", "ml20m.serve"])
def test_the_control_fails_at_the_cells_size_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", ",".join(map(str, SEEDS)),
         "--seconds", "3" if cell.endswith("serve") else "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900, check=True)
    lim = harness.Bench(ROOT).limits(cell)["limits"]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == len(SEEDS)
    assert_control_fails((r["program"], r["control_numbers"], lim)
                         for r in rows)
