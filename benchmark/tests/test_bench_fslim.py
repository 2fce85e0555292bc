"""The FSLIM reference (``reference/fslim.py``, through the kind
``fslim_learn``) against the port on the CPU: the port's FSLIM models
(``nnbrs`` 10, ``cos``) read sound at full width, on the compact path and
where the similarities tie at the 10th place, and models that are not
FSLIM's optimum each read ``correct`` false.  The cell's own wiring runs
through the harness on a small scratch configuration."""

import time
import types

import numpy as np
import pytest
import torch

from benchmark import gen, harness
from benchmark.reference import fslim as ref_fslim
from benchmark.reference import learn as ref_learn
from conftest import ROOT

CPU = torch.device("cpu")
NNBRS = 10
USERS, ITEMS, RATINGS = 400, 280, 8000   # npad 384: unions of 256 fit
# The solver stops a column when a sweep moves it by less than
# sqrt(optTol) = 3.2e-4; one exact CD step from where it stopped is of
# that order (the port reads 3.1e-4 to 3.8e-4 here), so a sound model
# reads under 1e-3, and a step of 1e-3 or more is not FSLIM's optimum.
KKT_TOL = 1e-3
SLIM = dict(l1r=1.0, l2r=1.0, optTol=1e-7, nnbrs=NNBRS, simtype="cos",
            block_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kind():
    return harness.Bench(ROOT).kind("fslim_learn")


def ratings(tied=False):
    """(indptr, indices, ncols): a seeded implicit matrix; ``tied`` adds
    30 copies of a popular item, so that many columns see 31 equal
    similarities, which straddle the 10th place of some."""
    indptr, indices = gen.implicit_matrix(USERS, ITEMS, RATINGS, 5, 0.6,
                                          distinct=RATINGS)
    if not tied:
        return indptr, indices, ITEMS
    rows = np.repeat(np.arange(USERS), np.diff(indptr))
    holders = rows[indices == 20]
    extra = np.repeat(holders, 30)
    cols = np.tile(ITEMS + np.arange(30), len(holders))
    key = np.sort(np.concatenate([rows * (ITEMS + 30) + indices,
                                  extra * (ITEMS + 30) + cols]))
    out = np.zeros(USERS + 1, np.int64)
    np.cumsum(np.bincount(key // (ITEMS + 30), minlength=USERS), out=out[1:])
    return out, (key % (ITEMS + 30)).astype(np.int32), ITEMS + 30


def traffic(indptr, indices, ncols):
    """What the kind's ``judge`` reads of a run's traffic."""
    from slim_tpu_torch.config import SlimConfig

    return types.SimpleNamespace(slim=SlimConfig(**SLIM), indptr=indptr,
                                 indices=indices, nrows=USERS, ncols=ncols)


def learned(t, **changes):
    """The port's model of ``t``'s matrix as host (indptr, indices, data)."""
    from slim_tpu_torch import api
    from slim_tpu_torch.config import SlimConfig
    from slim_tpu_torch.types import CSR

    A = CSR.from_arrays(t.nrows, t.ncols, t.indptr, t.indices)
    model, _ = api.learn(A, SlimConfig(**dict(SLIM, **changes)),
                         device="cpu")
    return kind().learn.model_arrays(model)


def correct(numbers) -> bool:
    return numbers["bad_entries"] == 0 and numbers["kkt_step"] < KKT_TOL


@pytest.fixture(scope="module")
def plain():
    t = traffic(*ratings())
    return t, learned(t)


SOUND = {"full-width": (False, {}),
         "compact": (False, dict(compact_threshold=64)),
         "tied": (True, dict(compact_threshold=64))}


@pytest.mark.parametrize("case", sorted(SOUND))
def test_the_port_is_fslims_optimum(case, plain):
    tied, changes = SOUND[case]
    t = traffic(*ratings(tied))
    if tied:
        G = ref_learn.gram(t.indptr, t.indices, t.ncols, CPU)
        nb = ref_fslim.Neighbours(G, NNBRS)
        allowed, sure = nb.sets(0, t.ncols)
        # columns whose 10th place is a tie: more allowed than 10, fewer
        # sure than 10
        ties = (allowed.sum(0) > NNBRS) & (sure.sum(0) < NNBRS)
        assert int(ties.sum()) >= 10
    model = plain[1] if case == "full-width" else learned(t, **changes)
    got = kind().judge(t, [model], CPU)
    assert got["bad_entries"] == 0 and got["kkt_step"] < KKT_TOL, got


def full_slim(t, model):
    return learned(t, nnbrs=0)


def by_dotp(t, model):
    return learned(t, simtype="dotp")


def one_weight_up(t, model):
    indptr, indices, data = model
    data = data.copy()
    data[np.argmax(data)] *= 1.5
    return indptr, indices, data


def an_eleventh_entry(t, model):
    """The column with the most entries given more, at its best
    candidates not yet in it, until it holds NNBRS + 1."""
    indptr, indices, data = model
    n = t.ncols
    rows = np.repeat(np.arange(n), np.diff(indptr))
    counts = np.bincount(indices, minlength=n)
    j = int(np.argmax(counts))
    G = ref_learn.gram(t.indptr, t.indices, n, CPU)
    sim = ref_fslim.Neighbours(G, NNBRS).similarity(j, j + 1)[:, 0]
    have = set(rows[indices == j].tolist())
    new = [int(i) for i in torch.argsort(sim, descending=True)
           if int(i) not in have][:NNBRS + 1 - counts[j]]
    rows = np.concatenate([rows, new])
    cols = np.concatenate([indices, np.full(len(new), j, np.int32)])
    vals = np.concatenate([data, np.full(len(new), 1e-3, np.float32)])
    o = np.lexsort((cols, rows))
    out = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=out[1:])
    return out, cols[o].astype(np.int32), vals[o]


@pytest.mark.parametrize("fault", [full_slim, by_dotp, one_weight_up,
                                   an_eleventh_entry])
def test_a_model_that_is_not_fslims_optimum_is_not_correct(plain, fault):
    t, model = plain
    assert correct(kind().judge(t, [model], CPU))
    got = kind().judge(t, [fault(t, model)], CPU)
    assert not correct(got), got


def test_the_cell_runs_through_the_harness(scratch):
    scratch.add_config("fsmall", base="ml20m.fslim", users=USERS,
                       items=ITEMS, ratings=RATINGS,
                       slim={"block_size": 64, "nnbrs": NNBRS,
                             "compact_threshold": 64})
    scratch.add_cell("fsmall.learn", "fsmall", "fslim_learn_loop",
                     like="ml20m.fslim.learn", limits="ml20m.fslim.learn")
    out = harness.run_cell(harness.Bench(scratch.root), "fsmall.learn",
                           3000000021, 0.2, False, CPU, time.perf_counter())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert {"learn_cols_per_s.host_paced", "setup_s"} <= set(out["metrics"])
