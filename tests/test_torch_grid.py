"""The packed grid CD of the PyTorch port (``solvers/cd.estimate_grid_cd``,
``mselect_grid(parallel=True)``) against one-point solves and against the
JAX package's ``estimate_grid_cd`` / ``mselect_grid`` on JAX-CPU."""

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.mselect import mselect_grid as jax_mselect_grid
from slim_tpu.solvers.cd import estimate_grid_cd as jax_grid
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.mselect import mselect_grid
from slim_tpu_torch.solvers import cd as C
from slim_tpu_torch.types import CSR

POINTS = [(0.2, 0.5), (1.0, 2.0), (3.0, 0.1)]   # tests/test_mselect.py:33


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(mat):
    return CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                           mat.data)


def _data(seed):
    rng = np.random.default_rng(seed)
    return (random_csr(rng, 60, 30, density=0.25, seed=seed),
            random_csr(rng, 60, 30, density=0.05, seed=seed + 1))


@pytest.mark.parametrize("block", [16, 20, 128])
def test_grid_matches_one_point_solves(block):
    """Each point of the packed pass against its own estimate_model_cd:
    W atol 5e-4, loss rtol 1e-4 (tests/test_mselect.py:29-42).  n = 30, so
    blocks of 16 and 20 straddle two points with different (l1r, l2r),
    and one block of 128 holds all three points' columns."""
    trn, _ = _data(7)
    cfg = SlimConfig(optTol=1e-12, block_size=block, shuffle=False)
    packed = C.estimate_grid_cd(_port(trn), cfg, POINTS, device="cpu")
    for (l1, l2), (model, stats) in zip(POINTS, packed):
        solo, solo_stats = C.estimate_model_cd(
            _port(trn), cfg.replace(l1r=l1, l2r=l2), device="cpu")
        np.testing.assert_allclose(model.to_dense(), solo.to_dense(),
                                   atol=5e-4, err_msg=f"point ({l1},{l2})")
        np.testing.assert_allclose(stats["loss"], solo_stats["loss"],
                                   rtol=1e-4)
        assert stats["nnz"] == model.nnz and stats["niters"] > 0
        assert stats["sweeps"] >= solo_stats["sweeps"] > 0


def test_grid_matches_jax_grid():
    """The port's packed pass against the JAX package's on the same
    points: W atol 5e-4, loss and fit rtol 1e-4, niters within 2%."""
    trn, _ = _data(11)
    kw = dict(optTol=1e-12, block_size=16, shuffle=False)
    got = C.estimate_grid_cd(_port(trn), SlimConfig(**kw), POINTS,
                             device="cpu")
    want = jax_grid(trn, JaxConfig(**kw), POINTS)
    for (mg, sg), (mj, sj) in zip(got, want):
        np.testing.assert_allclose(mg.to_dense(), mj.to_dense(), atol=5e-4)
        np.testing.assert_allclose(sg["loss"], sj["loss"], rtol=1e-4)
        np.testing.assert_allclose(sg["fit"], sj["fit"], rtol=1e-4)
        assert abs(sg["niters"] - sj["niters"]) <= 0.02 * sj["niters"]


def test_grid_seeds_each_block_by_its_first_virtual_column(monkeypatch):
    """Shuffled: block v0's visit order comes from seed + v0 (the JAX
    package's rule); every point still lands on its optimum (loss rtol
    1e-4, nnz ±1% of a one-point learn)."""
    trn, _ = _data(13)
    cfg = SlimConfig(optTol=1e-10, block_size=20, seed=5)
    seeds = []
    real = C.cd_solve_block_ids
    monkeypatch.setattr(C, "cd_solve_block_ids", lambda *a, **k: seeds.append(
        a[7].initial_seed()) or real(*a, **k))
    packed = C.estimate_grid_cd(_port(trn), cfg, POINTS, device="cpu")
    assert seeds == [5 + v0 for v0 in range(0, 3 * 30, 20)]
    for (l1, l2), (model, stats) in zip(POINTS, packed):
        _, solo = C.estimate_model_cd(_port(trn), cfg.replace(l1r=l1, l2r=l2),
                                      device="cpu")
        np.testing.assert_allclose(stats["loss"], solo["loss"], rtol=1e-4)
        assert abs(stats["nnz"] - solo["nnz"]) <= max(2, 0.01 * solo["nnz"])


def test_grid_fslim():
    """FSLIM in the packed pass: each point equals its one-point FSLIM
    learn (W atol 5e-4, loss rtol 1e-4), every column on at most nnbrs
    coordinates."""
    trn, _ = _data(17)
    cfg = SlimConfig(optTol=1e-12, block_size=16, shuffle=False, nnbrs=5,
                     simtype="cos")
    packed = C.estimate_grid_cd(_port(trn), cfg, POINTS[:2], device="cpu")
    for (l1, l2), (model, stats) in zip(POINTS, packed):
        solo, solo_stats = C.estimate_model_cd(
            _port(trn), cfg.replace(l1r=l1, l2r=l2), device="cpu")
        np.testing.assert_allclose(model.to_dense(), solo.to_dense(),
                                   atol=5e-4)
        np.testing.assert_allclose(stats["loss"], solo_stats["loss"],
                                   rtol=1e-4)
        assert (model.to_dense() > 0).sum(axis=0).max() <= 5


def test_parallel_grid_matches_sequential():
    """mselect_grid(parallel=True) against the warm-started walk
    (tests/test_mselect.py:45-54): HR atol 1e-6, nnz ±max(2, 1%), the same
    best pair; its records are grid averages."""
    trn, tst = _data(13)
    cfg = SlimConfig(optTol=1e-10, nrcmds=5, block_size=16, shuffle=False)
    seq = mselect_grid(_port(trn), _port(tst), cfg, [0.2, 1.0], [0.5],
                       device="cpu")
    par = mselect_grid(_port(trn), _port(tst), cfg, [0.2, 1.0], [0.5],
                       parallel=True, device="cpu")
    for rs, rp in zip(seq["results"], par["results"]):
        assert (rs["l1r"], rs["l2r"]) == (rp["l1r"], rp["l2r"])
        np.testing.assert_allclose(rs["hr"], rp["hr"], atol=1e-6)
        assert abs(rs["nnz"] - rp["nnz"]) <= max(2, 0.01 * rs["nnz"])
        assert rp["time_kind"] == "grid_average" and rp["sweeps"] > 0
    assert par["bestl1HR"] == seq["bestl1HR"]
    assert par["grid_time"] > 0
    assert par["results"][0]["time"] == par["grid_time"] / 2


def test_parallel_grid_matches_jax_parallel_grid():
    """Port vs JAX mselect_grid(parallel=True): per point HR ±0.015, ARHR
    ±0.010, nnz ±1%, the same best pairs."""
    trn, tst = _data(19)
    kw = dict(optTol=1e-10, nrcmds=5, block_size=16)
    got = mselect_grid(_port(trn), _port(tst), SlimConfig(**kw),
                       [0.5, 2.0], [0.5, 1.0], parallel=True, device="cpu")
    want = jax_mselect_grid(trn, tst, JaxConfig(**kw), [0.5, 2.0],
                            [0.5, 1.0], parallel=True)
    for g, w in zip(got["results"], want["results"]):
        assert (g["l1r"], g["l2r"]) == (w["l1r"], w["l2r"])
        assert abs(g["hr"] - w["hr"]) <= 0.015
        assert abs(g["arhr"] - w["arhr"]) <= 0.010
        assert abs(g["nnz"] - w["nnz"]) <= max(2, 0.01 * w["nnz"])
    for key in ("bestl1HR", "bestl2HR"):
        assert got[key] == want[key]
