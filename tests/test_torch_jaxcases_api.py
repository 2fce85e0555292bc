"""The JAX package's own cases of its class API, quality goldens and model
selection (tests/test_api.py, tests/test_goldens.py, tests/test_mselect.py)
run on the port, on the CPU (``device="cpu"`` on every call that runs a
learn or a predict).

Each case builds its input as the JAX test does and asserts what it
asserts, with its tolerances.  Where the JAX test compares a result with a
number (a golden, a point's HR), the port's result is also held to
``slim_tpu``'s on JAX-CPU on the same input, at the goldens' tolerances.
Cases left out: the Automotive and ml100k cases need the reference's data
files, which the repo does not carry; the resident sparse model of
``SLIM.predict`` is the JAX package's padded tuple (the port's sparse routes
upload the model's rows once through the CSR's cache and keep no tuple);
the mesh model selection runs a mesh of 8 devices in one process, where
the port runs one process per device (tests/test_torch_dist.py)."""

import os

import numpy as np
import pytest
import torch

import slim_tpu.api as japi
import slim_tpu.eval as jeval
import slim_tpu.predict as jpredict
from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.io.readers import read_matrix as jread
from slim_tpu.mselect import mselect_grid as jax_grid
from slim_tpu.mselect import mselect_pairs as jax_pairs
from slim_tpu.solvers.cd import estimate_grid_cd as jax_grid_cd
from slim_tpu_torch import native
from slim_tpu_torch.api import SLIM, SLIMatrix, learn
from slim_tpu_torch.config import SlimConfig
from slim_tpu_torch.eval import determine_head_tail, evaluate_topn
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.mselect import mselect_grid, mselect_pairs
from slim_tpu_torch.predict import predict_topn
from slim_tpu_torch.solvers.cd import estimate_grid_cd, estimate_model_cd
from slim_tpu_torch.types import CSR

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# tests/test_goldens.py's vendored synth goldens (l1r = l2r = 1)
SYNTH_LOSS, SYNTH_NNZ, SYNTH_HR, SYNTH_ARHR = 4730.0005, 10613, 0.230833, \
    0.135996


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    """The port's CSR of a JAX CSR's arrays."""
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


# --------------------------------------------------------------------- #
# tests/test_api.py
# --------------------------------------------------------------------- #
def test_from_dict_niters_default_is_50():
    assert SlimConfig.from_dict({}).maxniters == 50
    assert SlimConfig.from_dict({"niters": 7}).maxniters == 7
    assert SlimConfig.from_dict({"maxniters": 123}).maxniters == 123
    assert SlimConfig().maxniters == 10000


def test_slimatrix_triplets():
    data = [[10, 100, 5.0], [10, 101, 3.0], [20, 100, 2.0], [30, 102, 4.0]]
    m = SLIMatrix(data)
    assert m.nUsers == 3 and m.nItems == 3
    assert m.mat.nnz == 4
    assert m.user2id[10] == 0 and m.item2id[102] == 2


def test_slimatrix_align_to_oldmat():
    base = SLIMatrix([[1, 7, 1.0], [2, 8, 1.0]])
    aligned = SLIMatrix([[1, 7, 2.0], [3, 9, 1.0]], oldmat=base)
    assert aligned.mat.nnz == 1


def test_train_predict_roundtrip(tmp_path, rng):
    mat = random_csr(rng, 50, 20, density=0.3, seed=21)
    trn = SLIMatrix(mat.to_scipy())
    model = SLIM()
    model.train({"l1r": 0.5, "l2r": 0.5}, trn, device="cpu")
    out = model.predict(trn, nrcmds=5, device="cpu")
    assert len(out) == 50
    assert all(len(v) == 5 for v in out.values())

    mfile, mapfile = str(tmp_path / "m.csr"), str(tmp_path / "m.map")
    model.save_model(mfile, mapfile)
    m2 = SLIM()
    m2.load_model(mfile, mapfile)
    out2 = m2.predict(trn, nrcmds=5, device="cpu")
    for k in out:
        np.testing.assert_array_equal(out[k], out2[k])

    csr, imap = model.to_csr(returnmap=True)
    assert csr.shape == (20, 20)
    assert len(imap) == 20

    ref = japi.SLIM()
    ref.train({"l1r": 0.5, "l2r": 0.5}, japi.SLIMatrix(mat.to_scipy()))
    np.testing.assert_allclose(model.stats["loss"], ref.stats["loss"],
                               rtol=1e-4)
    assert abs(model.model.nnz - ref.model.nnz) <= \
        max(2, 0.01 * ref.model.nnz)


def test_mselect_api(rng):
    mat = random_csr(rng, 60, 25, density=0.25, seed=33)
    tst = random_csr(rng, 60, 25, density=0.05, seed=34)
    trn = SLIMatrix(mat.to_scipy())
    tstm = SLIMatrix(tst.to_scipy())
    model = SLIM()
    res = model.mselect({"optTol": 1e-7}, trn, tstm, [0.1, 1.0], [0.5],
                        nrcmds=5, device="cpu")
    assert len(res["results"]) == 2
    assert res["best_model_hr"] is not None
    assert model.model is not None


# --------------------------------------------------------------------- #
# tests/test_goldens.py: the vendored cases
# --------------------------------------------------------------------- #
def _eval(model, trn, tst):
    ids, _, counts = predict_topn(model, trn, nrcmds=10, device="cpu")
    n = max(trn.ncols, tst.ncols, model.ncols)
    return evaluate_topn(ids, counts, tst, determine_head_tail(trn, n))


def test_vendored_synth_learn_quality_golden():
    trn = read_matrix(os.path.join(DATA_DIR, "synth-train.ijv"),
                      fmt="ijv").infer_ncols()
    tst = read_matrix(os.path.join(DATA_DIR, "synth-test.ijv"),
                      fmt="ijv").infer_ncols()
    model, stats = learn(trn, SlimConfig(l1r=1.0, l2r=1.0), device="cpu")
    np.testing.assert_allclose(stats["loss"], SYNTH_LOSS, rtol=1e-4)
    assert abs(stats["nnz"] - SYNTH_NNZ) <= SYNTH_NNZ * 0.01
    res = _eval(model, trn, tst)
    assert abs(res.hr - SYNTH_HR) < 0.015
    assert abs(res.arhr - SYNTH_ARHR) < 0.010

    jtrn = jread(os.path.join(DATA_DIR, "synth-train.ijv"),
                 fmt="ijv").infer_ncols()
    jtst = jread(os.path.join(DATA_DIR, "synth-test.ijv"),
                 fmt="ijv").infer_ncols()
    jmodel, jstats = japi.learn(jtrn, JaxConfig(l1r=1.0, l2r=1.0))
    np.testing.assert_allclose(stats["loss"], jstats["loss"], rtol=1e-4)
    assert abs(stats["nnz"] - jstats["nnz"]) <= jstats["nnz"] * 0.01
    ids, _, counts = jpredict.predict_topn(jmodel, jtrn, nrcmds=10)
    n = max(jtrn.ncols, jtst.ncols, jmodel.ncols)
    jres = jeval.evaluate_topn(ids, counts, jtst,
                               jeval.determine_head_tail(jtrn, n))
    assert abs(res.hr - jres.hr) < 0.015
    assert abs(res.arhr - jres.arhr) < 0.010


def test_vendored_synth_native_oracle_agrees():
    if not native.available():
        pytest.skip("no C++ compiler for the native runtime")
    trn = read_matrix(os.path.join(DATA_DIR, "synth-train.ijv"),
                      fmt="ijv").infer_ncols()
    model, err, obj = native.cd_learn(trn, l1r=1.0, l2r=1.0, optTol=1e-7,
                                      maxniters=10000, nthreads=0)
    np.testing.assert_allclose(obj, SYNTH_LOSS, rtol=1e-4)


def test_vendored_csr_format_matches_ijv():
    a = read_matrix(os.path.join(DATA_DIR, "synth-train.ijv"),
                    fmt="ijv").infer_ncols()
    b = read_matrix(os.path.join(DATA_DIR, "synth-train.csr"),
                    fmt="csr").infer_ncols()
    assert a.nnz == b.nnz and a.nrows == b.nrows
    np.testing.assert_array_equal(a.indices, b.indices)


# --------------------------------------------------------------------- #
# tests/test_mselect.py
# --------------------------------------------------------------------- #
def _data(seed=101):
    rng = np.random.default_rng(seed)
    trn = random_csr(rng, 60, 30, density=0.25, seed=seed)
    tst = random_csr(rng, 60, 30, density=0.05, seed=seed + 1)
    return trn, tst


def test_mselect_pairs_tracks_best():
    jtrn, jtst = _data()
    cfg = SlimConfig(optTol=1e-8, nrcmds=5)
    pairs = [(0.1, 0.5), (5.0, 0.5)]
    res = mselect_pairs(_port(jtrn), _port(jtst), cfg, pairs, device="cpu")
    assert len(res["results"]) == 2
    assert res["results"][1]["nnz"] < res["results"][0]["nnz"]
    hrs = [r["hr"] for r in res["results"]]
    assert res["bestHRHR"] == max(hrs)
    ref = jax_pairs(jtrn, jtst, JaxConfig(**vars(cfg)), pairs)
    for r, j in zip(res["results"], ref["results"]):
        assert abs(r["nnz"] - j["nnz"]) <= max(2, 0.01 * j["nnz"])
        assert abs(r["hr"] - j["hr"]) < 0.015


def test_grid_cd_matches_individual_solves():
    jtrn, _ = _data(7)
    trn = _port(jtrn)
    cfg = SlimConfig(optTol=1e-12, block_size=16, shuffle=False)
    points = [(0.2, 0.5), (1.0, 2.0), (3.0, 0.1)]
    packed = estimate_grid_cd(trn, cfg, points, device="cpu")
    for (l1, l2), (model, stats) in zip(points, packed):
        solo, solo_stats = estimate_model_cd(
            trn, cfg.replace(l1r=l1, l2r=l2), device="cpu")
        np.testing.assert_allclose(model.to_scipy().toarray(),
                                   solo.to_scipy().toarray(), atol=5e-4,
                                   err_msg=f"point ({l1},{l2})")
        np.testing.assert_allclose(stats["loss"], solo_stats["loss"],
                                   rtol=1e-4)
    ref = jax_grid_cd(jtrn, JaxConfig(**vars(cfg)), points)
    for (_, stats), (_, j) in zip(packed, ref):
        np.testing.assert_allclose(stats["loss"], j["loss"], rtol=1e-4)
        assert abs(stats["nnz"] - j["nnz"]) <= max(2, 0.01 * j["nnz"])


def test_parallel_grid_matches_sequential():
    jtrn, jtst = _data(13)
    trn, tst = _port(jtrn), _port(jtst)
    cfg = SlimConfig(optTol=1e-10, nrcmds=5, block_size=16, shuffle=False)
    seq = mselect_grid(trn, tst, cfg, [0.2, 1.0], [0.5], parallel=False,
                       device="cpu")
    par = mselect_grid(trn, tst, cfg, [0.2, 1.0], [0.5], parallel=True,
                       device="cpu")
    for rs, rp in zip(seq["results"], par["results"]):
        assert rs["l1r"] == rp["l1r"] and rs["l2r"] == rp["l2r"]
        np.testing.assert_allclose(rs["hr"], rp["hr"], atol=1e-6)
        assert abs(rs["nnz"] - rp["nnz"]) <= max(2, 0.01 * rs["nnz"])
    assert par["bestl1HR"] == seq["bestl1HR"]
    ref = jax_grid(jtrn, jtst, JaxConfig(**vars(cfg)), [0.2, 1.0], [0.5],
                   parallel=True)
    for rp, j in zip(par["results"], ref["results"]):
        assert abs(rp["nnz"] - j["nnz"]) <= max(2, 0.01 * j["nnz"])
        assert abs(rp["hr"] - j["hr"]) < 0.015
