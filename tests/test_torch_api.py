"""The ``SLIM`` / ``SLIMatrix`` classes and ``profile_dir`` of the PyTorch
port against the JAX package's (slim_tpu/api.py:111-395) on JAX-CPU."""

import glob
import json

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.api import SLIM as JaxSLIM, SLIMatrix as JaxSLIMatrix
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu_torch import SLIM, SLIMatrix, SlimConfig, get_topn, learn
from slim_tpu_torch.checks import ranked_mismatches


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triplets(seed, nusers=80, nitems=40, nnz=700):
    """(user label, item label, rating) rows with sparse, unordered labels
    and repeated events (their ratings add)."""
    rng = np.random.default_rng(seed)
    ulab = rng.permutation(1000)[:nusers] + 5000
    ilab = rng.permutation(1000)[:nitems] * 3 + 7
    return np.stack([ulab[rng.integers(0, nusers, nnz)],
                     ilab[(rng.zipf(1.3, nnz) - 1) % nitems],
                     rng.integers(1, 6, nnz)], axis=1).astype(np.float64)


def _same_matrix(mine, theirs):
    assert (mine.nUsers, mine.nItems) == (theirs.nUsers, theirs.nItems)
    np.testing.assert_array_equal(mine.id2item, theirs.id2item)
    np.testing.assert_array_equal(mine.id2user, theirs.id2user)
    assert mine.item2id == dict(theirs.item2id)
    assert mine.user2id == dict(theirs.user2id)
    np.testing.assert_array_equal(mine.mat.to_dense(), theirs.mat.to_dense())


@pytest.mark.parametrize("as_list", [False, True])
def test_slimatrix_from_triplets_matches_jax(as_list):
    """Labels numbered in order of first appearance, repeated events
    summed: the same maps and matrix as the JAX SLIMatrix."""
    data = _triplets(1)
    mine = SLIMatrix(data.tolist() if as_list else data)
    _same_matrix(mine, JaxSLIMatrix(data))
    small = SLIMatrix([[10, 100, 5.0], [10, 101, 3.0], [20, 100, 2.0],
                       [30, 102, 4.0]])
    assert (small.nUsers, small.nItems, small.mat.nnz) == (3, 3, 4)
    assert small.user2id[10] == 0 and small.item2id[102] == 2


def test_slimatrix_from_scipy_keeps_identity_maps():
    mat = random_csr(np.random.default_rng(2), 30, 12, density=0.3)
    mine = SLIMatrix(mat.to_scipy())
    _same_matrix(mine, JaxSLIMatrix(mat.to_scipy()))
    with pytest.raises(TypeError, match="size"):
        SLIMatrix(mat.to_scipy()[:, :10], oldmat=mine)
    with pytest.raises(TypeError, match="not supported"):
        SLIMatrix("ratings.csv")


def test_oldmat_alignment_matches_jax():
    """oldmat = a SLIMatrix keeps both maps and drops events outside them;
    oldmat = a trained SLIM keeps its item map and numbers the users
    anew; both as the JAX package does."""
    base = _triplets(3)
    new = _triplets(4)
    mine = SLIMatrix(new, oldmat=SLIMatrix(base))
    _same_matrix(mine, JaxSLIMatrix(new, oldmat=JaxSLIMatrix(base)))
    assert mine.mat.nnz < len(new)
    tiny = SLIMatrix([[1, 7, 2.0], [3, 9, 1.0]],
                     oldmat=SLIMatrix([[1, 7, 1.0], [2, 8, 1.0]]))
    assert tiny.mat.nnz == 1
    model = SLIM()
    model.train(SlimConfig(maxniters=50), SLIMatrix(base), device="cpu")
    jmodel = JaxSLIM()
    jmodel.train(JaxConfig(maxniters=50), JaxSLIMatrix(base))
    _same_matrix(SLIMatrix(new, oldmat=model),
                 JaxSLIMatrix(new, oldmat=jmodel))


def _ranked(out, scores, users):
    return (np.stack([out[u] for u in users]),
            np.stack([scores[u] for u in users]))


def test_train_predict_matches_jax():
    """SLIM.train + predict against the JAX classes on the same triplets
    (in-order sweeps): loss rtol 1e-4, nnz ±1%, each user's item labels
    equal but at the near ties ``checks.ranked_mismatches`` forgives,
    scores rtol 1e-5."""
    data = _triplets(5)
    cfg = dict(l1r=0.5, l2r=0.5, optTol=1e-9, shuffle=False)
    model = SLIM()
    model.train(SlimConfig(**cfg), SLIMatrix(data), device="cpu")
    jmodel = JaxSLIM()
    jmodel.train(JaxConfig(**cfg), JaxSLIMatrix(data))
    np.testing.assert_allclose(model.stats["loss"], jmodel.stats["loss"],
                               rtol=1e-4)
    assert abs(model.model.nnz - jmodel.model.nnz) <= 0.01 * jmodel.model.nnz
    out, sc = model.predict(SLIMatrix(data), nrcmds=5, returnscores=True,
                            device="cpu")
    jout, jsc = jmodel.predict(JaxSLIMatrix(data), nrcmds=5,
                               returnscores=True)
    users = list(jout)
    assert list(out) == users
    ids, s = _ranked(out, sc, users)
    jids, js = _ranked(jout, jsc, users)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    assert ranked_mismatches(ids, s, jids, js)[1] == 0


def test_predict_equals_the_functional_path_and_survives_save_load(
        tmp_path):
    """The class's predict is api.learn + get_topn on the class's matrix,
    label for label; save_model / load_model round-trips the model and the
    predictions; to_csr exports it with its item labels."""
    data = _triplets(6)
    trn = SLIMatrix(data)
    cfg = SlimConfig(l1r=0.5, l2r=0.5)
    model = SLIM()
    model.train(cfg, trn, device="cpu")
    m, _ = learn(trn.mat, cfg, device="cpu")
    ids, _, _ = get_topn(m, trn.mat, nrcmds=5, device="cpu")
    out = model.predict(trn, nrcmds=5, device="cpu")
    want = np.where(ids >= 0, trn.id2item[np.maximum(ids, 0)], -1)
    for u, row in trn.user2id.items():
        np.testing.assert_array_equal(out[u], want[row])
    mfile, mapfile = str(tmp_path / "m.csr"), str(tmp_path / "m.map")
    model.save_model(mfile, mapfile)
    loaded = SLIM()
    loaded.load_model(mfile, mapfile)
    np.testing.assert_allclose(loaded.model.to_dense(), model.model.to_dense(),
                               rtol=1e-5, atol=1e-6)     # the text format
    np.testing.assert_array_equal(loaded.id2item, model.id2item)
    again = loaded.predict(trn, nrcmds=5, device="cpu")
    for u in out:
        np.testing.assert_array_equal(again[u], out[u])
    csr, labels = model.to_csr(returnmap=True)
    assert csr.shape == (trn.nItems, trn.nItems)
    np.testing.assert_array_equal(labels, trn.id2item)


def test_predict_1vsk_matches_jax(tmp_path):
    """predict with negitems (1-vs-k over each user's candidate labels,
    an unknown label scoring 0) against the JAX class on one model, and
    its outfile."""
    data = _triplets(7)
    trn = SLIMatrix(data)
    model = SLIM()
    model.train(SlimConfig(l1r=0.5, l2r=0.5), trn, device="cpu")
    jmodel = JaxSLIM()
    jmodel.model, jmodel.nItems = model.model, model.nItems
    jmodel.id2item, jmodel.item2id = model.id2item, model.item2id
    rng = np.random.default_rng(8)
    neg = {u: list(rng.choice(trn.id2item, 12, replace=False)) + [-99]
           for u in list(trn.user2id)[:30]}
    out, sc = model.predict(trn, nrcmds=5, negitems=neg, nnegs=13,
                            returnscores=True, device="cpu",
                            outfile=str(tmp_path / "recs.txt"))
    jout, jsc = jmodel.predict(JaxSLIMatrix(data), nrcmds=5, negitems=neg,
                               nnegs=13, returnscores=True)
    for u in neg:
        np.testing.assert_array_equal(out[u], jout[u])
        np.testing.assert_allclose(sc[u], jsc[u], rtol=1e-5, atol=1e-6)
        assert set(out[u]) <= set(neg[u])
    assert len(open(tmp_path / "recs.txt").read().splitlines()) == \
        2 * trn.nUsers
    with pytest.raises(AssertionError, match="larger"):
        model.predict(trn, nrcmds=5, negitems=neg, nnegs=4, device="cpu")


@pytest.mark.parametrize("parallel", [False, True])
def test_mselect_matches_jax(parallel):
    """SLIM.mselect (sorted grid, walked or packed) against the JAX class:
    per point HR ±0.015 and ARHR ±0.010, the same best pair, and the kept
    model is the best-HR point's.  ``niters`` 1000: the dict API's default
    cap of 50 sweeps leaves the cold packed solves short of the optimum,
    where the two visit orders part; 164 test users, so one hit (0.006) is
    inside the HR tolerance."""
    trn = random_csr(np.random.default_rng(33), 200, 30, density=0.2)
    tst = random_csr(np.random.default_rng(34), 200, 30, density=0.05)
    model = SLIM()
    params = {"optTol": 1e-7, "niters": 1000}
    res = model.mselect(params, SLIMatrix(trn.to_scipy()),
                        SLIMatrix(tst.to_scipy()), [1.0, 0.1], [0.5],
                        nrcmds=5, parallel=parallel, device="cpu")
    want = JaxSLIM().mselect(params, JaxSLIMatrix(trn.to_scipy()),
                             JaxSLIMatrix(tst.to_scipy()), [1.0, 0.1], [0.5],
                             nrcmds=5, parallel=parallel)
    assert [r["l1r"] for r in res["results"]] == [0.1, 1.0]
    for g, w in zip(res["results"], want["results"]):
        assert abs(g["hr"] - w["hr"]) <= 0.015
        assert abs(g["arhr"] - w["arhr"]) <= 0.010
    assert (res["bestl1HR"], res["bestl2HR"]) == (want["bestl1HR"],
                                                  want["bestl2HR"])
    assert model.model is res["best_model_hr"] and model.nItems == 30


def test_profile_dir_writes_a_trace(tmp_path):
    """learn with cfg.profile_dir runs under torch.profiler and exports a
    Chrome trace there whose events include the solve's operators and the
    solver's phase spans."""
    mat = random_csr(np.random.default_rng(9), 40, 20, density=0.3)
    from slim_tpu_torch.types import CSR

    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                        mat.data)
    _, stats = learn(m, SlimConfig(profile_dir=str(tmp_path / "prof")),
                     device="cpu")
    traces = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(traces) == 1 and stats["loss"] > 0
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    names = {e.get("name") for e in events}
    assert {"slim.cd.solve", "slim.cd.assembly"} <= names


def test_package_exports_every_name_of_the_jax_package():
    """Every name in ``slim_tpu.__all__`` imports from ``slim_tpu_torch``
    (``mselect_grid`` and ``mselect_pairs`` among them)."""
    import slim_tpu
    import slim_tpu_torch

    missing = [n for n in slim_tpu.__all__ if not hasattr(slim_tpu_torch, n)]
    assert missing == []
    assert set(slim_tpu.__all__) <= set(slim_tpu_torch.__all__)
    from slim_tpu_torch import (mselect_grid, mselect_pairs,  # noqa: F401
                                setup_training_matrix)


@pytest.mark.parametrize("ncols", [5, 10])
def test_setup_training_matrix_matches_jax(ncols):
    """Entries in columns 0-6 of a 10-column space whose last columns are
    empty: declared 10 wide it stays 10 (the empty columns are kept),
    declared 5 wide it widens to 7, as the JAX package's setup does."""
    from slim_tpu.api import setup_training_matrix as jax_setup
    from slim_tpu.types import CSR as JaxCSR
    from slim_tpu_torch import setup_training_matrix
    from slim_tpu_torch.types import CSR

    rows = np.array([0, 0, 1, 2, 3])
    cols = np.array([0, 6, 2, 6, 1])
    vals = np.arange(1, 6, dtype=np.float32)
    mine = CSR.from_ijv(rows, cols, vals, nrows=4, ncols=10).with_ncols(ncols)
    theirs = JaxCSR.from_ijv(rows, cols, vals, nrows=4,
                             ncols=10).with_ncols(ncols)
    got, want = setup_training_matrix(mine), jax_setup(theirs)
    assert got.ncols == want.ncols == max(ncols, 7)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def test_dev_put_keys_one_device_once():
    """A device-upload cache entry is built once whatever the device's
    spelling (the CPU has one; the card's "cuda" and "cuda:0" are held to
    this in tests/test_torch_cuda.py)."""
    from slim_tpu_torch.types import CSR

    m = CSR.from_ijv(np.array([0, 1]), np.array([1, 0]),
                     np.ones(2, np.float32), nrows=2, ncols=2)
    built = []

    def build():
        built.append(1)
        return m.indices.astype(np.int32)

    a = m.dev_put("idx32", build, "cpu")
    b = m.dev_put("idx32", build, torch.device("cpu"))
    assert a is b and len(built) == 1
    assert [k for k in m._dev if k[1] == "idx32"] == [("cpu", "idx32")]
