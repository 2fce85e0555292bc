"""The JAX package's own prediction cases (tests/test_predict.py) run on the
port, on the CPU (``device="cpu"`` on every call).

Each case builds its model and histories as the JAX test does and asserts
what it asserts, with its tolerances.  The port accepts ``scan=`` and
ignores it (it has one orchestration per route), so a case that holds the
scan path to the per-block path holds the port's route to itself and to
the case's oracle.  Where the JAX test compares scores with numbers, the
port's lists are also held to ``slim_tpu``'s ``predict_topn`` on JAX-CPU
on the same inputs (counts equal, scores rtol 1e-5).  Cases left out test
the JAX package's TPU internals, which the port does not carry: the
f32-bitcast top-N transport (``_pack_topn``, two cases), the two-stage wide
top-k (``_topk_wide``), the Pallas-densified scans and slab densify in
interpret mode (``_predict_topn_scan_pallas`` twice,
``DeviceModelPack._densify_pallas``, ``_slab_densifyT``)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import slim_tpu.predict as jpredict
from conftest import random_csr
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch.predict import (predict_candidate_scores, predict_topn,
                                    predict_topn_1vsk, sparsify_model_device)
from slim_tpu_torch.types import CSR

from test_predict import reference_scores

CPU = dict(device="cpu")


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


def _as_jax(got, jmodel, jhist, nrcmds, **kw):
    """The port's (ids, scores, counts) against the JAX package's top-N of
    the same model and histories: counts equal, each user's scores rtol
    1e-5 in rank order, and each user's ids equal but at equal scores."""
    ids, sc, cnt = got
    jids, jsc, jcnt = jpredict.predict_topn(jmodel, jhist, nrcmds=nrcmds,
                                            **kw)
    np.testing.assert_array_equal(cnt, jcnt)
    for u in range(len(cnt)):
        k = int(cnt[u])
        np.testing.assert_allclose(sc[u, :k], jsc[u, :k], rtol=1e-5,
                                   atol=1e-6)
        untied = np.r_[np.diff(jsc[u, :k]) != 0, True] & \
            np.r_[True, np.diff(jsc[u, :k]) != 0]
        np.testing.assert_array_equal(ids[u, :k][untied], jids[u, :k][untied])


def _model_of(W):
    rows, cols = np.nonzero(W)
    return JCSR.from_ijv(rows, cols, W[rows, cols], nrows=W.shape[0],
                         ncols=W.shape[1])


def test_predict_matches_reference_scoring(rng):
    n = 12
    W = (rng.random((n, n)) < 0.3) * rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    jmodel = _model_of(W)
    jhist = random_csr(rng, 6, n, density=0.3)
    ids, scores, counts = got = predict_topn(_port(jmodel), _port(jhist),
                                             nrcmds=5, **CPU)
    hist = jhist
    for u in range(6):
        hidx = hist.indices[hist.indptr[u]:hist.indptr[u + 1]]
        hval = hist.values()[hist.indptr[u]:hist.indptr[u + 1]]
        ref = reference_scores(W, hidx, hval)
        ref[hidx] = -np.inf
        expect_k = min(int(np.sum(ref > 0)), 5)
        assert counts[u] == expect_k
        order = np.argsort(-ref)
        for r in range(expect_k):
            np.testing.assert_allclose(scores[u, r], ref[order[r]], rtol=1e-5)
        assert np.all(ids[u, expect_k:] == -1)
    _as_jax(got, jmodel, jhist, 5)


def test_predict_excludes_history(rng):
    n = 8
    W = np.ones((n, n), dtype=np.float32)
    np.fill_diagonal(W, 0)
    model = _port(_model_of(W))
    hist = CSR.from_ijv([0, 0, 0], [1, 2, 3], [1.0, 1.0, 1.0], nrows=1,
                        ncols=n)
    ids, scores, counts = predict_topn(model, hist, nrcmds=n, **CPU)
    got = set(ids[0, :counts[0]].tolist())
    assert got.isdisjoint({1, 2, 3})


def test_predict_implicit_history(rng):
    n = 10
    W = rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    model = _port(_model_of(W))
    hist_e = random_csr(rng, 4, n, density=0.4)
    ones = CSR.from_arrays(4, n, hist_e.indptr, hist_e.indices,
                           np.ones(hist_e.nnz, np.float32))
    imp = _port(hist_e.binarize())
    _, sc_a, _ = predict_topn(model, ones, nrcmds=4, **CPU)
    _, sc_b, _ = predict_topn(model, imp, nrcmds=4, **CPU)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-6)


def test_predict_1vsk(rng):
    n = 15
    W = (rng.random((n, n)) < 0.5) * rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    jmodel = _model_of(W)
    hist = random_csr(rng, 3, n, density=0.4)
    neg = np.array([[1, 5, 9, 13], [0, 2, 4, 6], [3, 7, 11, 14]],
                   dtype=np.int32)
    ids, scores, counts = predict_topn_1vsk(_port(jmodel), _port(hist), neg,
                                            nrcmds=3, **CPU)
    for u in range(3):
        hidx = hist.indices[hist.indptr[u]:hist.indptr[u + 1]]
        hval = hist.values()[hist.indptr[u]:hist.indptr[u + 1]]
        full = reference_scores(W, hidx, hval)
        cand_scores = {int(c): full[c] for c in neg[u]}
        best = sorted(cand_scores.items(), key=lambda kv: -kv[1])[:3]
        got = [(int(i), float(s)) for i, s in zip(ids[u], scores[u])]
        assert all(int(i) in set(neg[u].tolist()) for i, _ in got)
        np.testing.assert_allclose(sorted([s for _, s in got], reverse=True),
                                   [s for _, s in best], rtol=1e-5)
    jids, jsc, jcnt = jpredict.predict_topn_1vsk(jmodel, hist, neg, nrcmds=3)
    np.testing.assert_array_equal(counts, jcnt)
    np.testing.assert_allclose(scores, jsc, rtol=1e-5)


def test_predict_1vsk_history_not_excluded(rng):
    n = 6
    W = np.ones((n, n), dtype=np.float32)
    np.fill_diagonal(W, 0)
    model = _port(_model_of(W))
    hist = CSR.from_ijv([0, 0], [1, 2], [1.0, 1.0], nrows=1, ncols=n)
    neg = np.array([[1, 4]], dtype=np.int32)
    ids, scores, _ = predict_topn_1vsk(model, hist, neg, nrcmds=2, **CPU)
    got = dict(zip(ids[0].tolist(), scores[0].tolist()))
    assert 1 in got
    np.testing.assert_allclose(got[1], 1.0)
    np.testing.assert_allclose(got[4], 2.0)


def test_predict_sparse_path_matches_dense(rng):
    jmodel = random_csr(rng, 64, 64, density=0.15, seed=200)
    jhist = random_csr(rng, 37, 64, density=0.2, seed=201)
    model, hist = _port(jmodel), _port(jhist)
    di, dsc, dc = predict_topn(model, hist, nrcmds=7, sparse=False, **CPU)
    si, ssc, sc = predict_topn(model, hist, nrcmds=7, sparse=True,
                               user_block=8, **CPU)
    np.testing.assert_array_equal(dc, sc)
    for u in range(hist.nrows):
        k = dc[u]
        assert set(di[u][:k]) == set(si[u][:k]), u
        np.testing.assert_allclose(np.sort(dsc[u][:k]), np.sort(ssc[u][:k]),
                                   rtol=1e-5, atol=1e-6)
    _as_jax((di, dsc, dc), jmodel, jhist, 7, sparse=False)


def test_predict_sparse_implicit_history(rng):
    model = _port(random_csr(rng, 40, 40, density=0.2, seed=210))
    hist = _port(random_csr(rng, 20, 40, density=0.25, implicit=True,
                            seed=211))
    di, _, dc = predict_topn(model, hist, nrcmds=5, sparse=False, **CPU)
    si, _, sc = predict_topn(model, hist, nrcmds=5, sparse=True, **CPU)
    np.testing.assert_array_equal(dc, sc)
    for u in range(hist.nrows):
        assert set(di[u][:dc[u]]) == set(si[u][:sc[u]])


def test_predict_1vsk_sparse_matches_dense(rng):
    model = _port(random_csr(rng, 50, 50, density=0.2, seed=220))
    hist = _port(random_csr(rng, 25, 50, density=0.2, seed=221))
    neg = rng.integers(0, 50, size=(25, 12)).astype(np.int32)
    di, dsc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=6, sparse=False,
                                   **CPU)
    si, ssc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=6, sparse=True,
                                   user_block=8, **CPU)
    np.testing.assert_allclose(np.sort(dsc, axis=1), np.sort(ssc, axis=1),
                               rtol=1e-5, atol=1e-6)
    for u in range(25):
        assert set(di[u]) == set(si[u]), u


def test_predict_scan_matches_block(rng):
    jmodel = random_csr(rng, 60, 60, density=0.2, seed=230)
    model = _port(jmodel)
    for implicit, seed in ((False, 231), (True, 232)):
        jhist = random_csr(rng, 53, 60, density=0.2, implicit=implicit,
                           seed=seed)
        hist = _port(jhist)
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=False,
                                   scan=False, **CPU)
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, sparse=False,
                                   scan=True, user_block=16, **CPU)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), u
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)
        _as_jax((si, ssc, sc), jmodel, jhist, 7, sparse=False, scan=True,
                user_block=16)


def _200k():
    """tests/test_predict.py's 200k-item workload: ~12 model entries per
    item row, 20-entry histories of 64 users."""
    n, nusers = 200_000, 64
    rng = np.random.default_rng(400)
    nnz_m = 12 * n
    mr = rng.integers(0, n, nnz_m)
    mc = rng.integers(0, n, nnz_m)
    mv = rng.random(nnz_m, dtype=np.float32) + 0.01
    model = CSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), 20)
    hc = rng.integers(0, n, hr.size)
    hist = CSR.from_ijv(hr, hc, np.ones(hr.size, np.float32), nrows=nusers,
                        ncols=n)
    return model, hist


def _oracle_check(model, hist, scores, counts, nrcmds=10, rtol=1e-4):
    n, nusers = model.ncols, hist.nrows
    W = sp.csr_matrix((model.values(), model.indices, model.indptr),
                      shape=(n, n))
    H = sp.csr_matrix((hist.values(), hist.indices, hist.indptr),
                      shape=(nusers, n))
    S = np.asarray((H @ W).todense())
    for u in range(nusers):
        s = S[u].copy()
        s[hist.indices[hist.indptr[u]:hist.indptr[u + 1]]] = -np.inf
        k = int(counts[u])
        assert k == min(nrcmds, int((s > 0).sum())), u
        np.testing.assert_allclose(np.sort(scores[u][:k])[::-1],
                                   np.sort(s)[::-1][:k], rtol=rtol,
                                   atol=rtol)


def test_predict_sparse_200k_item_catalogue():
    model, hist = _200k()
    ids, scores, counts = predict_topn(model, hist, nrcmds=10, sparse=True,
                                       user_block=16, **CPU)
    si, ssc, sc = predict_topn(model, hist, nrcmds=10, sparse=True,
                               user_block=16, scan=True, **CPU)
    np.testing.assert_array_equal(counts, sc)
    for u in range(hist.nrows):
        k = int(counts[u])
        assert set(ids[u][:k]) == set(si[u][:k]), u
        np.testing.assert_allclose(np.sort(scores[u][:k]),
                                   np.sort(ssc[u][:k]), rtol=1e-5, atol=1e-6)
    _oracle_check(model, hist, scores, counts)


def test_predict_sparse_scan_matches_block(rng):
    model = _port(random_csr(rng, 60, 60, density=0.2, seed=240))
    Wsp = sparsify_model_device(model, **CPU)
    for implicit, seed in ((False, 241), (True, 242)):
        hist = _port(random_csr(rng, 53, 60, density=0.2, implicit=implicit,
                                seed=seed))
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=True,
                                   scan=False, **CPU)
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                   scan=True, user_block=16, **CPU)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), u
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)


def test_predict_power_user_skewed_history(rng):
    n, nusers = 300, 40
    model = _port(random_csr(rng, n, n, density=0.05, seed=260))
    hr = [0] * (n - 10) + list(np.repeat(np.arange(1, nusers), 5))
    hc = list(range(n - 10)) + list(rng.integers(0, n, 5 * (nusers - 1)))
    hist = CSR.from_ijv(np.asarray(hr), np.asarray(hc),
                        np.ones(len(hr), np.float32), nusers, n).binarize()
    for kw in (dict(sparse=False, scan=False), dict(sparse=False, scan=True),
               dict(sparse=True, scan=False), dict(sparse=True, scan=True)):
        _, scores, counts = predict_topn(model, hist, nrcmds=10,
                                         user_block=16, **kw, **CPU)
        _oracle_check(model, hist, scores, counts, rtol=1e-5)


def test_predict_coo_scan_matches_block(rng, monkeypatch):
    model = _port(random_csr(rng, 70, 70, density=0.15, seed=270))
    Wsp = sparsify_model_device(model, **CPU)
    for implicit, seed in ((False, 271), (True, 272)):
        hist = _port(random_csr(rng, 45, 70, density=0.15, implicit=implicit,
                                seed=seed))
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "0")
        bi, bsc, bc = predict_topn(model, hist, nrcmds=7, sparse=True,
                                   scan=False, **CPU)
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
        si, ssc, sc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                   scan=True, user_block=16, **CPU)
        ci, _, cc = predict_topn(model, hist, nrcmds=7, W_dev=Wsp,
                                 scan=False, user_block=16, **CPU)
        np.testing.assert_array_equal(bc, cc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(ci[u][:k]), (implicit, u)
        np.testing.assert_array_equal(bc, sc)
        for u in range(hist.nrows):
            k = bc[u]
            assert set(bi[u][:k]) == set(si[u][:k]), (implicit, u)
            np.testing.assert_allclose(np.sort(bsc[u][:k]),
                                       np.sort(ssc[u][:k]),
                                       rtol=1e-5, atol=1e-6)


def test_predict_coo_scan_200k_oracle(monkeypatch):
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
    model, hist = _200k()
    _, scores, counts = predict_topn(model, hist, nrcmds=10, sparse=True,
                                     user_block=16, scan=True, **CPU)
    _oracle_check(model, hist, scores, counts)


def test_predict_coo_candidate_paths_match_dense(rng, monkeypatch):
    jmodel = random_csr(rng, 60, 60, density=0.2, seed=280)
    jhist = random_csr(rng, 30, 60, density=0.2, seed=281)
    model, hist = _port(jmodel), _port(jhist)
    cand = rng.integers(-1, 60, size=(30, 9)).astype(np.int32)
    cand[0, 0] = hist.indices[hist.indptr[0]] if hist.row_nnz()[0] else 0

    dcs, dns = predict_candidate_scores(model, hist, cand, sparse=False,
                                        **CPU)
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
    ccs, cns = predict_candidate_scores(model, hist, cand, sparse=True,
                                        user_block=8, **CPU)
    np.testing.assert_array_equal(dns, cns)
    np.testing.assert_allclose(dcs, ccs, rtol=1e-5, atol=1e-6)
    jcs, jns = jpredict.predict_candidate_scores(jmodel, jhist, cand,
                                                 sparse=False)
    np.testing.assert_array_equal(dns, jns)
    np.testing.assert_allclose(dcs, jcs, rtol=1e-5, atol=1e-6)

    neg = rng.integers(0, 60, size=(30, 8)).astype(np.int32)
    di, dsc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=5, sparse=False,
                                   **CPU)
    si, ssc, _ = predict_topn_1vsk(model, hist, neg, nrcmds=5, sparse=True,
                                   user_block=8, **CPU)
    np.testing.assert_allclose(np.sort(dsc, axis=1), np.sort(ssc, axis=1),
                               rtol=1e-5, atol=1e-6)
    for u in range(30):
        assert set(di[u]) == set(si[u]), u


def test_sparse_model_bf16_values(rng, monkeypatch):
    """As the JAX case, with the torch dtypes in place of their names."""
    model = _port(random_csr(rng, 80, 80, density=0.15, seed=501))
    hist = _port(random_csr(rng, 25, 80, density=0.2, seed=502))

    Wf = sparsify_model_device(model, **CPU)
    assert Wf[1].dtype == torch.float32
    fi, fsc, fc = predict_topn(model, hist, nrcmds=6, W_dev=Wf, sparse=True,
                               **CPU)

    monkeypatch.setenv("SLIM_PREDICT_WVAL_BF16", "1")
    Wb = sparsify_model_device(model, **CPU)
    assert Wb[1].dtype == torch.bfloat16
    bi, bsc, bc = predict_topn(model, hist, nrcmds=6, W_dev=Wb, sparse=True,
                               **CPU)

    np.testing.assert_array_equal(fc, bc)
    np.testing.assert_allclose(bsc, fsc, rtol=2e-2, atol=1e-3)
    for u in range(hist.nrows):
        k = int(fc[u])
        assert len(set(fi[u][:k]) & set(bi[u][:k])) >= k - 1
