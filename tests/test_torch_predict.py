"""Dense top-N of the PyTorch port against the JAX package, on a model the
JAX package learned and carried across with slim_tpu_torch.convert."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from conftest import random_csr
from slim_tpu.api import learn as jax_learn
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.predict import _slab_densifyT, predict_topn as jax_predict
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import convert
from slim_tpu_torch.predict import densify_model, predict_topn
from slim_tpu_torch.types import CSR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


@pytest.fixture(scope="module")
def learned():
    rng = np.random.default_rng(21)
    trn = random_csr(rng, 150, 60, density=0.15)
    model, _ = jax_learn(trn, JaxConfig(l1r=0.5, l2r=1.0))
    return trn, model


def _jax_topn(model, hist, k):
    return jax_predict(model, hist, nrcmds=k, scan=True,
                       precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("implicit", [False, True])
def test_topn_ids_match_jax(learned, implicit):
    trn, model = learned
    hist = trn.binarize() if implicit else trn
    ids_j, sc_j, cnt_j = _jax_topn(model, hist, 10)
    pm = convert.model_from_numpy(model.indptr, model.indices, model.data,
                                  model.nrows, model.ncols)
    ids_t, sc_t, cnt_t = predict_topn(pm, _port(hist), nrcmds=10,
                                      device="cpu")
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5)


def test_tied_scores_order_lowest_id_first():
    """Equal model weights and binary histories tie many integer scores:
    the same ids as the JAX package's lax.top_k, lowest id first among
    equal scores (torch.topk leaves that order unspecified)."""
    rng = np.random.default_rng(3)
    n, nusers = 120, 60
    W = (rng.random((n, n)) < 0.08).astype(np.float32)
    np.fill_diagonal(W, 0.0)
    r, c = np.nonzero(W)
    model = JCSR.from_ijv(r, c, W[r, c], nrows=n, ncols=n)
    hist = random_csr(rng, nusers, n, density=0.05).binarize()
    ids_j, sc_j, cnt_j = _jax_topn(model, hist, 10)
    ids_t, sc_t, cnt_t = predict_topn(_port(model), _port(hist), nrcmds=10,
                                      device="cpu")
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(sc_t, sc_j)
    np.testing.assert_array_equal(ids_t, ids_j)
    tied = (sc_t[:, 1:] == sc_t[:, :-1]) & (ids_t[:, 1:] >= 0)
    assert tied.sum() > 50


def test_history_excluded_and_short_lists(learned):
    trn, model = learned
    pm = _port(model)
    ids, _, cnt = predict_topn(pm, _port(trn), nrcmds=20, device="cpu")
    for u in range(trn.nrows):
        h = set(trn.indices[trn.indptr[u]:trn.indptr[u + 1]].tolist())
        got = ids[u, :cnt[u]].tolist()
        assert h.isdisjoint(got)
        assert np.all(ids[u, cnt[u]:] == -1)


def test_implicit_history_equals_ones(rng):
    n = 10
    W = rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    h = _port(random_csr(rng, 4, n, density=0.4))
    ones = CSR.from_arrays(4, n, h.indptr, h.indices,
                           np.ones(h.nnz, np.float32))
    a = predict_topn(model, ones, nrcmds=4, device="cpu")
    b = predict_topn(model, h.binarize(), nrcmds=4, device="cpu")
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
    np.testing.assert_array_equal(a[0], b[0])


def test_duplicate_history_entries_accumulate(learned):
    """A history carrying a duplicated id scores it twice, as the JAX
    scan path does (predict.c's += loop)."""
    trn, model = learned
    ip, ix = trn.indptr.copy(), trn.indices
    vals = trn.values()
    dup_ix = np.insert(ix, ip[1], ix[ip[0]])     # repeat user 0's first id
    dup_v = np.insert(vals, ip[1], vals[ip[0]])
    ip2 = ip.copy()
    ip2[1:] += 1
    hj = JCSR.from_arrays(trn.nrows, trn.ncols, ip2, dup_ix, dup_v)
    ids_j, sc_j, cnt_j = _jax_topn(model, hj, 10)
    ids_t, sc_t, cnt_t = predict_topn(_port(model), _port(hj), nrcmds=10,
                                      device="cpu")
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5)


def test_densify_model_matches_slab_densify(rng):
    """Model densify == the JAX slab densify (interpret mode), including
    duplicate (row, col) accumulation."""
    npad, n = 256, 240
    rows = rng.integers(0, n, 600)
    cols = rng.integers(0, n, 600)
    vals = rng.integers(-3, 4, 600).astype(np.float32)
    rows[10:20], cols[10:20] = rows[0], cols[0]
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    model = CSR.from_arrays(n, n, indptr, cols.astype(np.int32), vals)
    rs = np.full(npad, model.nnz, np.int32)
    rl = np.zeros(npad, np.int32)
    rs[:n] = indptr[:n]
    rl[:n] = np.diff(indptr)
    M = _slab_densifyT(jnp.asarray(model.indices.astype(np.uint16)),
                       jnp.asarray(vals), rs, rl, npad, npad, interpret=True)
    np.testing.assert_array_equal(densify_model(model, npad, "cpu").numpy(),
                                  np.asarray(M).T)


def test_wide_catalogue_not_ported():
    """A 40,000-item catalogue (npad above SPARSE_PREDICT_THRESHOLD) is
    served by the sparse route: an empty model gives empty lists."""
    m = CSR.empty(40000, 40000)
    hist = CSR.from_ijv([0, 0, 1], [5, 39999, 7], [1.0, 1.0, 1.0], nrows=2,
                        ncols=40000)
    ids, scores, counts = predict_topn(m, hist, device="cpu")
    assert ids.shape == (2, 10) and (ids == -1).all()
    assert (scores == 0).all() and (counts == 0).all()
