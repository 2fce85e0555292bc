"""The port's sparse, COO, 1-vs-k and candidate-score prediction against
the JAX package (the cases of tests/test_predict.py), the ragged scoring's
step budget under a skewed model, the retained pack of another npad, and
the neg-file CLI, on the CPU.  Ids must equal the JAX package's except at
the near ties ``checks.ranked_mismatches`` forgives (scores within 1e-5
rel, never exact ties); scores agree to rtol 1e-5."""

import re

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.api import learn as jax_learn
from slim_tpu.cli import slim_predict as jax_slim_predict
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.io.readers import write_matrix
from slim_tpu.predict import (predict_candidate_scores as jax_cand,
                              predict_topn as jax_topn,
                              predict_topn_1vsk as jax_1vsk)
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch import predict as P
from slim_tpu_torch.checks import ranked_mismatches, topn_oracle_mismatches
from slim_tpu_torch.cli import slim_predict
from slim_tpu_torch.predict import (predict_candidate_scores,
                                    predict_topn, predict_topn_1vsk,
                                    sparsify_model_device)
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


def assert_ranked_match(ids, sc, ids_ref, sc_ref, counts_ref=None,
                        rtol=1e-5):
    """Scores within ``rtol``; ids equal except where ``ranked_mismatches``
    forgives a near tie (exact ties must come in the same order)."""
    np.testing.assert_allclose(sc, sc_ref, rtol=rtol, atol=1e-6)
    differ, off_near = ranked_mismatches(ids, sc, ids_ref, sc_ref,
                                         counts_ref, rtol)
    assert off_near == 0, (differ, off_near)


def assert_topn_match(got, ref):
    np.testing.assert_array_equal(got[2], ref[2])
    assert_ranked_match(got[0], got[1], ref[0], ref[1], ref[2])


def _empty_row(h, r):
    """``h`` with row ``r``'s entries removed."""
    keep = np.ones(h.nnz, bool)
    keep[h.indptr[r]:h.indptr[r + 1]] = False
    ip = h.indptr.copy()
    ip[r + 1:] -= h.indptr[r + 1] - h.indptr[r]
    return JCSR.from_arrays(h.nrows, h.ncols, ip, h.indices[keep],
                            None if h.data is None else h.data[keep])


def _big_case():
    """tests/test_predict.py's 200k-item workload."""
    n, nusers = 200_000, 64
    rng = np.random.default_rng(400)
    nnz_m = 12 * n
    mr = rng.integers(0, n, nnz_m)
    mc = rng.integers(0, n, nnz_m)
    mv = rng.random(nnz_m, dtype=np.float32) + 0.01
    model = JCSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), 20)
    hc = rng.integers(0, n, hr.size)
    hist = JCSR.from_ijv(hr, hc, np.ones(hr.size, np.float32),
                         nrows=nusers, ncols=n)
    return model, hist


@pytest.mark.parametrize("sparse", [False, True])
def test_1vsk_matches_jax(rng, sparse):
    """GetRec_1vsk over given candidates (test_predict.py:69), dense and
    sparse: the top 3 candidates and their scores, counts the width."""
    n = 15
    W = (rng.random((n, n)) < 0.5) * rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = JCSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist = random_csr(rng, 3, n, density=0.4)
    neg = np.array([[1, 5, 9, 13], [0, 2, 4, 6], [3, 7, 11, 14]], np.int32)
    ref = jax_1vsk(model, hist, neg, nrcmds=3, sparse=sparse)
    got = predict_topn_1vsk(_port(model), _port(hist), neg, nrcmds=3,
                            sparse=sparse, device="cpu")
    assert_topn_match(got, ref)
    assert got[2].tolist() == [3, 3, 3]


@pytest.mark.parametrize("coo", ["0", "1"])
def test_1vsk_history_not_excluded(monkeypatch, coo):
    """A history item among the candidates keeps its score
    (test_predict.py:93), on the score-row and the COO route."""
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", coo)
    n = 6
    W = np.ones((n, n), dtype=np.float32)
    np.fill_diagonal(W, 0)
    rows, cols = np.nonzero(W)
    model = CSR.from_ijv(rows, cols, W[rows, cols], nrows=n, ncols=n)
    hist = CSR.from_ijv([0, 0], [1, 2], [1.0, 1.0], nrows=1, ncols=n)
    neg = np.array([[1, 4]], dtype=np.int32)
    ids, scores, _ = predict_topn_1vsk(model, hist, neg, nrcmds=2,
                                       sparse=True, device="cpu")
    got = dict(zip(ids[0].tolist(), scores[0].tolist()))
    assert got == {4: 2.0, 1: 1.0}


@pytest.mark.parametrize("implicit", [False, True])
def test_sparse_matches_dense_and_jax(rng, implicit):
    """The score-row route (test_predict.py:110 and :129) equals the dense
    route and the JAX package's sparse route, explicit and implicit
    histories, a user block that does not divide the users."""
    model = random_csr(rng, 64, 64, density=0.15, seed=200)
    hist = random_csr(rng, 37, 64, density=0.2, implicit=implicit, seed=201)
    ref = jax_topn(model, hist, nrcmds=7, sparse=True, scan=False,
                   user_block=8)
    got = predict_topn(_port(model), _port(hist), nrcmds=7, sparse=True,
                       user_block=8, device="cpu")
    dense = predict_topn(_port(model), _port(hist), nrcmds=7, sparse=False,
                         device="cpu")
    assert_topn_match(got, ref)
    assert_topn_match(got, dense)


def test_1vsk_sparse_matches_jax(rng):
    """test_predict.py:139: sparse 1-vs-k against the JAX package's."""
    model = random_csr(rng, 50, 50, density=0.2, seed=220)
    hist = random_csr(rng, 25, 50, density=0.2, seed=221)
    neg = rng.integers(0, 50, size=(25, 12)).astype(np.int32)
    ref = jax_1vsk(model, hist, neg, nrcmds=6, sparse=True, user_block=8)
    got = predict_topn_1vsk(_port(model), _port(hist), neg, nrcmds=6,
                            sparse=True, user_block=8, device="cpu")
    assert_topn_match(got, ref)


@pytest.mark.parametrize("coo", ["0", "1"])
def test_200k_item_catalogue(monkeypatch, coo):
    """A 200k-item catalogue (test_predict.py:173 and :317) routes sparse
    by default: score rows, or COO when forced; both equal the JAX
    package's and a scipy oracle."""
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", coo)
    model, hist = _big_case()
    ref = jax_topn(model, hist, nrcmds=10, sparse=True, user_block=16,
                   scan=True)
    got = predict_topn(_port(model), _port(hist), nrcmds=10, user_block=16,
                       device="cpu")
    assert_topn_match(got, ref)
    assert topn_oracle_mismatches(model, hist, got) == 0


def test_resident_padded_model(rng):
    """A sparsify_model_device pair through W_dev routes sparse and equals
    the JAX package with its own pair (test_predict.py:225); the pair's
    layout is the JAX package's."""
    from slim_tpu.predict import sparsify_model_device as jax_sparsify

    model = random_csr(rng, 60, 60, density=0.2, seed=240)
    Wj = jax_sparsify(model)
    Wt = sparsify_model_device(_port(model), device="cpu")
    np.testing.assert_array_equal(Wt[0].numpy(), np.asarray(Wj[0]))
    np.testing.assert_array_equal(Wt[1].numpy(), np.asarray(Wj[1]))
    for implicit, seed in ((False, 241), (True, 242)):
        hist = random_csr(rng, 53, 60, density=0.2, implicit=implicit,
                          seed=seed)
        ref = jax_topn(model, hist, nrcmds=7, W_dev=Wj, scan=True,
                       user_block=16)
        got = predict_topn(_port(model), _port(hist), nrcmds=7, W_dev=Wt,
                           user_block=16)
        assert_topn_match(got, ref)


def test_coo_matches_score_rows_and_jax(rng, monkeypatch):
    """The COO route (test_predict.py:283): history exclusion, implicit
    histories, empty-history users and score ties, against the score-row
    route and the JAX package's COO route."""
    model = random_csr(rng, 70, 70, density=0.15, seed=270)
    for implicit, seed in ((False, 271), (True, 272)):
        hist = _empty_row(random_csr(rng, 45, 70, density=0.15,
                                     implicit=implicit, seed=seed), 3)
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "0")
        rows = predict_topn(_port(model), _port(hist), nrcmds=7,
                            sparse=True, device="cpu")
        monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1")
        ref = jax_topn(model, hist, nrcmds=7, sparse=True, scan=False,
                       user_block=16)
        got = predict_topn(_port(model), _port(hist), nrcmds=7,
                           sparse=True, user_block=16, device="cpu")
        assert_topn_match(got, ref)
        assert_topn_match(got, rows)
        assert got[2][3] == 0 and (got[0][3] == -1).all()


@pytest.mark.parametrize("route", ["dense", "rows", "coo"])
def test_candidate_paths_match_jax(rng, monkeypatch, route):
    """Candidate scores (history excluded, nscored over all items) and
    1-vs-k (history kept) on each route against the JAX package's dense
    forms (test_predict.py:353)."""
    model = random_csr(rng, 60, 60, density=0.2, seed=280)
    hist = random_csr(rng, 30, 60, density=0.2, seed=281)
    cand = rng.integers(-1, 62, size=(30, 9)).astype(np.int32)
    cand[0, 0] = hist.indices[hist.indptr[0]]
    neg = rng.integers(0, 60, size=(30, 8)).astype(np.int32)
    jcs, jns = jax_cand(model, hist, cand, sparse=False)
    j1 = jax_1vsk(model, hist, neg, nrcmds=5, sparse=False)
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD",
                       "1" if route == "coo" else "0")
    kw = dict(sparse=route != "dense", user_block=8, device="cpu")
    cs, ns = predict_candidate_scores(_port(model), _port(hist), cand, **kw)
    np.testing.assert_array_equal(ns, jns)
    np.testing.assert_allclose(cs, jcs, rtol=1e-5, atol=1e-6)
    assert cs[0, 0] == 0.0 and (cs[cand < 0] == 0).all()
    assert_topn_match(predict_topn_1vsk(_port(model), _port(hist), neg,
                                        nrcmds=5, **kw), j1)


def test_sparse_model_bf16_values(rng, monkeypatch):
    """SLIM_PREDICT_WVAL_BF16=1 keeps the sparse model's values in
    bfloat16 (test_predict.py:416): the JAX package's pair, and top-N
    within bf16 rounding of the float32 model's."""
    from slim_tpu.predict import sparsify_model_device as jax_sparsify

    model = random_csr(rng, 80, 80, density=0.15, seed=501)
    hist = random_csr(rng, 25, 80, density=0.2, seed=502)
    Wf = sparsify_model_device(_port(model), device="cpu")
    assert Wf[1].dtype == torch.float32
    fi, fsc, fc = predict_topn(_port(model), _port(hist), nrcmds=6,
                               W_dev=Wf)
    monkeypatch.setenv("SLIM_PREDICT_WVAL_BF16", "1")
    Wb = sparsify_model_device(_port(model), device="cpu")
    assert Wb[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(Wb[1].float().numpy(),
                                  np.asarray(jax_sparsify(model)[1],
                                             np.float32))
    ref = jax_topn(model, hist, nrcmds=6, W_dev=jax_sparsify(model),
                   sparse=True)
    for got in (predict_topn(_port(model), _port(hist), nrcmds=6, W_dev=Wb),
                predict_topn(_port(model), _port(hist), nrcmds=6,
                             sparse=True, device="cpu")):
        assert_topn_match(got, ref)
        np.testing.assert_array_equal(got[2], fc)
        np.testing.assert_allclose(got[1], fsc, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("coo", ["0", "1"])
def test_skewed_model_steps_hold_budget(rng, monkeypatch, coo):
    """One model row 100x longer than the rest (a popular item that
    neighbours most targets): with a budget of 64 pairs per step, every
    step of the ragged scoring expands at most 64 pairs unless a single
    entry (score rows) or user (COO) alone has more, and the top-N equals
    the unchunked call's and the JAX package's."""
    n, nusers = 400, 50
    mr = np.repeat(np.arange(n), 3)
    mc = rng.integers(0, n, mr.size)
    mr = np.concatenate([mr, np.full(300, 7)])
    mc = np.concatenate([mc, rng.choice(n, 300, replace=False)])
    model = JCSR.from_ijv(mr, mc, rng.random(mr.size).astype(np.float32)
                          + 0.01, nrows=n, ncols=n)
    assert model.row_nnz().max() >= 100 * np.median(model.row_nnz())
    hist = random_csr(rng, nusers, n, density=0.03, implicit=True, seed=3)
    hist = JCSR.from_arrays(nusers, n, hist.indptr, np.where(
        np.arange(hist.nnz) % 4 == 0, 7, hist.indices), None) \
        .sum_duplicate_entries().binarize()
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", coo)
    full = predict_topn(_port(model), _port(hist), nrcmds=10, sparse=True,
                        device="cpu")
    seen = []
    real = P._Route.pairs

    def spy(self, a, b, u0):
        seen.append((int(self.L_h[a:b].sum()), int(self.L_h[a:b].max())))
        return real(self, a, b, u0)

    monkeypatch.setattr(P._Route, "pairs", spy)
    monkeypatch.setattr(P, "STEP_BYTES", 64 * P.PAIR_BYTES)
    got = predict_topn(_port(model), _port(hist), nrcmds=10, sparse=True,
                       device="cpu")
    assert len(seen) > 10
    if coo == "0":
        assert all(s <= max(64, m) for s, m in seen)
    else:
        per_user = [sum(model.row_nnz()[hist.indices[a:b]]) for a, b in
                    zip(hist.indptr[:-1], hist.indptr[1:])]
        assert all(s <= max(64, max(per_user)) for s, _ in seen)
        assert max(s for s, _ in seen) <= max(
            64, max(per_user)) and sum(s for s, _ in seen) == sum(per_user)
    assert_topn_match(got, full)
    assert_topn_match(got, jax_topn(model, hist, nrcmds=10, sparse=True,
                                    scan=False))


def test_pack_of_other_npad_is_ignored():
    """A retained pack of a model learned on 300 items (npad 384), with
    histories of 400 columns (npad 512): the pack is ignored and the model
    uploaded, on predict_topn, 1-vs-k and candidate scores, giving the
    JAX package's results (it falls back the same way)."""
    rng = np.random.default_rng(8)
    trn = random_csr(rng, 500, 300, density=0.03)
    model, stats = learn(_port(trn), SlimConfig(l1r=0.5, l2r=1.0),
                         keep_device_model=True, device="cpu")
    pack = stats["W_dev"]
    assert pack.npad == 384
    jm = JCSR.from_arrays(model.nrows, model.ncols, model.indptr,
                          model.indices, model.data)
    hist = random_csr(rng, 40, 400, density=0.03)
    neg = rng.integers(0, 400, size=(40, 6)).astype(np.int32)
    ref = jax_topn(jm, hist, nrcmds=10, sparse=False)
    assert_topn_match(predict_topn(model, _port(hist), nrcmds=10,
                                   W_dev=pack), ref)
    assert_topn_match(predict_topn_1vsk(model, _port(hist), neg, nrcmds=4,
                                        W_dev=pack),
                      jax_1vsk(jm, hist, neg, nrcmds=4, sparse=False))
    cs, ns = predict_candidate_scores(model, _port(hist), neg, W_dev=pack)
    jcs, jns = jax_cand(jm, hist, neg, sparse=False)
    np.testing.assert_array_equal(ns, jns)
    np.testing.assert_allclose(cs, jcs, rtol=1e-5, atol=1e-6)


def test_negfile_cli_matches_jax(tmp_path, capsys):
    """slim_predict with a neg-file (test_cli.py:37) against the JAX CLI on
    the same model and files: the same hr / arhr line and the same
    recommendation file, ids off near-ties."""
    rng = np.random.default_rng(0)
    trn = random_csr(rng, 40, 25, density=0.3, seed=200)
    tst = random_csr(rng, 40, 25, density=0.08, seed=201)
    neg = random_csr(rng, 40, 25, density=0.25, seed=202)
    model, _ = jax_learn(trn, JaxConfig(l1r=0.3, l2r=0.5))
    files = {}
    for name, m in (("m", model), ("trn", trn), ("tst", tst), ("neg", neg)):
        files[name] = str(tmp_path / f"{name}.csr")
        write_matrix(m, files[name], fmt="csr")
    args = [files[k] for k in ("m", "trn", "tst", "neg")]
    out = {}
    for tag, cli, extra in (("jax", jax_slim_predict, []),
                            ("port", slim_predict, ["-device=cpu"])):
        rec = str(tmp_path / f"{tag}.txt")
        assert cli.main(["-nrcmds=5", f"-outfile={rec}"] + extra + args) == 0
        line = re.search(r"hr: .*", capsys.readouterr().out).group(0)
        rows = [np.array(r.split(), float).reshape(-1, 2)
                for r in open(rec).read().splitlines()]
        out[tag] = line, rows
    assert out["port"][0] == out["jax"][0]
    assert len(out["port"][1]) == len(out["jax"][1]) == 40
    for a, b in zip(out["port"][1], out["jax"][1]):
        assert a.shape == b.shape
        if len(a):
            assert_ranked_match(a[None, :, 0], a[None, :, 1],
                                b[None, :, 0], b[None, :, 1], rtol=1e-5)


def test_ranked_mismatches_rule():
    """The shared near-tie rule: a swap of two neighbours whose reference
    scores differ by under rtol, a last-slot id whose two scores differ by
    under rtol, and a last-slot id lower than the reference's at the very
    same score (the reference breaks exact ties by the lowest id, so its
    higher id won a near tie), are forgiven; an exact tie in another
    order, or a last-slot id higher than the reference's at the very same
    score, is not."""
    ref_ids = np.array([[4, 30, 22, 21], [4, 5, 6, 28]])
    ref_sc = np.array([[9.0, 5.3554816, 5.3554811, 4.0],
                       [9.0, 8.0, 7.0, 4.8030233]], np.float32)
    ids = np.array([[4, 22, 30, 21], [4, 5, 6, 41]])
    sc = ref_sc.copy()
    sc[1, 3] = np.float32(4.8030238)
    assert ranked_mismatches(ids, sc, ref_ids, ref_sc) == (3, 0)
    assert ranked_mismatches(ids, ref_sc, ref_ids, ref_sc) == (3, 1)
    assert ranked_mismatches(ref_ids, ref_sc, ids, ref_sc) == (3, 0)
    tie = np.array([[9.0, 5.0, 5.0, 4.0]], np.float32)
    assert ranked_mismatches(np.array([[4, 22, 30, 21]]), tie,
                             np.array([[4, 30, 22, 21]]), tie) == (2, 2)
    assert ranked_mismatches(ids[1:], sc[1:], ref_ids[1:], ref_sc[1:],
                             counts_ref=[3]) == (1, 1)
