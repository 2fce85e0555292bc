"""The port's native host runtime (slim_tpu_torch.native) against the JAX
package, scipy and the float64 oracle of test_cd.py, and its four call
sites: the text tokeniser, the host Gram, the small-catalogue predict
route and SLIM.predict; its model assembly (``csr_from_blocks``) is the
reference the learn's own assembly is held to.  Nothing here uses
slim_tpu.native; the router's JAX side gets a stub for its availability."""

import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import slim_tpu.io as jio
import slim_tpu.native as jnative
import slim_tpu.predict as jpredict
from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SLIM, SLIMatrix, SlimConfig, native
from slim_tpu_torch import io as tio
from slim_tpu_torch import predict as P
from slim_tpu_torch.checks import ranked_mismatches, tie_order_mismatches
from slim_tpu_torch.io import readers
from slim_tpu_torch.ops.gram import compute_gram
from slim_tpu_torch.solvers import cd as tcd
from slim_tpu_torch.types import CSR
from test_cd import oracle_column, oracle_objective

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it (the
    suite runs several pytest workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def _dense(m):
    return m.to_scipy().toarray()


# ------------------------------------------------------------------ #
# CD
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("implicit", [False, True])
def test_cd_learn_matches_jax(implicit):
    mat = random_csr(np.random.default_rng(55), 50, 20, density=0.3,
                     implicit=implicit)
    l1r, l2r = (0.3, 0.5) if implicit else (0.5, 0.5)
    jm, js = jax_cd(mat, JaxConfig(l1r=l1r, l2r=l2r, optTol=1e-12,
                                   shuffle=False))
    model, err, obj = native.cd_learn(_port(mat), l1r=l1r, l2r=l2r,
                                      optTol=1e-12, shuffle=False)
    np.testing.assert_allclose(_dense(model), _dense(jm), atol=5e-4)
    np.testing.assert_allclose(obj, js["loss"], rtol=1e-4)
    np.testing.assert_allclose(err, js["fit"], rtol=1e-4)


def test_cd_learn_same_at_1_and_4_threads():
    mat = _port(random_csr(np.random.default_rng(77), 60, 25, density=0.25))
    m1, e1, o1 = native.cd_learn(mat, l1r=0.5, l2r=1.0, optTol=1e-12,
                                 shuffle=False, nthreads=1)
    m4, e4, o4 = native.cd_learn(mat, l1r=0.5, l2r=1.0, optTol=1e-12,
                                 shuffle=False, nthreads=4)
    assert m1 == m4
    np.testing.assert_allclose(o1, o4, rtol=1e-10)
    np.testing.assert_allclose(e1, e4, rtol=1e-10)


@pytest.mark.parametrize("l1r,l2r", [(0.5, 0.5), (0.1, 2.0)])
def test_cd_learn_matches_f64_oracle(l1r, l2r):
    rng = np.random.default_rng(42)
    A = (rng.random((30, 12)) < 0.4).astype(np.float32) * \
        rng.integers(1, 4, (30, 12)).astype(np.float32)
    import scipy.sparse as sp

    model, _, _ = native.cd_learn(CSR.from_scipy(sp.csr_matrix(A)), l1r=l1r,
                                  l2r=l2r, optTol=1e-12, shuffle=False)
    W = _dense(model)
    for j in range(12):
        x_ref = oracle_column(A, j, l1r, l2r)
        np.testing.assert_allclose(W[:, j], x_ref, atol=2e-4,
                                   err_msg=f"column {j}")
        assert oracle_objective(A, W[:, j].astype(np.float64), j, l1r,
                                l2r) <= \
            oracle_objective(A, x_ref, j, l1r, l2r) * (1 + 1e-4) + 1e-6


def test_cd_learn_synth_goldens():
    """The vendored synth set at l1r = l2r = 1 (shuffled, all threads):
    the quality goldens of tests/test_goldens.py."""
    trn = tio.read_matrix(os.path.join(DATA, "synth-train.ijv"), fmt="ijv")
    model, _, obj = native.cd_learn(trn, l1r=1.0, l2r=1.0, optTol=1e-7,
                                    maxniters=10000)
    np.testing.assert_allclose(obj, 4730.0005, rtol=1e-4)
    assert abs(model.nnz - 10613) <= 0.01 * 10613


# ------------------------------------------------------------------ #
# Gram
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("pad", [None, 40])
@pytest.mark.parametrize("implicit", [False, True])
def test_gram_dense_equals_scipy(pad, implicit):
    mat = _port(random_csr(np.random.default_rng(88), 70, 33, density=0.3,
                           implicit=implicit))
    sp = mat.to_scipy()
    want = (sp.T @ sp).toarray().astype(np.float32)
    g = native.gram_dense(mat, pad_to=pad)
    n = pad or 33
    assert g.shape == (n, n) and g.dtype == np.float32
    np.testing.assert_array_equal(g[:33, :33], want)
    assert not g[33:].any() and not g[:, 33:].any()
    # the host Gram of compute_gram is this kernel's
    np.testing.assert_array_equal(
        compute_gram(mat, "host", pad_to=n, device="cpu").numpy(), g)


# ------------------------------------------------------------------ #
# predict
# ------------------------------------------------------------------ #
def _check_tie_tolerant(got, ref, rtol=1e-5):
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=rtol, atol=1e-6)
    _, bad = tie_order_mismatches(got[0], *ref, rtol=rtol)
    assert bad == 0


@pytest.mark.parametrize("implicit", [False, True])
def test_predict_topn_matches_device_routes(implicit):
    rng = np.random.default_rng(300)
    model = random_csr(rng, 60, 60, density=0.15)
    hist = random_csr(rng, 30, 60, density=0.2, implicit=implicit)
    got = native.predict_topn(_port(model), _port(hist), nrcmds=8)
    port = P.predict_topn(_port(model), _port(hist), nrcmds=8, sparse=False,
                          device="cpu")
    jx = jpredict.predict_topn(model, hist, nrcmds=8, sparse=False,
                               precision=jax.lax.Precision.HIGHEST)
    _check_tie_tolerant(got, port)
    _check_tie_tolerant(got, jx)


def test_predict_topn_exact_ties_first_touched():
    """Two items of one score: the native loop lists the one touched first
    (item 7, from history item 0's model row), the device route the lowest
    id; the tie-tolerant check forgives the order, the ranked one not."""
    model = CSR.from_ijv(np.array([0, 1]), np.array([7, 2]),
                         np.ones(2, np.float32), nrows=10, ncols=10)
    hist = CSR.from_ijv(np.array([0, 0]), np.array([0, 1]),
                        np.ones(2, np.float32), nrows=1, ncols=10)
    got = native.predict_topn(model, hist, nrcmds=3)
    dev = P.predict_topn(model, hist, nrcmds=3, sparse=False, device="cpu")
    assert got[0].tolist() == [[7, 2, -1]] and got[2].tolist() == [2]
    assert dev[0].tolist() == [[2, 7, -1]]
    _check_tie_tolerant(got, dev)
    assert ranked_mismatches(got[0], got[1], *dev)[1] > 0


# ------------------------------------------------------------------ #
# tokeniser
# ------------------------------------------------------------------ #
TOKEN_CASES = {
    "empty": b"",
    "one newline": b"\n",
    "blank lines": b"\n1 2\n\n3 4\n\n",
    "crlf": b"1 2\r\n3 4\r\n",
    "no final newline": b"1 2\n3 4",
    "trailing blanks": b"1 2 \t \n3 4  \n  \n",
    "exponents": b"1e3 2.5E-2\n-1e+1 .5 7.\n",
}


@pytest.mark.parametrize("name", sorted(TOKEN_CASES))
def test_parse_tokens_matches_numpy(name):
    raw = TOKEN_CASES[name]
    tok, per_line = native.parse_tokens(raw)
    want_tok, want_lines = readers._tokenise_numpy(raw)
    np.testing.assert_array_equal(tok, want_tok)
    np.testing.assert_array_equal(per_line, want_lines)
    assert per_line.dtype == np.int64


def test_parse_tokens_documented_differences():
    """A lone \\r is whitespace to the native tokeniser (one line; numpy's
    splitlines makes two), and it skips a character no number starts with
    where numpy raises."""
    tok, lines = native.parse_tokens(b"1 2\r3 4\n")
    assert tok.tolist() == [1, 2, 3, 4] and lines.tolist() == [4]
    assert readers._tokenise_numpy(b"1 2\r3 4\n")[1].tolist() == [2, 2]
    tok, lines = native.parse_tokens(b"1 x2\n")
    assert tok.tolist() == [1, 2] and lines.tolist() == [2]
    with pytest.raises(ValueError):
        readers._tokenise_numpy(b"1 x2\n")


@pytest.mark.parametrize("fmt", ["csr", "csrnv", "cluto", "ijv", "binrow"])
def test_readers_equal_jax(tmp_path, fmt):
    """The synth set written by the JAX package in each format (the text
    formats with CRLF line ends and a blank row) reads the same through
    the port's readers, which tokenise natively, and the JAX ones."""
    jm = jio.read_matrix(os.path.join(DATA, "synth-train.ijv"), fmt="ijv")
    rows = np.repeat(np.arange(jm.nrows), np.diff(jm.indptr))
    keep = rows != 5                          # row 5 empty
    jm = JCSR.from_ijv(rows[keep], jm.indices[keep], jm.values()[keep],
                       nrows=jm.nrows, ncols=jm.ncols)
    path = tmp_path / f"m.{fmt}"
    jio.write_matrix(jm, str(path), fmt=fmt)
    if fmt != "binrow":
        path.write_bytes(path.read_bytes().replace(b"\n", b"\r\n"))
    want = jio.read_matrix(str(path), fmt=fmt)
    got = tio.read_matrix(str(path), fmt=fmt)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values(), want.values())


# ------------------------------------------------------------------ #
# assembly
# ------------------------------------------------------------------ #
def test_csr_from_blocks_equals_from_ijv():
    """Unsorted in-row columns, empty fragments and empty rows: the same
    CSR, entry for entry, as scipy's assembly of the concatenation."""
    rng = np.random.default_rng(5)
    n = 57
    pairs = rng.permutation(n * n)[:200]
    r, c = (pairs // n).astype(np.int32), (pairs % n).astype(np.int32)
    r[r == 11] = 12                           # row 11 empty
    _, first = np.unique(r.astype(np.int64) * n + c, return_index=True)
    r, c = r[np.sort(first)], c[np.sort(first)]
    v = rng.random(r.size).astype(np.float32)
    cuts = [0, 0, 13, 14, 90, 90, r.size]     # two empty fragments
    frag = [(r[a:b], c[a:b], v[a:b]) for a, b in zip(cuts, cuts[1:])]
    indptr, indices, data = native.csr_from_blocks(
        *[[f[i] for f in frag] for i in range(3)], n)
    want = CSR.from_ijv(r, c, v, nrows=n, ncols=n, no_duplicates=True)
    np.testing.assert_array_equal(indptr, want.indptr)
    np.testing.assert_array_equal(indices, want.indices)
    np.testing.assert_array_equal(data, want.data)
    assert indptr[12] == indptr[11]
    empty = native.csr_from_blocks([], [], [], 4)
    assert empty[0].tolist() == [0] * 5 and empty[1].size == 0


def test_csr_from_blocks_rejects_bad_rows():
    with pytest.raises(ValueError):
        native.csr_from_blocks([np.array([3], np.int32)],
                               [np.array([0], np.int32)],
                               [np.ones(1, np.float32)], 3)


def _native_assemble(coord, target, vals, n):
    """``native.csr_from_blocks`` over ``solvers.cd._assemble``'s lists of
    tensors, as host arrays."""
    host = [[a.cpu().numpy() for a in lst] for lst in (coord, target, vals)]
    return CSR.from_arrays(n, n, *native.csr_from_blocks(*host, n))


def test_learn_same_model_either_assembly(monkeypatch):
    """The synth learn gives the same model through its own assembly (the
    held entries sorted, with no native call, with or without a compiler)
    and with the assembly replaced by the native counting sort over the
    same blocks."""
    trn = tio.read_matrix(os.path.join(DATA, "synth-train.ijv"), fmt="ijv")
    cfg = SlimConfig(l1r=1.0, l2r=1.0)
    calls = []
    orig = native.csr_from_blocks
    monkeypatch.setattr(native, "csr_from_blocks",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(native, "available", lambda: False)
    m1, s1 = tcd.estimate_model_cd(trn, cfg, device="cpu")
    assert not calls and s1["assembly"] == "host"
    monkeypatch.setattr(tcd, "_assemble", _native_assemble)
    m0, s0 = tcd.estimate_model_cd(trn, cfg, device="cpu")
    assert calls
    np.testing.assert_array_equal(m1.indptr, m0.indptr)
    np.testing.assert_array_equal(m1.indices, m0.indices)
    np.testing.assert_array_equal(m1.data, m0.data)
    assert s1["loss"] == s0["loss"]


# ------------------------------------------------------------------ #
# router
# ------------------------------------------------------------------ #
def _rows_of(nrows, per_row, ncols):
    """A CSR of ``nrows`` rows with ``per_row`` entries each (the router
    reads only the counts)."""
    indptr = np.arange(nrows + 1, dtype=np.int64) * per_row
    idx = np.zeros(nrows * per_row, np.int32)
    return (CSR.from_arrays(nrows, ncols, indptr, idx),
            JCSR.from_arrays(nrows, ncols, indptr, idx))


@pytest.mark.parametrize("envs", [{}, {"SLIM_PREDICT_NATIVE_NPAD": "0"},
                                  {"SLIM_PREDICT_NATIVE_NPAD": "512"},
                                  {"SLIM_PREDICT_NATIVE_ALPHA": "0"},
                                  {"SLIM_PREDICT_NATIVE_ALPHA": "0.05"}])
def test_native_predict_applicable_matches_jax(monkeypatch, envs):
    """With the port's cost cap lifted, the JAX package's rule."""
    monkeypatch.setattr(jnative, "available", lambda: True)
    monkeypatch.setattr(P, "HOST_S_PER_UPDATE", 0.0)
    monkeypatch.delenv("SLIM_PREDICT_NATIVE_NPAD")
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    seen = set()
    for n in (100, 1000, 4000, 4097, 9000, 30000, 300000):
        assert P.native_predict_applicable(n) == \
            jpredict.native_predict_applicable(n)
        for h in (1, 20, 150):
            for r in (1, 40, 1300):
                tm, jm = _rows_of(8, r, n)
                th, jh = _rows_of(5, h, n)
                got = P.native_predict_applicable(n, tm, th)
                assert got == jpredict.native_predict_applicable(n, jm, jh), \
                    (n, h, r, envs)
                seen.add(got)
    if envs.get("SLIM_PREDICT_NATIVE_NPAD") != "0":
        assert seen == {True, False}


def test_native_predict_work_counts_score_updates():
    """The score updates of the native loop: every history entry's model
    row nnz, ids outside the model's rows counting none."""
    rng = np.random.default_rng(41)
    model = _port(random_csr(rng, 30, 40, density=0.2))
    hist = _port(random_csr(rng, 12, 40, density=0.3))
    want = sum(int(model.indptr[i + 1] - model.indptr[i])
               for i in hist.indices if i < model.nrows)
    assert P.native_predict_work(model, hist) == want > 0
    # a larger call: counted on a stride of its entries, within 2%
    big = _port(random_csr(rng, 4000, 40, density=0.5))
    rows = np.append(np.diff(model.indptr), np.zeros(10, np.int64))
    exact = int(rows[big.indices].sum())
    got = P.native_predict_work(model, big, sample=2048)
    assert big.nnz > 4 * 2048 and abs(got - exact) <= 0.02 * exact


@pytest.mark.parametrize("at", ["equal", "above"])
def test_cost_cap_decides_the_route(monkeypatch, at):
    """Within the JAX package's rule a call goes native only while its
    score updates take the host no longer than the card's estimated call,
    and predict_topn follows."""
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    rng = np.random.default_rng(42)
    model = _port(random_csr(rng, 60, 60, density=0.2))
    hist = _port(random_csr(rng, 25, 60, density=0.2))
    work = P.native_predict_work(model, hist)
    card_s = P.CARD_S_PER_CALL + 256 * 256 * (
        P.CARD_S_PER_CELL + 25 * P.CARD_S_PER_SCORE)       # npad 256
    per = card_s / work * (1.0 if at == "equal" else 1.01)
    monkeypatch.setattr(P, "HOST_S_PER_UPDATE", per)
    want = at == "equal"
    assert P.native_predict_applicable(60, model, hist) is want
    assert P.native_predict_applicable(60) is True        # no call known
    P.predict_topn(model, hist, nrcmds=4, device="cpu")
    assert P.last_route == ("native" if want else "dense")


@pytest.mark.parametrize("case,users,row,native_", [
    ("ml1m_all_users", 6040, 160, False),
    ("ml1m_few_users", 60, 160, True),
    ("small_catalogue_all_users", 6040, 20, True)])
def test_default_thresholds_route_by_the_call(monkeypatch, case, users, row,
                                              native_):
    """The defaults on a 3,706-item catalogue (the ML-1M shape), every
    history and model row ``row`` entries: a call of all 6,040 users at
    ~25,600 score updates each stays on the card, which the JAX package's
    thresholds alone would send to the host; a few users, or light rows,
    go native."""
    monkeypatch.delenv("SLIM_PREDICT_NATIVE_NPAD")
    monkeypatch.delenv("SLIM_PREDICT_NATIVE_ALPHA", raising=False)
    model, _ = _rows_of(3706, row, 3706)
    hist, _ = _rows_of(users, row, 3706)
    assert P.native_predict_work(model, hist) == users * row * row
    assert P.native_predict_applicable(3706, model, hist) is native_
    assert P.native_predict_applicable(3706) is True


@pytest.fixture
def routed(monkeypatch):
    """Small-catalogue routing on (as outside the test suite), with a spy
    on the native predict; the model and histories."""
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    calls = []
    orig = native.predict_topn
    monkeypatch.setattr(native, "predict_topn",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rng = np.random.default_rng(320)
    model = _port(random_csr(rng, 50, 50, density=0.2))
    hist = _port(random_csr(rng, 20, 50, density=0.25))
    return calls, model, hist


@pytest.mark.parametrize("pin", ["none", "sparse=False", "sparse=True",
                                 "scan", "W_dev"])
def test_predict_topn_routes_unpinned_calls_native(routed, pin):
    calls, model, hist = routed
    kw = {"none": {}, "sparse=False": dict(sparse=False),
          "sparse=True": dict(sparse=True), "scan": dict(scan=True),
          "W_dev": dict(W_dev=P.densify_model(model, device="cpu"))}[pin]
    got = P.predict_topn(model, hist, nrcmds=6, device="cpu", **kw)
    assert bool(calls) == (pin == "none")
    assert P.last_route == {"none": "native", "sparse=True": "rows"}.get(
        pin, "dense")
    ref = P.predict_topn(model, hist, nrcmds=6, device="cpu", sparse=False)
    _check_tie_tolerant(got, ref)


def test_slim_predict_skips_dense_model(routed, tmp_path, monkeypatch):
    """SLIM.predict builds no device model for a call the native route
    serves (a loaded model has no retained pack), and one when the route
    is off; both give the same lists up to tie order."""
    calls, _, hist = routed
    trip = np.stack([np.repeat(np.arange(hist.nrows), np.diff(hist.indptr)),
                     hist.indices, hist.values()], axis=1)
    data = SLIMatrix(trip)
    m = SLIM()
    m.train(SlimConfig(l1r=0.5, l2r=1.0), data, device="cpu")
    m.save_model(str(tmp_path / "m.csr"), str(tmp_path / "m.map"))
    m.load_model(str(tmp_path / "m.csr"), str(tmp_path / "m.map"))
    got = m.predict(data, nrcmds=5, returnscores=True, device="cpu")
    assert calls and m._W_dev is None
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "0")
    calls.clear()
    ref = m.predict(data, nrcmds=5, returnscores=True, device="cpu")
    assert not calls and torch.is_tensor(m._W_dev)
    users = list(data.user2id)
    ids, sc = (np.stack([d[u] for u in users]) for d in got)
    rids, rsc = (np.stack([d[u] for u in users]) for d in ref)
    cnt = (rids >= 0).sum(axis=1)
    _check_tie_tolerant((ids, sc, (ids >= 0).sum(axis=1)), (rids, rsc, cnt))


def test_call_sites_without_a_compiler(monkeypatch, tmp_path):
    """Where no C++ compiler is found the four call sites take their numpy
    / scipy / device paths, with the same results, and the learn's
    assembly (which needs no compiler) equals the native one."""
    trn = tio.read_matrix(os.path.join(DATA, "synth-train.csr"), fmt="csr")
    rng = np.random.default_rng(9)
    frag = [np.array([3, 0, 3], np.int32), np.array([1, 2, 0], np.int32),
            rng.random(3).astype(np.float32)]
    native_ = (trn, compute_gram(trn, "host", device="cpu").numpy(),
               _native_assemble(*[[torch.from_numpy(a)] for a in frag], 5))
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    plain = (tio.read_matrix(os.path.join(DATA, "synth-train.csr"),
                             fmt="csr"),
             compute_gram(trn, "host", device="cpu").numpy(),
             tcd._assemble(*[[torch.from_numpy(a)] for a in frag], 5))
    for a, b in (native_[0], plain[0]), (native_[2], plain[2]):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values(), b.values())
    np.testing.assert_array_equal(native_[1], plain[1])
    assert not P.native_predict_applicable(trn.ncols)
    P.predict_topn(native_[2], _port(random_csr(rng, 4, 5, density=0.5)),
                   nrcmds=2, device="cpu")
    assert P.last_route == "dense"


# ------------------------------------------------------------------ #
# build
# ------------------------------------------------------------------ #
def _code_of(path):
    """A C++ source without its comments and blank lines, each line
    stripped at the right."""
    import re

    with open(path) as fh:
        text = re.sub(r"/\*.*?\*/", "", fh.read(), flags=re.S)
    lines = (re.sub(r"//.*", "", ln).rstrip() for ln in text.splitlines())
    return [ln for ln in lines if ln]


def test_source_code_equals_the_reference():
    """The port's slimrt.cpp is the JAX package's code: they differ only
    in their comments, so neither drifts from the other unseen."""
    ours = _code_of(os.path.join(REPO, "slim_tpu_torch", "native",
                                 "slimrt.cpp"))
    ref = _code_of(os.path.join(REPO, "slim_tpu", "native", "slimrt.cpp"))
    assert len(ours) > 300
    assert ours == ref

_BUILD = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from slim_tpu_torch import native
native.BUILD_DIR = Path({dir!r})
while time.time() < {start}:
    time.sleep(0.001)
tok, lines = native.parse_tokens(b"1 2\\n3")
print(native.library_path().name, tok.tolist(), lines.tolist())
"""


def test_concurrent_builds_load_one_whole_library(tmp_path):
    """Two processes that build into an empty directory at once: one
    builds under the lock, both load a whole library, no file is left
    half written."""
    code = _BUILD.format(repo=REPO, dir=str(tmp_path / "native"),
                         start=time.time() + 4)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert outs[0][0].split(" ", 1)[1].strip() == "[1.0, 2.0, 3.0] [2, 1]"
    files = sorted(f.name for f in (tmp_path / "native").iterdir())
    assert files == sorted(["lock", outs[0][0].split()[0]])


def test_build_failure_raises_and_no_compiler_is_unavailable(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")      # fails, prints nothing
    with pytest.raises(RuntimeError, match="failed to build"):
        native.available()
    assert not any(tmp_path.glob("*.so")) and not any(tmp_path.glob("*.tmp"))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-slimrt")
    assert native.available() is False
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    assert P.native_predict_applicable(100) is False
