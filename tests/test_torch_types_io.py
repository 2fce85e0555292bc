"""The port's host boundary held to the JAX package's own tests of it
(tests/test_types_io.py, tests/test_eval.py): the same numpy arrays (those
``conftest.random_csr`` makes) or the same file bytes go through both
packages, and the port's answer must be the JAX package's.  Also: a file
with a repeated (row, column) entry reads as the JAX package reads it (the
repeats summed), on the reader and through the CLIs, a hypothesis property
over small matrices in every text format, and the array contract of
``CSR.to_scipy`` and ``SLIM.to_csr``."""

import dataclasses
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import slim_tpu.eval as jeval
import slim_tpu.io as jio
from conftest import random_csr
from slim_tpu.cli import slim_learn as jlearn_cli
from slim_tpu.cli import slim_predict as jpredict_cli
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SLIM, SLIMatrix, SlimConfig
from slim_tpu_torch import eval as teval
from slim_tpu_torch import io as tio
from slim_tpu_torch.cli import slim_learn as tlearn_cli
from slim_tpu_torch.cli import slim_predict as tpredict_cli
from slim_tpu_torch.types import CSR


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


def _fresh(j):
    """A JAX CSR on copies of ``j``'s arrays.  The JAX package's
    sort_indices and sum_duplicate_entries run scipy's in-place sort and
    sum on the CSR's own arrays, so each of its calls below gets a fresh
    CSR: the port's result is held to the JAX package's on the matrix as
    it was."""
    return JCSR.from_arrays(j.nrows, j.ncols, j.indptr.copy(),
                            j.indices.copy(),
                            None if j.data is None else j.data.copy())


def _same(t, j):
    """A port CSR equals a JAX CSR: shape, arrays and values, exactly."""
    assert t.shape == j.shape
    assert (t.data is None) == (j.data is None)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.values(), j.values())


# --------------------------------------------------------------------- #
# tests/test_types_io.py, on the port
# --------------------------------------------------------------------- #
def test_csr_roundtrip_scipy(rng):
    jm = random_csr(rng, 20, 15, density=0.3)
    m = _port(jm)
    back = CSR.from_scipy(m.to_scipy())
    assert back == m
    np.testing.assert_array_equal(back.to_dense(),
                                  JCSR.from_scipy(jm.to_scipy()).to_dense())


def test_transpose_is_sorted(rng):
    jm = random_csr(rng, 30, 25, density=0.2)
    t = _port(jm).transpose()
    assert t.shape == (25, 30)
    for c in range(25):
        idx = t.indices[t.indptr[c]:t.indptr[c + 1]]
        assert np.all(np.diff(idx) > 0), "row ids within a column sorted"
    _same(t, jm.transpose())
    np.testing.assert_array_equal(t.transpose().to_dense(), jm.to_dense())


def test_column_norms(rng):
    jm = random_csr(rng, 12, 9, density=0.4)
    got = _port(jm).column_norms()
    np.testing.assert_array_equal(got, jm.column_norms())
    np.testing.assert_allclose(
        got, np.linalg.norm(jm.to_dense().astype(np.float64), axis=0),
        rtol=1e-5)


def test_implicit_values():
    args = ([0, 0, 1], [0, 2, 1], [5.0, 3.0, 2.0], 2, 3)
    m = CSR.from_ijv(*args).binarize()
    assert m.data is None
    np.testing.assert_array_equal(m.values(), [1, 1, 1])
    np.testing.assert_array_equal(m.to_dense(), [[1, 0, 1], [0, 1, 0]])
    _same(m, JCSR.from_ijv(*args).binarize())


def test_padded_rows(rng):
    jm = random_csr(rng, 8, 10, density=0.35)
    idx, val = _port(jm).padded_rows()
    jidx, jval = jm.padded_rows()
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    dense = np.zeros((8, 10), np.float32)
    r, k = np.nonzero(idx >= 0)
    dense[r, idx[r, k]] = val[r, k]
    np.testing.assert_array_equal(dense, jm.to_dense())


def test_infer_ncols():
    m = CSR.from_ijv([0, 1], [4, 7], [1.0, 1.0], nrows=2, ncols=0)
    assert m.infer_ncols().ncols == 8
    assert m.infer_ncols().shape == JCSR.from_ijv(
        [0, 1], [4, 7], [1.0, 1.0], nrows=2, ncols=0).infer_ncols().shape


@pytest.mark.parametrize("fmt", ["csr", "csrnv", "cluto", "ijv", "binrow"])
def test_format_round_trip_as_jax(tmp_path, rng, fmt):
    """test_format_roundtrip, test_csrnv_roundtrip and test_binrow_exact:
    a random_csr matrix written in each format by both packages gives
    the same bytes, and reads back to the JAX package's matrix (binrow
    to the very matrix written)."""
    jm = random_csr(rng, 15, 12, density=0.3, implicit=fmt == "csrnv")
    m = _port(jm)
    pt, pj = tmp_path / f"t.{fmt}", tmp_path / f"j.{fmt}"
    tio.write_matrix(m, str(pt), fmt=fmt)
    jio.write_matrix(jm, str(pj), fmt=fmt)
    assert pt.read_bytes() == pj.read_bytes()
    back = tio.read_matrix(str(pt), fmt=fmt)
    _same(back, jio.read_matrix(str(pj), fmt=fmt))
    assert back.nrows == m.nrows
    np.testing.assert_allclose(back.to_dense()[:, :m.ncols],
                               m.to_dense()[:, :back.ncols], rtol=1e-4)
    if fmt == "binrow":
        assert back == m
    if fmt == "csrnv":
        assert back.data is None


# the JAX package's test_duplicate_entries_sum_on_read, in every format
# that reads through sum_duplicate_entries and at both numberings: row 0
# holds id 3 twice (1.0 + 2.0) and id 5, row 1 holds id 0
_DUP_ROWS = [[(3, 1.0), (3, 2.0), (5, 1.0)], [(0, 4.0)]]
_DUP_IMPLICIT = [[2, 2, 7]]


def _dup_file(tmp_path, fmt, numbering):
    """(path, implicit) of a file with a repeated id in a row: the bytes
    by hand in the text formats, the JAX package's writer of a CSR that
    holds the repeat for binrow."""
    path = tmp_path / f"dup.{fmt}"
    if fmt == "binrow":
        jm = JCSR.from_arrays(2, 6, [0, 3, 4], [3, 3, 5, 0],
                              [1.0, 2.0, 1.0, 4.0])
        jio.write_binrow(jm, str(path))
        return path, False
    if fmt == "csrnv":
        path.write_text(" ".join(str(c + numbering)
                                 for c in _DUP_IMPLICIT[0]) + "\n")
        return path, True
    base = 1 if fmt == "cluto" else numbering
    rows = [" ".join(f"{c + base} {v}" for c, v in r) for r in _DUP_ROWS]
    if fmt == "ijv":
        rows = [f"{u + numbering} {c + numbering} {v}"
                for u, r in enumerate(_DUP_ROWS) for c, v in r]
    text = "\n".join(rows) + "\n"
    if fmt == "cluto":
        text = f"2 6 4\n{text}"
    path.write_text(text)
    return path, False


@pytest.mark.parametrize("fmt,numbering", [
    ("csr", 0), ("csr", 1), ("csrnv", 0), ("csrnv", 1), ("cluto", 1),
    ("binrow", 0), ("ijv", 0), ("ijv", 1)])
def test_duplicate_entries_sum_on_read(tmp_path, fmt, numbering):
    """A file with a repeated (row, column) entry reads to the sum of the
    repeats, as in the JAX package (the reference's += loops accumulate
    them; the device kernels assume unique coordinates), the very
    matrix the JAX package reads from the same bytes; an implicit repeat
    carries its multiplicity, 2.0."""
    path, implicit = _dup_file(tmp_path, fmt, numbering)
    kw = {} if fmt in ("cluto", "binrow") else dict(numbering=numbering)
    m = tio.read_matrix(str(path), fmt=fmt, **kw)
    _same(m, jio.read_matrix(str(path), fmt=fmt, **kw))
    d = m.to_dense()
    if implicit:
        assert m.nnz == 2 and d[0, 2] == 2.0 and d[0, 7] == 1.0
    else:
        assert m.nnz == 3
        assert d[0, 3] == 3.0 and d[0, 5] == 1.0 and d[1, 0] == 4.0
    assert not m.indices.flags.writeable


# --------------------------------------------------------------------- #
# the canonical forms and the array contract
# --------------------------------------------------------------------- #
_RAW = dict(nrows=3, ncols=6, indptr=[0, 4, 4, 7],
            indices=[5, 1, 5, 0, 2, 4, 2], data=[1.0, 2.0, 3.0, 4.0, 5.0,
                                                 6.0, 7.0])


@pytest.mark.parametrize("implicit", [False, True])
def test_canonical_forms_equal_jax_on_views(implicit):
    """sort_indices and sum_duplicate_entries of an unsorted CSR with
    repeats (its arrays read-only views) give the JAX package's indptr,
    indices and values; to_scipy() takes scipy's in-place methods; the
    CSR's own arrays are untouched."""
    data = None if implicit else _RAW["data"]
    args = (_RAW["nrows"], _RAW["ncols"], _RAW["indptr"], _RAW["indices"],
            data)
    m, jm = CSR.from_arrays(*args), JCSR.from_arrays(*args)
    before = [a.copy() for a in (m.indptr, m.indices, m.values())]
    _same(m.sort_indices(), _fresh(jm).sort_indices())
    summed = m.sum_duplicate_entries()
    _same(summed, _fresh(jm).sum_duplicate_entries())
    assert summed.nnz == 5 and summed.to_dense()[0, 5] == (
        2.0 if implicit else 4.0)
    s = m.to_scipy()
    assert s.sum() == _fresh(jm).to_scipy().sum()
    s.sum_duplicates()
    s.eliminate_zeros()
    s.data *= 2
    for a, b in zip((m.indptr, m.indices, m.values()), before):
        np.testing.assert_array_equal(a, b)
    assert not m.indptr.flags.writeable and not m.indices.flags.writeable


def test_sum_duplicate_entries_keeps_its_fast_path():
    """A matrix without a repeat comes back as itself, no copy, sorted or
    not; to_scipy() hands out copies of its read-only arrays."""
    m = CSR.from_arrays(2, 4, [0, 2, 3], [3, 1, 0], [1.0, 2.0, 3.0])
    assert m.sum_duplicate_entries() is m
    assert not np.shares_memory(m.to_scipy().indices, m.indices)


def test_slim_to_csr_is_the_callers():
    """SLIM.to_csr() returns writable arrays that share no memory with
    the model, whose own arrays stay read-only; in-place scipy methods
    work on it and leave the model as it was."""
    rng = np.random.default_rng(3)
    trn = SLIMatrix(_port(random_csr(rng, 40, 20, density=0.3)))
    model = SLIM()
    model.train(SlimConfig(l1r=0.5, l2r=0.5), trn, device="cpu")
    before = model.model.to_dense()
    csr = model.to_csr()
    for mine, theirs in ((csr.indptr, model.model.indptr),
                         (csr.indices, model.model.indices),
                         (csr.data, model.model.data)):
        assert mine.flags.writeable and not theirs.flags.writeable
        assert not np.shares_memory(mine, theirs)
    np.testing.assert_array_equal(csr.toarray(), before)
    csr.data *= 2
    csr.data[0] = 0.0
    csr.eliminate_zeros()
    csr.sum_duplicates()
    np.testing.assert_array_equal(model.model.to_dense(), before)


# --------------------------------------------------------------------- #
# tests/test_eval.py, on the port
# --------------------------------------------------------------------- #
def _eval_both(topn, counts, test, fmarker_of, train, **kw):
    """(port EvalResult, JAX EvalResult) on the same arrays."""
    rt = teval.evaluate_topn(topn, counts, _port(test),
                             teval.determine_head_tail(_port(train),
                                                       *fmarker_of), **kw)
    rj = jeval.evaluate_topn(topn, counts, test,
                             jeval.determine_head_tail(train, *fmarker_of),
                             **kw)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    return rt


@pytest.mark.parametrize("req", [False, True])
def test_vectorised_eval_as_jax(req):
    """test_vectorised_matches_loop_oracle's data (80 users, 40 items,
    failed predictions and short lists) under both conventions."""
    rng = np.random.default_rng(17)
    nusers, nitems, N = 80, 40, 10
    train_mask = rng.random((nusers, nitems)) < 0.2
    rows, cols = np.nonzero(train_mask)
    train = JCSR.from_ijv(rows, cols, np.ones(len(rows)), nusers, nitems)
    test_mask = (rng.random((nusers, nitems)) < 0.08) & ~train_mask
    trows, tcols = np.nonzero(test_mask)
    test = JCSR.from_ijv(trows, tcols, np.ones(len(trows)), nusers, nitems)
    topn = rng.integers(0, nitems, size=(nusers, N)).astype(np.int32)
    counts = rng.integers(0, N + 1, size=nusers).astype(np.int32)
    counts[::13] = -1
    topn[np.arange(N)[None, :] >= counts[:, None]] = -1
    res = _eval_both(topn, counts, test, (), train, require_test_items=req)
    assert res.nvalid > 0


@pytest.mark.parametrize("case", ["split", "one_item"])
def test_head_tail_as_jax(case):
    """test_head_tail_split (items 0-1 head, 2-3 tail of nnz 10) and
    test_head_tail_all_head_when_one_item."""
    if case == "split":
        args = ([0, 1, 2, 3, 0, 1, 2, 0, 1, 0],
                [0, 0, 0, 0, 1, 1, 1, 2, 2, 3], np.ones(10), 4, 4)
        want = [0, 0, 1, 1]
    else:
        args, want = ([0, 1], [0, 0], [1, 1], 2, 1), [0]
    got = teval.determine_head_tail(CSR.from_ijv(*args))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jeval.determine_head_tail(JCSR.from_ijv(*args)))


@pytest.mark.parametrize("case", ["hand_computed", "invalid_and_empty"])
def test_evaluate_cases_as_jax(case):
    """test_evaluate_hand_computed and
    test_evaluate_invalid_and_empty_users: their hand-computed values,
    and the JAX package's EvalResult field for field."""
    if case == "hand_computed":
        train = JCSR.from_ijv([0, 0, 0, 1, 1, 1, 0, 1],
                              [0, 1, 2, 0, 1, 3, 3, 2], np.ones(8), 2, 4)
        test = JCSR.from_ijv([0, 0, 1], [1, 3, 2], np.ones(3), 2, 4)
        topn = np.array([[1, 2], [0, 2]], np.int32)
        counts = np.array([2, 2], np.int32)
        res = _eval_both(topn, counts, test, (), train)
        assert res.nvalid == 2
        np.testing.assert_allclose(res.hr, (0.5 + 1.0) / 2)
        np.testing.assert_allclose(res.arhr, (2 / 3 + 1 / 2) / 2)
        assert res.nvalid_head == 1 and res.nvalid_tail == 2
        np.testing.assert_allclose(res.hr_head, 1.0)
        np.testing.assert_allclose(res.hr_tail, 0.5)
    else:
        train = JCSR.from_ijv([0, 1, 2], [0, 1, 0], np.ones(3), 3, 2)
        test = JCSR.from_ijv([0, 2], [1, 0], np.ones(2), 3, 2)
        topn = np.array([[1, -1], [0, -1], [-1, -1]], np.int32)
        counts = np.array([1, 1, -1], np.int32)
        res = _eval_both(topn, counts, test, (), train)
        assert res.nvalid == 2
        np.testing.assert_allclose(res.hr, 0.5)
        res2 = _eval_both(topn, counts, test, (), train,
                          require_test_items=True)
        assert res2.nvalid == 1
        np.testing.assert_allclose(res2.hr, 1.0)


# --------------------------------------------------------------------- #
# a property over small matrices: both packages read the same bytes alike
# --------------------------------------------------------------------- #
_rows = st.lists(st.lists(st.tuples(st.integers(0, 5),
                                    st.sampled_from([1.0, 2.0, 0.5, 3.25])),
                          max_size=6), max_size=6)


def _text(rows, fmt, numbering, trailing):
    """The bytes of ``rows`` (lists of (id, value), repeats and order as
    drawn) in a text format."""
    base = 1 if fmt == "cluto" else numbering
    if fmt == "ijv":
        lines = [f"{u + numbering} {c + numbering} {v:g}"
                 for u, r in enumerate(rows) for c, v in r]
    elif fmt == "csrnv":
        lines = [" ".join(str(c + base) for c, _ in r) for r in rows]
    else:
        lines = [" ".join(f"{c + base} {v:g}" for c, v in r) for r in rows]
    text = "\n".join(lines) + ("\n" if trailing and lines else "")
    if fmt == "cluto":
        ncols = max((c + 1 for r in rows for c, _ in r), default=0)
        text = f"{len(rows)} {ncols} {sum(map(len, rows))}\n" + text
    return text.encode()


def _read_both(path, fmt, numbering):
    """(port CSR or exception type, JAX CSR or exception type)."""
    kw = {} if fmt == "cluto" else dict(numbering=numbering)
    out = []
    for io in (tio, jio):
        try:
            out.append(io.read_matrix(str(path), fmt=fmt, **kw))
        except Exception as e:      # the type is compared, not hidden
            out.append(type(e))
    return out


def _agree(t, j):
    """Every host transform of a CSR agrees between the packages (each
    JAX call on a fresh copy of ``j``), and leaves the port's CSR as it
    was."""
    _same(t, j)
    before = _fresh(j)
    _same(t.sort_indices(), _fresh(j).sort_indices())
    _same(t.sum_duplicate_entries(), _fresh(j).sum_duplicate_entries())
    _same(t.transpose(), _fresh(j).transpose())
    np.testing.assert_array_equal(t.column_norms(), _fresh(j).column_norms())
    assert t.infer_ncols().shape == _fresh(j).infer_ncols().shape
    assert t.to_scipy().sum() == _fresh(j).to_scipy().sum()
    _same(t, before)


@settings(derandomize=True, database=None, deadline=None, max_examples=40)
@given(rows=_rows, numbering=st.sampled_from([0, 1]),
       read_numbering=st.sampled_from([0, 1]), trailing=st.booleans())
def test_small_files_read_alike(tmp_path_factory, rows, numbering,
                                read_numbering, trailing):
    """Random small matrices (0-6 rows and ids, rows empty, unsorted or
    with a repeated id, with or without a trailing newline) in csr,
    csrnv, cluto and ijv bytes, read at either numbering: both packages
    read them to the same matrix or raise the same exception type; the
    transforms of the matrices read agree, as do those of the CSR built
    from the drawn arrays as they stand; writing back in each format
    gives the same bytes."""
    d = tmp_path_factory.mktemp("prop")
    for fmt in ("csr", "csrnv", "cluto", "ijv"):
        path = d / f"m.{fmt}"
        path.write_bytes(_text(rows, fmt, numbering, trailing))
        t, j = _read_both(path, fmt, read_numbering)
        if isinstance(t, type) or isinstance(j, type):
            assert t == j, (fmt, t, j)
            continue
        _agree(t, j)
        for wfmt in ("csr", "csrnv", "cluto", "ijv", "binrow"):
            pt, pj = d / f"t.{wfmt}", d / f"j.{wfmt}"
            tio.write_matrix(t, str(pt), fmt=wfmt)
            jio.write_matrix(j, str(pj), fmt=wfmt)
            assert pt.read_bytes() == pj.read_bytes(), (fmt, wfmt)
    # the drawn arrays as they stand: unsorted, repeats kept
    indptr = np.cumsum([0] + [len(r) for r in rows])
    ids = [c for r in rows for c, _ in r]
    vals = [v for r in rows for _, v in r]
    ncols = max(ids, default=-1) + 1
    for data in (vals, None):
        _agree(CSR.from_arrays(len(rows), ncols, indptr, ids, data),
               JCSR.from_arrays(len(rows), ncols, indptr, ids, data))


# --------------------------------------------------------------------- #
# the CLIs on a file with repeated events, both packages, on the CPU
# --------------------------------------------------------------------- #
def _repeats_files(tmp_path):
    """A 200-user csr training file where every 7th user repeats one of
    its events (at the row's end, so the row is unsorted), and a test file
    of held-out items."""
    rng = np.random.default_rng(21)
    trn = random_csr(rng, 200, 60, density=0.12)
    tst = random_csr(rng, 200, 60, density=0.03)
    tst = JCSR.from_scipy(sp.csr_matrix(
        tst.to_dense() * (trn.to_dense() == 0)))
    lines = []
    for u in range(trn.nrows):
        s, e = trn.indptr[u], trn.indptr[u + 1]
        pairs = [f"{c} {v:g}" for c, v in zip(trn.indices[s:e], trn.data[s:e])]
        if u % 7 == 0 and pairs:
            pairs.append(pairs[rng.integers(len(pairs))])
        lines.append(" ".join(pairs))
    trn_f, tst_f = tmp_path / "trn.csr", tmp_path / "tst.csr"
    trn_f.write_text("\n".join(lines) + "\n")
    jio.write_matrix(tst, str(tst_f), fmt="csr")
    return str(trn_f), str(tst_f)


def _learn_line(out):
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)", out).groups()
    return int(nnz), float(loss)


def _eval_line(out):
    hr, arhr = re.search(r"hr: (\S+) hr_head: \S+ hr_tail: \S+ arhr: (\S+)",
                         out).groups()
    return float(hr), float(arhr)


def test_cli_learns_a_file_with_repeated_events(tmp_path, capsys):
    """slim_learn and slim_predict of both packages on the same csr file
    with repeated events: objectives within rtol 1e-4, model nnz within
    1%, HR within 0.015 and ARHR within 0.010 (the goldens' tolerances)."""
    trn_f, tst_f = _repeats_files(tmp_path)
    got = {}
    for tag, learn_cli, predict_cli, extra in (
            ("port", tlearn_cli, tpredict_cli, ["-device=cpu"]),
            ("jax", jlearn_cli, jpredict_cli, [])):
        mdl = str(tmp_path / f"{tag}.model")
        assert learn_cli.main(["-l1r=0.5", "-l2r=0.5", *extra,
                               trn_f, mdl]) == 0
        learned = _learn_line(capsys.readouterr().out)
        assert predict_cli.main([*extra, mdl, trn_f, tst_f]) == 0
        got[tag] = learned + _eval_line(capsys.readouterr().out)
    (t_nnz, t_loss, t_hr, t_arhr), (j_nnz, j_loss, j_hr, j_arhr) = \
        got["port"], got["jax"]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert abs(t_nnz - j_nnz) <= 0.01 * j_nnz
    assert abs(t_hr - j_hr) < 0.015 and abs(t_arhr - j_arhr) < 0.010
    assert t_nnz > 0 and t_hr > 0
