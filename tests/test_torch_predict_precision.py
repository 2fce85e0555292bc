"""The dense route's scoring precision in the PyTorch port: the JAX
package's ``predict_topn(precision=)`` names, its npad rule (with "high"
where the JAX package takes "default"), the pin off the native route, and
each precision's scores against the JAX package ("highest") or an f64
oracle ("high" within 2^-16 rel, "default" within 2^-7), on the CPU."""

import numpy as np
import pytest
import jax
import torch

from conftest import random_csr
from slim_tpu.predict import predict_topn as jax_predict
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import predict as P
from slim_tpu_torch.checks import ranked_mismatches
from slim_tpu_torch.ops.densify import densify_meta, densify_plain
from slim_tpu_torch.types import CSR

HIGH_RTOL = 2.0 ** -16
DEFAULT_RTOL = 2.0 ** -7
N, NUSERS, K = 300, 80, 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it (the
    suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def _model(seed=5):
    """A non-negative random item-item model with float weights (bfloat16
    rounds almost every one), zero diagonal."""
    rng = np.random.default_rng(seed)
    W = np.where(rng.random((N, N)) < 0.06, rng.random((N, N)) + 0.01, 0.0)
    np.fill_diagonal(W, 0.0)
    r, c = np.nonzero(W)
    return JCSR.from_ijv(r, c, W[r, c].astype(np.float32), nrows=N, ncols=N)


HISTORIES = ("binary", "ratings", "fractional", "duplicates")


def _hist(kind, seed=6):
    """Histories: binary (implicit), integer ratings 1-5 (exact in
    bfloat16), fractional ratings (not), and integer ratings whose rows
    repeat ids (a CSR as read, before any canonical form)."""
    rng = np.random.default_rng(seed)
    m = random_csr(rng, NUSERS, N, density=0.06, implicit=kind == "binary")
    if kind == "binary":
        return m.binarize()
    if kind == "fractional":
        return JCSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices,
                                m.data + np.float32(0.3))
    if kind == "duplicates":
        # every row's first id once more, with its own rating
        starts = m.indptr[:-1][np.diff(m.indptr) > 0]
        rows = np.repeat(np.arange(m.nrows), np.diff(m.indptr))
        idx = np.insert(m.indices, starts, m.indices[starts])
        val = np.insert(m.data, starts, rng.integers(1, 6, starts.size)
                        .astype(np.float32))
        rows = np.insert(rows, starts, rows[starts])
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows, minlength=m.nrows))])
        return JCSR.from_arrays(m.nrows, m.ncols, indptr, idx, val)
    return m


def _oracle(model, hist):
    """f64 scores (users, N) with the history excluded (-inf)."""
    W = np.zeros((N, N))
    r = np.repeat(np.arange(model.nrows), np.diff(model.indptr))
    np.add.at(W, (r, model.indices), model.values())
    H = np.zeros((hist.nrows, N))
    u = np.repeat(np.arange(hist.nrows), np.diff(hist.indptr))
    np.add.at(H, (u, hist.indices), hist.values())
    S = H @ W
    S[H != 0] = -np.inf
    return S


@pytest.mark.parametrize("npad,precision,want", [
    (8192, None, "highest"), (4096, None, "highest"), (8193, None, "high"),
    (28672, None, "high"), (1 << 20, None, "high"),
    (64, "default", "default"), (28672, "HIGHEST", "highest"),
    (64, "High", "high"), (28672, "Default", "default"),
    (64, jax.lax.Precision.HIGH, "high"),
    (28672, jax.lax.Precision.HIGHEST, "highest"),
    (28672, jax.lax.Precision.DEFAULT, "default")])
def test_score_precision_rule(npad, precision, want):
    """"highest" up to npad 8192 and "high" above it; an explicit name (any
    case, or jax.lax.Precision's member) passes through."""
    assert P._score_precision(npad, precision) == want


@pytest.mark.parametrize("bad", ["fast", "bf16", "", 3, 1.0])
def test_bad_precision_raises(bad):
    with pytest.raises(ValueError, match="precision"):
        P._score_precision(64, bad)
    with pytest.raises(ValueError, match="precision"):
        P.predict_topn(_port(_model()), _port(_hist("binary")),
                       precision=bad, device="cpu")


@pytest.mark.parametrize("precision", ["default", "high", "highest",
                                       jax.lax.Precision.HIGHEST])
def test_precision_pins_the_device_route(monkeypatch, precision):
    """A catalogue the native rule takes (npad 384 <= 4096) goes native
    when nothing is pinned; passing ``precision`` keeps it on the device."""
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    model, hist = _port(_model()), _port(_hist("binary"))
    P.predict_topn(model, hist, nrcmds=K, device="cpu")
    assert P.last_route == "native"
    P.predict_topn(model, hist, nrcmds=K, precision=precision, device="cpu")
    assert P.last_route == "dense"


@pytest.mark.parametrize("kind", HISTORIES)
def test_highest_matches_jax(kind):
    """"highest" against the JAX package's HIGHEST scan: ids equal but at
    near ties, counts equal, scores within 1e-6 rel."""
    model, hist = _model(), _hist(kind)
    ji, js, jc = jax_predict(model, hist, nrcmds=K, scan=True,
                             precision=jax.lax.Precision.HIGHEST)
    ti, ts, tc = P.predict_topn(_port(model), _port(hist), nrcmds=K,
                                precision="highest", device="cpu")
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    assert ranked_mismatches(ti, ts, ji, js, jc)[1] == 0


@pytest.mark.parametrize("precision,rtol", [("high", HIGH_RTOL),
                                            ("default", DEFAULT_RTOL)])
@pytest.mark.parametrize("kind", HISTORIES)
def test_bf16_precisions_match_f64_oracle(kind, precision, rtol):
    """"high" (the split product) within 2^-16 rel of an f64 oracle and
    "default" (one bfloat16 pass) within 2^-7: each listed id's score
    against its oracle score, the counts against the oracle's, and the
    list's scores against the oracle's top scores in order."""
    model, hist = _model(), _hist(kind)
    ids, sc, cnt = P.predict_topn(_port(model), _port(hist), nrcmds=K,
                                  precision=precision, device="cpu")
    assert P.last_route == "dense"
    S = _oracle(model, hist)
    np.testing.assert_array_equal(cnt, np.minimum((S > 0).sum(1), K))
    ok = ids >= 0
    ref = np.take_along_axis(S, np.maximum(ids, 0), 1)
    assert np.all(np.abs(sc[ok] - ref[ok]) <= rtol * ref[ok])
    top = -np.sort(-S, axis=1)[:, :K]
    assert np.all(np.abs(sc[ok] - top[ok]) <= rtol * top[ok])


@pytest.mark.parametrize("kind", HISTORIES)
def test_unpinned_call_above_the_rule_scores_high(monkeypatch, kind):
    """With the rule's npad lowered below this catalogue's, a call that
    names no precision scores exactly as "high", which differs from
    "highest" in the low bits of the scores."""
    model, hist = _port(_model()), _port(_hist(kind))
    want = P.predict_topn(model, hist, nrcmds=K, precision="high",
                          device="cpu")
    f32 = P.predict_topn(model, hist, nrcmds=K, precision="highest",
                         device="cpu")
    monkeypatch.setattr(P, "_BF16_SCORE_NPAD", 64)
    got = P.predict_topn(model, hist, nrcmds=K, sparse=False, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[1], f32[1])


def _candidates(seed=8, C=30):
    return np.random.default_rng(seed).integers(-1, N, (NUSERS, C)) \
        .astype(np.int32)


@pytest.fixture
def rule_says_high(monkeypatch):
    """The npad rule lowered so that every catalogue here scores "high"
    unless the call fixes its precision."""
    monkeypatch.setattr(P, "_BF16_SCORE_NPAD", 0)


@pytest.mark.parametrize("fn", ["1vsk", "cand"])
def test_candidate_scoring_stays_highest(rule_says_high, fn):
    """predict_topn_1vsk and predict_candidate_scores ignore the rule and
    score at "highest" (the JAX package's HIGHEST there): their results
    equal those with the rule at its default, bit for bit."""
    model, hist = _port(_model()), _port(_hist("fractional"))
    cand = _candidates()

    def run():
        if fn == "1vsk":
            return P.predict_topn_1vsk(model, hist, cand, nrcmds=K,
                                       sparse=False, device="cpu")
        return P.predict_candidate_scores(model, hist, cand, sparse=False,
                                          device="cpu")

    got = run()
    high = P.predict_topn(model, hist, nrcmds=K, sparse=False, device="cpu")
    P._BF16_SCORE_NPAD = 8192
    want = run()
    f32 = P.predict_topn(model, hist, nrcmds=K, sparse=False, device="cpu")
    assert not np.array_equal(high[1], f32[1])      # the rule did bite
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo world of this process on the CPU, torn down after
    the module."""
    import torch.distributed as dist

    from slim_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_sharded_predict_stays_highest(rule_says_high, one_rank_mesh):
    """sharded_predict scores at "highest" whatever the rule says (the JAX
    package's sharded predict is HIGHEST): its lists equal the
    single-device "highest" call's."""
    from slim_tpu_torch.parallel.dist import sharded_predict

    model, hist = _port(_model()), _port(_hist("fractional"))
    got = sharded_predict(model, hist, one_rank_mesh, nrcmds=K,
                          sparse=False)
    want = P.predict_topn(model, hist, nrcmds=K, precision="highest",
                          device="cpu")
    high = P.predict_topn(model, hist, nrcmds=K, device="cpu")
    assert not np.array_equal(high[1], want[1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("valued", [False, True])
def test_densify_plain_bf16_exact_on_integer_sums(valued):
    """densify_plain into a bfloat16 block equals its float32 block on
    integer values 1-5 with duplicate ids (sums far below 256)."""
    rng = np.random.default_rng(9)
    npad, W, R = 512, 24, 300
    ids = rng.integers(-1, npad + 2, (W, R)).astype(np.int32)
    ids[1, ::3] = ids[0, ::3]                       # duplicates
    idsT = torch.from_numpy(ids)
    valsT = torch.from_numpy(rng.integers(1, 6, (W, R)).astype(
        np.float32)) if valued else None
    wmax = densify_meta(idsT, npad)
    f32 = densify_plain(idsT, valsT, wmax, npad, torch.zeros((npad, R)))
    bf = densify_plain(idsT, valsT, wmax, npad,
                       torch.zeros((npad, R), dtype=torch.bfloat16))
    assert bf.dtype == torch.bfloat16 and f32.max() > 1
    assert torch.equal(bf.float(), f32)


@pytest.mark.parametrize("kind,want", [("binary", True), ("ratings", True),
                                       ("fractional", False),
                                       ("duplicates", True)])
def test_bf16_exact_histories(kind, want):
    """Which histories densify straight into bfloat16: exact values whose
    duplicate sums stay exact."""
    assert P.bf16_exact(_port(_hist(kind))) is want


def test_bf16_exact_refuses_large_duplicate_sums():
    """A row that repeats one id 300 times sums past bfloat16's exact
    integers; the same ids once each are exact."""
    idx = np.zeros(300, np.int32)
    h = CSR.from_arrays(1, 4, np.array([0, 300]), idx, None)
    assert not P.bf16_exact(h)
    h1 = CSR.from_arrays(1, 400, np.array([0, 300]),
                         np.arange(300, dtype=np.int32), None)
    assert P.bf16_exact(h1)
