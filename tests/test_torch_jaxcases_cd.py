"""The JAX package's own CD solver cases (tests/test_cd.py and
tests/test_compact.py) run on the port, on the CPU (``device="cpu"``).

Each case builds its input as the JAX test does (numpy, ``random_csr``),
runs the port's solver on it and asserts what the JAX test asserts, with
the JAX test's tolerances.  Where the JAX test compares the solver with a
number (the float64 oracle, a norm of the data), the port's objective and
model nnz are also held to ``slim_tpu``'s ``estimate_model_cd`` on JAX-CPU
on the same matrix, at the goldens' tolerances (objective rtol 1e-4, nnz
within 1% or 2 entries).  Cases of those files that test the JAX
package's TPU dispatch (the executable cache, the variant retry) have no
counterpart in the port and are not here."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.api import get_topn, learn
from slim_tpu_torch.ops.cd_kernel import count_over, fslim_active_mask
from slim_tpu_torch.ops.pack import pack
from slim_tpu_torch.predict import DeviceModelPack, densify_model
from slim_tpu_torch.solvers.cd import estimate_model_cd
from slim_tpu_torch.types import CSR

from test_cd import oracle_column, oracle_objective


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


def _cd(mat, cfg, **kw):
    return estimate_model_cd(_port(mat), cfg, device="cpu", **kw)


def _held_to_jax(mat, cfg, stats, **kw):
    """The port's objective and nnz against the JAX package's learn of the
    same matrix and settings (JAX-CPU)."""
    _, ref = jax_cd(mat, JaxConfig(**vars(cfg)), **kw)
    np.testing.assert_allclose(stats["loss"], ref["loss"], rtol=1e-4)
    assert abs(stats["nnz"] - ref["nnz"]) <= max(2, 0.01 * ref["nnz"])


def _dense(model):
    return model.to_scipy().toarray()


# --------------------------------------------------------------------- #
# tests/test_cd.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("l1r,l2r", [(0.5, 0.5), (1.0, 1.0), (0.1, 2.0)])
def test_cd_matches_oracle_small(l1r, l2r):
    rng = np.random.default_rng(42)
    A_dense = (rng.random((30, 12)) < 0.4).astype(np.float32) * \
        rng.integers(1, 4, (30, 12)).astype(np.float32)
    mat = JCSR.from_scipy(sp.csr_matrix(A_dense))
    cfg = SlimConfig(l1r=l1r, l2r=l2r, optTol=1e-12, block_size=4,
                     shuffle=False)
    model, stats = _cd(mat, cfg)
    W = _dense(model)
    for j in range(12):
        x_ref = oracle_column(A_dense, j, l1r, l2r)
        np.testing.assert_allclose(W[:, j], x_ref, atol=2e-4,
                                   err_msg=f"column {j}")
        obj_ours = oracle_objective(A_dense, W[:, j].astype(np.float64), j,
                                    l1r, l2r)
        obj_ref = oracle_objective(A_dense, x_ref, j, l1r, l2r)
        assert obj_ours <= obj_ref * (1 + 1e-4) + 1e-6
    _held_to_jax(mat, cfg, stats)


def test_cd_shuffled_same_optimum():
    rng = np.random.default_rng(7)
    mat = random_csr(rng, 40, 16, density=0.35)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, optTol=1e-12, block_size=8)
    m_shuf, _ = _cd(mat, cfg.replace(shuffle=True))
    m_cyc, _ = _cd(mat, cfg.replace(shuffle=False))
    np.testing.assert_allclose(_dense(m_shuf), _dense(m_cyc), atol=5e-4)


def test_cd_zero_diagonal_and_nonneg():
    rng = np.random.default_rng(3)
    mat = random_csr(rng, 50, 20, density=0.3)
    model, _ = _cd(mat, SlimConfig(l1r=0.2, l2r=0.5))
    W = _dense(model)
    assert np.all(np.diag(W) == 0), "zero-diagonal constraint violated"
    assert np.all(W >= 0), "nonnegativity violated"
    assert model.nnz > 0


def test_cd_implicit_data():
    rng = np.random.default_rng(11)
    mat = random_csr(rng, 40, 15, density=0.3, implicit=True)
    ones = JCSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                            np.ones(mat.nnz, np.float32))
    cfg = SlimConfig(l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)
    m_imp, _ = _cd(mat, cfg)
    m_one, _ = _cd(ones, cfg)
    np.testing.assert_allclose(_dense(m_imp), _dense(m_one), atol=1e-5)


def test_cd_warm_start_same_optimum_fewer_iters():
    rng = np.random.default_rng(5)
    mat = random_csr(rng, 60, 24, density=0.3)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, optTol=1e-12, shuffle=False)
    cold, stats_cold = _cd(mat, cfg)
    warm, stats_warm = _cd(mat, cfg, imodel=cold)
    np.testing.assert_allclose(_dense(cold), _dense(warm), atol=5e-4)
    assert stats_warm["niters"] <= stats_cold["niters"]


def test_cd_large_l1_empty_model():
    rng = np.random.default_rng(9)
    mat = random_csr(rng, 30, 10, density=0.3)
    cfg = SlimConfig(l1r=1e9, l2r=1.0)
    model, stats = _cd(mat, cfg)
    assert model.nnz == 0
    cn = mat.column_norms().astype(np.float64)
    np.testing.assert_allclose(stats["fit"], 0.5 * np.sum(cn ** 2), rtol=1e-5)
    _held_to_jax(mat, cfg, stats)


def test_fslim_restricts_support():
    rng = np.random.default_rng(13)
    mat = random_csr(rng, 50, 20, density=0.4)
    nnbrs = 3
    cfg = SlimConfig(l1r=0.1, l2r=0.5, nnbrs=nnbrs, simtype="cos",
                     optTol=1e-12, shuffle=False)
    assert cfg.mtype == "fslim"
    model, stats = _cd(mat, cfg)
    W = _dense(model)
    assert np.all((W > 0).sum(axis=0) <= nnbrs)
    A = mat.to_dense().astype(np.float64)
    G = A.T @ A
    cn = np.sqrt(np.diag(G))
    for j in range(20):
        support = np.nonzero(W[:, j])[0]
        if len(support) == 0:
            continue
        sim = np.where((G[:, j] > 0) & (cn > 0),
                       G[:, j] / np.maximum(cn, 1e-30), -np.inf)
        sim[j] = -np.inf
        top = set(np.argsort(-sim)[:nnbrs])
        assert set(support) <= top, f"col {j}: support {support} not in {top}"
    for j in range(20):
        sim = np.where(G[:, j] > 0, G[:, j] / np.maximum(cn, 1e-30), -np.inf)
        sim[j] = -np.inf
        order = np.argsort(-sim)
        top = [i for i in order[:nnbrs] if np.isfinite(sim[i])]
        x_ref = oracle_column(mat.to_dense(), j, 0.1, 0.5,
                              active_override=top)
        np.testing.assert_allclose(W[:, j], x_ref, atol=5e-4)
    _held_to_jax(mat, cfg, stats)


def test_cd_deterministic_across_runs():
    rng = np.random.default_rng(23)
    mat = random_csr(rng, 40, 18, density=0.3, seed=23)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, seed=7)
    m1, s1 = _cd(mat, cfg)
    m2, s2 = _cd(mat, cfg)
    np.testing.assert_array_equal(_dense(m1), _dense(m2))
    assert s1["loss"] == s2["loss"]


def test_empty_training_matrix():
    empty = CSR.from_ijv(np.zeros(0, int), np.zeros(0, int),
                         np.zeros(0, np.float32), 5, 7)
    for algo in ("cd", "admm"):
        model, stats = learn(empty, SlimConfig(algo=algo), device="cpu")
        assert stats["nnz"] == 0 and stats["loss"] == 0.0
        assert model.nrows == model.ncols == 7
    ids, _, counts = get_topn(model, empty, nrcmds=3, device="cpu")
    assert counts.sum() == 0 and (ids == -1).all()


def test_fslim_active_mask_wide_two_stage():
    """At width 2^18 the port's one top-k must select the neighbour sets a
    plain numpy top-k selects (the JAX package checks its two-stage top-k
    there)."""
    width, B, k = 1 << 18, 4, 7
    rng = np.random.default_rng(11)
    gj = np.zeros((B, width), np.float32)
    for b in range(B):
        cols = rng.choice(width, 300, replace=False)
        gj[b, cols] = rng.permutation(300).astype(np.float32) + 1.0
    diag = (rng.random(width).astype(np.float32) + 0.5) ** 2
    self_ids = np.arange(B, dtype=np.int32) * 1000
    got = fslim_active_mask(torch.from_numpy(gj), torch.from_numpy(diag),
                            torch.from_numpy(self_ids), width, k,
                            "cos").numpy()
    sim = gj / np.sqrt(diag)[None, :]
    for b in range(B):
        cand = (gj[b] > 0) & (np.arange(width) != self_ids[b])
        s = np.where(cand, sim[b], -np.inf)
        expect = np.argsort(-s)[:k]
        expect = expect[np.isfinite(s[expect])]
        assert set(np.nonzero(got[b])[0]) == set(expect)


def test_keep_device_model_matches_assembled_csr():
    train = random_csr(None, 60, 37, density=0.25, seed=5)
    cfg = SlimConfig(l1r=0.3, l2r=0.5, optTol=1e-9, block_size=16)
    model, stats = _cd(train.infer_ncols(), cfg, keep_device_model=True)
    pack_ = stats.get("W_dev")
    assert isinstance(pack_, DeviceModelPack)
    ref = densify_model(model, npad=pack_.npad, device="cpu").numpy()
    np.testing.assert_allclose(pack_.densify().numpy(), ref, rtol=0,
                               atol=1e-6)


def test_keep_device_model_compact_space():
    train = random_csr(None, 200, 300, density=0.05, seed=11)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, optTol=1e-9, block_size=32,
                     compact_threshold=64)
    model, stats = _cd(train.infer_ncols(), cfg, keep_device_model=True)
    pack_ = stats.get("W_dev")
    assert isinstance(pack_, DeviceModelPack)
    ref = densify_model(model, npad=pack_.npad, device="cpu").numpy()
    np.testing.assert_allclose(pack_.densify().numpy(), ref, rtol=0,
                               atol=1e-6)


# --------------------------------------------------------------------- #
# tests/test_compact.py
# --------------------------------------------------------------------- #
def test_compact_matches_full(rng):
    mat = random_csr(rng, 80, 50, density=0.2, seed=140)
    base = SlimConfig(l1r=0.4, l2r=0.7, optTol=1e-12, block_size=16,
                      shuffle=False)
    full, sf = _cd(mat, base.replace(compact_threshold=10**9))
    comp, sc = _cd(mat, base.replace(compact_threshold=128))
    np.testing.assert_allclose(_dense(comp), _dense(full), atol=5e-4)
    np.testing.assert_allclose(sc["loss"], sf["loss"], rtol=1e-4)
    np.testing.assert_allclose(sc["fit"], sf["fit"], rtol=1e-4)
    _held_to_jax(mat, base.replace(compact_threshold=128), sc)


def test_compact_with_warm_start(rng):
    mat = random_csr(rng, 60, 40, density=0.25, seed=141)
    cfg = SlimConfig(l1r=0.3, l2r=0.5, optTol=1e-12, block_size=16,
                     shuffle=False, compact_threshold=128)
    cold, s_cold = _cd(mat, cfg)
    warm, s_warm = _cd(mat, cfg, imodel=cold)
    np.testing.assert_allclose(_dense(cold), _dense(warm), atol=5e-4)
    assert s_warm["niters"] <= s_cold["niters"]


def test_compact_high_l1_small_unions(rng):
    mat = random_csr(rng, 50, 40, density=0.2, seed=142)
    cfg = SlimConfig(l1r=1e9, l2r=1.0, compact_threshold=128, block_size=16)
    model, _ = _cd(mat, cfg)
    assert model.nnz == 0


def test_compact_fslim_matches_full(rng):
    mat = random_csr(rng, 60, 45, density=0.25, seed=150)
    base = SlimConfig(l1r=0.2, l2r=0.5, nnbrs=4, simtype="cos",
                      optTol=1e-12, block_size=16, shuffle=False)
    full, sf = _cd(mat, base.replace(compact_threshold=10**9))
    comp, sc = _cd(mat, base.replace(compact_threshold=128))
    np.testing.assert_allclose(_dense(comp), _dense(full), atol=5e-4)
    np.testing.assert_allclose(sc["loss"], sf["loss"], rtol=1e-4)
    _held_to_jax(mat, base.replace(compact_threshold=128), sc)


def test_pack_flat_exact(rng):
    """The pack's contract on the port (``ops.pack.pack``; its ids are
    int32 at every width, so the JAX case's 16-bit ids do not apply)."""
    eps = 1e-7
    x = rng.random((13, 96)).astype(np.float32)
    x[x < 0.6] = 0.0
    x[3] = 0.0
    cnt = count_over(torch.from_numpy(x), eps).numpy()
    np.testing.assert_array_equal(cnt, (x > eps).sum(axis=1))
    off = np.zeros(13, np.int32)
    np.cumsum(cnt[:-1], out=off[1:])
    T = int(cnt.sum())
    Tpad = 1 << (T - 1).bit_length()
    fv, fi = pack(torch.from_numpy(x), torch.from_numpy(off), eps, Tpad)
    fv, fi = fv.numpy()[:T], fi.numpy()[:T].astype(np.int64)
    for b in range(13):
        cols = np.nonzero(x[b] > eps)[0]
        s = int(off[b])
        np.testing.assert_array_equal(fi[s:s + len(cols)], cols)
        np.testing.assert_array_equal(fv[s:s + len(cols)], x[b, cols])


def test_compact_frac_snap_is_exact(monkeypatch):
    train = random_csr(None, 150, 300, density=0.08, seed=42).infer_ncols()
    cfg = SlimConfig(l1r=0.8, l2r=0.8, optTol=1e-9, block_size=32,
                     compact_threshold=64)
    m_compact, _ = _cd(train, cfg)
    monkeypatch.setenv("SLIM_COMPACT_FRAC", "0.0")
    m_full, _ = _cd(train, cfg)
    assert m_compact.nnz == m_full.nnz
    np.testing.assert_array_equal(m_compact.indices, m_full.indices)
    np.testing.assert_allclose(m_compact.values(), m_full.values(),
                               rtol=0, atol=1e-6)
