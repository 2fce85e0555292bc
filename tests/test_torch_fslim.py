"""FSLIM learning of the PyTorch port against the JAX package: neighbour
selection (``fslim_active_mask``, ties included), the FSLIM unions, the
restricted solve against the f64 oracle, compact against full width, learn
and model selection, ofslim and the CLI, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.api import learn as jax_learn
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.mselect import mselect_pairs as jax_mselect_pairs
from slim_tpu.ops import cd_kernel as jcd
from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch.cli import slim_learn
from slim_tpu_torch.io.readers import read_matrix, write_matrix
from slim_tpu_torch.mselect import mselect_pairs
from slim_tpu_torch.ops import cd_kernel as tcd
from slim_tpu_torch.solvers.cd import estimate_model_cd
from slim_tpu_torch.types import CSR
from test_cd import oracle_column


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


def _gram(rng, nrows, n, npad, density=0.15):
    A = (rng.random((nrows, n)) < density).astype(np.float32)
    G = np.zeros((npad, npad), np.float32)
    G[:n, :n] = A.T @ A
    return G


def _masks(gj, diag, ids, n_valid, k, simtype, col_ids=None, norms=None):
    """(JAX mask, port mask) for the same inputs."""
    got_j = jcd.fslim_active_mask(
        jnp.asarray(gj), jnp.asarray(diag), jnp.asarray(ids), n_valid, k,
        simtype, col_ids=None if col_ids is None else jnp.asarray(col_ids),
        self_norms=None if norms is None else jnp.asarray(norms))
    got_t = tcd.fslim_active_mask(
        torch.from_numpy(gj), torch.from_numpy(diag), torch.from_numpy(ids),
        n_valid, k, simtype,
        col_ids=None if col_ids is None else torch.from_numpy(col_ids),
        self_norms=None if norms is None else torch.from_numpy(norms))
    return np.asarray(got_j), got_t.numpy()


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("simtype", ["dotp", "cos", "jac"])
def test_active_mask_matches_jax(simtype, compact):
    """Equal masks on a binary matrix's Gram (many equal co-counts), and on
    a constructed tie at the k-th slot: equal norms and integer Gram
    columns, so dotp, cos and jac all tie and the lowest position wins.
    In compact space the positions are an ascending subset of the ids."""
    rng = np.random.default_rng(30)
    n, npad, B, k = 90, 128, 12, 6
    G = _gram(rng, 150, n, npad)
    ids = rng.choice(n, B, replace=False).astype(np.int32)
    cases = [(G[:, ids].T.copy(), np.diagonal(G).copy())]
    gj = rng.integers(0, 4, (B, npad)).astype(np.float32)
    gj[:, n:] = 0.0
    gj[0, :10] = [5, 5, 4, 4, 4, 4, 4, 3, 3, 3]     # 6th slot: 5 fours tie
    diag = np.full(npad, 9.0, np.float32)
    cases.append((gj, diag))
    for gj, diag in cases:
        if compact:
            S = np.sort(rng.choice(npad - 1, 70, replace=False)).astype(
                np.int32)
            mj, mt = _masks(gj[:, S], diag[S], ids, npad, k, simtype,
                            col_ids=S, norms=np.sqrt(diag[ids]))
        else:
            mj, mt = _masks(gj, diag, ids, n, k, simtype)
        np.testing.assert_array_equal(mt, mj)
        assert mt.sum(axis=1).max() == k
    if not compact:
        assert mt[0, :10].tolist() == [True] * 6 + [False] * 4


def test_active_mask_wide_single_topk():
    """At width 2^18 the JAX package takes a two-stage top-k (an XLA sort
    workaround); the port's one top-k selects the same sets, and both
    equal a numpy argsort over distinct similarities."""
    width, B, k = 1 << 18, 4, 7
    rng = np.random.default_rng(11)
    gj = np.zeros((B, width), np.float32)
    for b in range(B):
        cols = rng.choice(width, 300, replace=False)
        gj[b, cols] = rng.permutation(300).astype(np.float32) + 1.0
    diag = (rng.random(width).astype(np.float32) + 0.5) ** 2
    self_ids = np.arange(B, dtype=np.int32) * 1000
    mj, mt = _masks(gj, diag, self_ids, width, k, "cos")
    np.testing.assert_array_equal(mt, mj)
    sim = gj / np.sqrt(diag)[None, :]
    for b in range(B):
        cand = (gj[b] > 0) & (np.arange(width) != self_ids[b])
        s = np.where(cand, sim[b], -np.inf)
        expect = np.argsort(-s)[:k]
        expect = expect[np.isfinite(s[expect])]
        assert set(np.nonzero(mt[b])[0]) == set(expect)


@pytest.mark.parametrize("simtype", ["cos", "jac"])
def test_union_mask_matches_jax(simtype):
    """A block's FSLIM union (ids ascending, npad-1 padding) and count."""
    rng = np.random.default_rng(31)
    npad = 256
    G = _gram(rng, 200, 240, npad, density=0.05)
    J = np.arange(40, 72, dtype=np.int32)
    Sj, cj = jcd.block_union_mask(jnp.asarray(G), jnp.asarray(J), 0.0, npad,
                                  fslim_nnbrs=5, simtype=simtype)
    St, ct, nt = tcd.block_union_mask(torch.from_numpy(G),
                                      torch.from_numpy(J), 0.0, npad,
                                      fslim_nnbrs=5, simtype=simtype)
    assert int(ct) == int(cj) and 0 < int(ct) < npad
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    # the neighbours it counts are the selection's own, at most 5 a column
    mask = tcd.fslim_active_mask(torch.from_numpy(G[:, J].T.copy()),
                                 torch.from_numpy(np.diagonal(G).copy()),
                                 torch.from_numpy(J), npad, 5, simtype)
    assert nt == int(mask.sum()) <= 5 * len(J)


def test_fslim_restricts_support_and_matches_oracle():
    """estimate_model_cd called directly (the JAX package's
    test_fslim_restricts_support): every column's support lies in its
    cosine top-nnbrs, and the solution equals the f64 oracle restricted to
    that set."""
    rng = np.random.default_rng(13)
    mat = _port(random_csr(rng, 50, 20, density=0.4))
    nnbrs = 3
    cfg = SlimConfig(l1r=0.1, l2r=0.5, nnbrs=nnbrs, simtype="cos",
                     optTol=1e-12, shuffle=False)
    model, _ = estimate_model_cd(mat, cfg, device="cpu")
    W = model.to_dense()
    assert np.all((W > 0).sum(axis=0) <= nnbrs)
    A = mat.to_dense().astype(np.float64)
    G = A.T @ A
    cn = np.sqrt(np.diag(G))
    for j in range(20):
        sim = np.where(G[:, j] > 0, G[:, j] / np.maximum(cn, 1e-30),
                       -np.inf)
        sim[j] = -np.inf
        order = np.argsort(-sim)
        top = [i for i in order[:nnbrs] if np.isfinite(sim[i])]
        assert set(np.nonzero(W[:, j])[0]) <= set(top), j
        x_ref = oracle_column(mat.to_dense(), j, 0.1, 0.5,
                              active_override=top)
        np.testing.assert_allclose(W[:, j], x_ref, atol=5e-4)


@pytest.mark.parametrize("case", ["jax_test", "narrow_unions"])
def test_compact_fslim_matches_full(case):
    """Compact FSLIM blocks solve the full-width problem: the JAX package's
    test_compact_fslim_matches_full (its unions snap to full width), and a
    wider catalogue whose unions stay narrow."""
    if case == "jax_test":
        mat = _port(random_csr(np.random.default_rng(0), 60, 45,
                               density=0.25, seed=150))
        base = dict(l1r=0.2, l2r=0.5, nnbrs=4, simtype="cos", optTol=1e-12,
                    block_size=16, shuffle=False)
        thresh = 128
    else:
        mat = _port(random_csr(np.random.default_rng(0), 300, 700,
                               density=0.02, seed=151))
        base = dict(l1r=0.2, l2r=0.5, nnbrs=4, simtype="jac", optTol=1e-12,
                    block_size=64, shuffle=False)
        thresh = 256
    full, sf = estimate_model_cd(mat.infer_ncols(), SlimConfig(
        compact_threshold=10**9, **base), device="cpu")
    comp, sc = estimate_model_cd(mat.infer_ncols(), SlimConfig(
        compact_threshold=thresh, **base), device="cpu")
    np.testing.assert_allclose(comp.to_dense(), full.to_dense(), atol=5e-4)
    np.testing.assert_allclose(sc["loss"], sf["loss"], rtol=1e-4)
    if case == "narrow_unions":
        assert sc["unions"] and max(sc["union_widths"]) < 768


@pytest.mark.parametrize("simtype", ["cos", "jac", "dotp"])
@pytest.mark.parametrize("nnbrs", [10, 50])
def test_learn_matches_jax(nnbrs, simtype):
    """Port vs JAX FSLIM learn: loss rtol 1e-4, nnz ±1%, every column on
    at most nnbrs coordinates."""
    rng = np.random.default_rng(5)
    mat = random_csr(rng, 200, 90, density=0.12)
    kw = dict(l1r=0.5, l2r=1.0, block_size=32, nnbrs=nnbrs, simtype=simtype)
    _, sj = jax_learn(mat, JaxConfig(**kw))
    model, st = learn(_port(mat), SlimConfig(**kw), device="cpu")
    np.testing.assert_allclose(st["loss"], sj["loss"], rtol=1e-4)
    assert abs(st["nnz"] - sj["nnz"]) <= 0.01 * sj["nnz"]
    assert (model.to_dense() > 0).sum(axis=0).max() <= nnbrs


def test_ofslim_learns_as_fslim():
    """ofslim (nnbrs > 0, ordered) is FSLIM: the reference never reads
    ``ordered``; an imodel is ignored, as FSLIM ignores warm starts."""
    mat = _port(random_csr(np.random.default_rng(6), 120, 60, density=0.15))
    kw = dict(l1r=0.5, l2r=1.0, block_size=32, nnbrs=8, shuffle=False)
    m_f, s_f = learn(mat, SlimConfig(**kw), device="cpu")
    m_o, s_o = learn(mat, SlimConfig(ordered=1, **kw), imodel=m_f,
                     device="cpu")
    assert SlimConfig(ordered=1, **kw).mtype == "ofslim"
    assert m_o == m_f and s_o["niters"] == s_f["niters"]


def test_cli_learn_fslim(tmp_path):
    """slim_learn -nnbrs=3 -simtype=jac (the JAX package's
    test_learn_cli_fslim): each column on at most 3 coordinates."""
    trn = random_csr(np.random.default_rng(0), 40, 25, density=0.3, seed=200)
    trn_f, mdl_f = str(tmp_path / "trn.csr"), str(tmp_path / "f.model")
    write_matrix(_port(trn), trn_f, fmt="csr")
    assert slim_learn.main(["-nnbrs=3", "-simtype=jac", "-l1r=0.2",
                            "-l2r=0.5", "-device=cpu", trn_f, mdl_f]) == 0
    W = read_matrix(mdl_f, fmt="csr").to_dense()
    assert W.sum() > 0 and (W > 0).sum(axis=0).max() <= 3


def test_mselect_fslim_matches_jax():
    """Model selection over FSLIM points: per point nnz ±1%, HR ±0.015 and
    ARHR ±0.010 of the JAX package's walk, the loss of its independent
    learn (FSLIM takes no warm start) within rtol 1e-4, and the retained
    pack densifies to the point's model."""
    from slim_tpu_torch.predict import densify_model

    rng = np.random.default_rng(7)
    trn = random_csr(rng, 150, 70, density=0.15)
    tst = random_csr(rng, 150, 70, density=0.03)
    pts = [(0.5, 1.0), (0.2, 0.5)]
    kw = dict(nnbrs=6, simtype="cos", block_size=32)
    errs = []

    def cb(rec, model):
        ref = densify_model(model, npad=rec["pack"].npad, device="cpu")
        errs.append(float((rec["pack"].densify() - ref).abs().max()))

    rj = jax_mselect_pairs(trn, tst, JaxConfig(**kw), pts)["results"]
    rt = mselect_pairs(_port(trn), _port(tst), SlimConfig(**kw), pts,
                       point_callback=cb, device="cpu")["results"]
    assert errs == [0.0, 0.0]
    for (l1, l2), a, b in zip(pts, rt, rj):
        _, sj = jax_learn(trn, JaxConfig(l1r=l1, l2r=l2, **kw))
        np.testing.assert_allclose(a["loss"], sj["loss"], rtol=1e-4)
        assert abs(a["nnz"] - b["nnz"]) <= 0.01 * b["nnz"]
        assert abs(a["hr"] - b["hr"]) <= 0.015
        assert abs(a["arhr"] - b["arhr"]) <= 0.010
