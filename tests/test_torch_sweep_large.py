"""Coordinate-major CD sweep (port of pallas_cd_sweep_large_v4) and its
solve loop, held against the v4 Pallas kernel in interpret mode at
npad = GROUP * 2 * K_FLUSH (two flush windows)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from conftest import random_csr
from slim_tpu.ops.gram import gram_host
from slim_tpu.ops.pallas_cd import (GROUP, K_FLUSH, PANEL,
                                    pallas_cd_sweep_large_v4,
                                    pallas_solve_large_core)
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops.cd_kernel import per_col

NPAD = GROUP * 2 * K_FLUSH


def _problem(seed, B=32, l1r=0.3):
    """Actives in group 0 and, by planted mass, in group 3 (as in
    tests/test_pallas.py), so most groups are inactive."""
    rng = np.random.default_rng(seed)
    n = 90
    mat = random_csr(rng, 120, n, density=0.25, seed=seed)
    G = gram_host(mat, pad_to=NPAD)
    G[GROUP * 3:GROUP * 3 + 8, :32] = 0.9
    G[:32, GROUP * 3:GROUP * 3 + 8] = 0.9
    np.fill_diagonal(G, np.maximum(np.diagonal(G), 1.0))
    J = np.arange(B) % n
    gj = G[:, J].T.copy()
    active = (gj > l1r) & (np.arange(NPAD)[None, :] != J[:, None])
    return rng, G, J, gj, active


@pytest.mark.parametrize("has_pattern", [[1, 0, 1, 1, 0, 1, 0, 1],
                                         [1, 1, 0, 0, 0, 0, 0, 0]])
def test_one_sweep_matches_v4_interpret(has_pattern):
    """Same perm/has (inactive groups mid-window), Gq = G in float32 so no
    bf16 enters the TPU kernel, every panel listed: x atol 1e-4."""
    rng, G, J, gj, active = _problem(11)
    B = gj.shape[0]
    ngroups = NPAD // GROUP
    xT = np.where(active, rng.random(active.shape) * 0.05, 0.0).T \
        .astype(np.float32).copy()
    qT = (G @ xT).astype(np.float32)
    live = (rng.random(B) < 0.85).astype(np.float32)[None, :]
    regsT = np.stack([np.full(B, 0.3), np.full(B, 0.5),
                      np.where(np.arange(B) % 3, 200.0, 1.0),
                      np.zeros(B), np.full(B, 1e-6)]).astype(np.float32)
    perm = np.array([0, 3, 5, 1, 2, 7, 4, 6], np.int32)[:ngroups]
    has = np.array(has_pattern, np.int32)[:ngroups]
    npanels = NPAD // PANEL
    panarr = np.concatenate([[npanels], np.arange(npanels)]).astype(np.int32)
    diag2d = np.diagonal(G).reshape(1, NPAD).astype(np.float32).copy()
    gjT = gj.T.astype(np.float32).copy()
    actT = active.T.astype(np.int8).copy()
    want = pallas_cd_sweep_large_v4(*map(jnp.asarray, (
        G, G, gjT, actT, xT, qT, live, diag2d, regsT, perm, has, panarr)),
        interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = S.cd_sweep_large(t(G), t(gjT), t(actT), t(xT), t(qT), t(live),
                           t(diag2d), t(regsT), t(perm), t(has))
    w = [np.asarray(a) for a in want]
    g = [a.numpy() for a in got]
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-4)      # x
    np.testing.assert_allclose(g[1], w[1], rtol=1e-4, atol=1e-4)   # q
    np.testing.assert_array_equal(g[2], w[2])                      # live
    np.testing.assert_array_equal(g[3], w[3])                      # nit
    np.testing.assert_allclose(g[4], w[4], rtol=1e-3, atol=1e-9)   # dltx


def test_solve_large_core_matches_v4_solve():
    """Full loop, unshuffled, against pallas_solve_large_core(use_v4=True)
    in interpret mode: x atol 2e-4, objective rtol 1e-4."""
    import jax

    rng, G, J, gj, active = _problem(11)
    B = gj.shape[0]
    diag = np.diagonal(G).copy()
    yty = diag[J]
    x0 = np.zeros((B, NPAD), np.float32)
    caps = np.full(B, 200, np.int32)
    solve = jax.jit(pallas_solve_large_core, static_argnames=(
        "shuffle", "interpret", "use_v4"))
    want = solve(*map(jnp.asarray, (G, gj, diag, active, x0, caps, yty)),
                 0.3, 0.5, 1e-10, 5, shuffle=False, interpret=True,
                 use_v4=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = S.solve_large_core(t(G), t(gj), t(diag), t(active), t(x0),
                             t(caps), t(yty), per_col(0.3, B, "cpu"),
                             per_col(0.5, B, "cpu"), 1e-10, None,
                             shuffle=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-4)
    # the TPU kernel streams a bf16 copy of G in its flush, which can move
    # a column's optTol crossing by a sweep or two (tests/test_pallas.py)
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 3


def test_large_and_row_major_plain_agree():
    """The two layouts are one sweep schedule: the coordinate-major plain
    version equals the row-major one on the chunk order it expands to."""
    rng, G, J, gj, active = _problem(13)
    B = gj.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = np.where(active, rng.random(active.shape) * 0.05, 0.0) \
        .astype(np.float32)
    q = (x @ G).astype(np.float32)
    live = np.ones((B, 1), np.float32)
    regs = np.tile(np.array([0.3, 0.5, 9.0, 0.0, 1e-6], np.float32), (B, 1))
    gperm = np.array([3, 0, 1, 2, 4, 5, 6, 7], np.int32)
    ghas = np.array([1, 1, 0, 0, 0, 0, 0, 1], np.int32)
    cpg = GROUP // 128
    cperm = np.repeat(gperm * cpg, cpg) + np.tile(np.arange(cpg), len(gperm))
    chas = np.repeat(ghas, cpg)
    diag2d = np.diagonal(G).reshape(1, NPAD).astype(np.float32).copy()
    a = S.cd_sweep_large(t(G), t(gj.T), t(active.T.astype(np.int8)), t(x.T),
                         t(q.T), t(live.T), t(diag2d), t(regs.T), t(gperm),
                         t(ghas))
    b = S.cd_sweep(t(G), t(gj), t(active.astype(np.int8)), t(x), t(q),
                   t(live), t(diag2d), t(regs), t(cperm.astype(np.int32)),
                   t(chas.astype(np.int32)))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy().T)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy().T)
