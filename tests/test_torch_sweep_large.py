"""Coordinate-major CD sweep (port of pallas_cd_sweep_large_v4) and its
solve loop, held against the v4 Pallas kernel in interpret mode at
npad = GROUP * 2 * K_FLUSH (two flush windows); the card kernel's windowed
bf16x3 schedule, restated in PyTorch, against the plain version, partial
last windows included."""

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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, B=32, l1r=0.3, npad=NPAD):
    """Actives in group 0 and, by planted mass, in the last group (group 3
    at the default npad, as in tests/test_pallas.py), so most groups are
    inactive."""
    rng = np.random.default_rng(seed)
    n = 90
    mat = random_csr(rng, 120, n, density=0.25, seed=seed)
    G = gram_host(mat, pad_to=npad)
    p = GROUP * min(3, npad // GROUP - 1)
    G[p:p + 8, :32] = 0.9
    G[:32, p:p + 8] = 0.9
    np.fill_diagonal(G, np.maximum(np.diagonal(G), 1.0))
    J = np.arange(B) % n
    gj = G[:, J].T.copy()
    active = (gj > l1r) & (np.arange(npad)[None, :] != J[:, None])
    return rng, G, J, gj, active


@pytest.mark.parametrize("has_pattern", [[1, 0, 1, 1, 0, 1, 0, 1],
                                         [1, 1, 0, 0, 0, 0, 0, 0],
                                         [0, 1, 1, 0, 0, 0, 0, 1]])
def test_one_sweep_matches_v4_interpret(has_pattern):
    """Same perm/has (inactive groups mid-window, a window whose first slot
    has no work), Gq = G in float32 so no bf16 enters the TPU kernel, every
    panel listed: x atol 1e-4."""
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sweep_operands(seed, npad, B=32):
    rng, G, J, gj, active = _problem(seed, B=B, npad=npad)
    x = np.where(active, rng.random(active.shape) * 0.05, 0.0) \
        .astype(np.float32)
    q = (x @ G).astype(np.float32)
    live = (rng.random(B) < 0.85).astype(np.float32)[None, :]
    regsT = np.stack([np.full(B, 0.3), np.full(B, 0.5), np.full(B, 50.0),
                      np.zeros(B), np.full(B, 1e-6)]).astype(np.float32)
    diag2d = np.diagonal(G).reshape(1, npad).astype(np.float32).copy()
    return (G, gj.T, active.T.astype(np.int8), x.T, q.T, live, diag2d,
            regsT)


def _windowed_bf16x3(G, gjT, actT, xT, qT, live, diag2d, regsT, perm, has):
    """The schedule of csrc/sweep_large.cu in PyTorch: per position a q tile
    corrected by the window's earlier slots with work, four GS sub-chunks
    with the in-group product after each, and a flush at the window's last
    slot or at the last position; every product in bf16x3 (hi . hi +
    hi . lo + lo . hi, float32 sums)."""
    def mm(a, b):
        ah, al = S.split_bf16(a)
        bh, bl = S.split_bf16(b)
        f = lambda t: t.to(torch.float32)
        return f(ah) @ f(bh) + f(ah) @ f(bl) + f(al) @ f(bh)

    K, CH = K_FLUSH, 128
    xT, qT = xT.clone(), qT.clone()
    npad, B = gjT.shape
    lv, d = live[0], diag2d[0]
    l1, l2, cap, t0, tol = regsT.unbind(dim=0)
    D = torch.zeros((K, GROUP, B))
    dltx = torch.zeros(B)
    perm, has = perm.tolist(), has.tolist()
    for pos, g in enumerate(perm):
        slot, g0 = pos % K, pos - pos % K
        win = [(k, perm[g0 + k] * GROUP) for k in range(slot + 1)
               if has[g0 + k]]
        rows = slice(g * GROUP, (g + 1) * GROUP)
        if has[pos]:
            qg = qT[rows].clone()
            for k, c in win:
                if k < slot:
                    qg += mm(G[rows, c:c + GROUP], D[k])
            for o in range(0, GROUP, CH):
                sl = slice(g * GROUP + o, g * GROUP + o + CH)
                okf = actT[sl].T.to(torch.float32) * lv[:, None]
                dx = S._gs_chain(gjT[sl].T, xT[sl].T, qg[o:o + CH].T.clone(),
                                 okf, d[sl], G[sl, sl], l1, l2).T
                D[slot, o:o + CH] = dx
                xT[sl] += dx
                dltx += (dx * dx).sum(dim=0)
                if o + CH < GROUP:
                    qg[o + CH:] += mm(G[g * GROUP + o + CH:(g + 1) * GROUP,
                                        sl], dx)
        if (slot == K - 1 or pos == len(perm) - 1) and win:
            for k, c in win:
                qT += mm(G[:, c:c + GROUP], D[k])
    lo = S._end_of_sweep(lv, dltx, cap, t0, tol)
    return xT, qT, lo[None, :], lv[None, :].clone(), dltx[None, :]


# (npad in groups, perm, has): partial last windows (2 and 3 groups), a
# window whose first slot has no work, an all-inactive window
WINDOWS = [(2, [1, 0], [1, 1]),
           (2, [0, 1], [0, 1]),
           (3, [2, 0, 1], [0, 1, 1]),
           (3, [1, 2, 0], [1, 0, 1]),
           (6, [5, 0, 1, 2, 3, 4], [0, 1, 1, 1, 1, 0]),
           (8, [0, 3, 5, 1, 2, 7, 4, 6], [0, 0, 0, 0, 1, 1, 0, 1])]


@pytest.mark.parametrize("ngroups,perm,has", WINDOWS)
def test_plain_matches_row_major_expansion(ngroups, perm, has):
    """At every window shape the coordinate-major plain version is the
    row-major sweep on the chunk order it expands to (bit-equal)."""
    npad = ngroups * GROUP
    G, gjT, actT, xT, qT, live, diag2d, regsT = _sweep_operands(17, npad)
    cpg = GROUP // 128
    gperm, ghas = np.array(perm, np.int32), np.array(has, np.int32)
    cperm = np.repeat(gperm * cpg, cpg) + np.tile(np.arange(cpg), ngroups)
    a = S.cd_sweep_large(*map(_t, (G, gjT, actT, xT, qT, live, diag2d,
                                   regsT, gperm, ghas)))
    b = S.cd_sweep(*map(_t, (G, gjT.T, actT.T, xT.T, qT.T, live.T, diag2d,
                             regsT.T, cperm.astype(np.int32),
                             np.repeat(ghas, cpg))))
    for i in range(5):
        np.testing.assert_array_equal(a[i].numpy(), b[i].numpy().T)


@pytest.mark.parametrize("ngroups,perm,has", WINDOWS)
def test_windowed_bf16x3_schedule_matches_plain(ngroups, perm, has):
    """The card kernel's schedule (window loads, in-group products, flushes
    of partial windows) with bf16x3 products agrees with the plain version
    within the card check's tolerances: x 1e-4 abs, q 1e-4 of max |q|,
    live and nit equal."""
    npad = ngroups * GROUP
    ops = [_t(a) for a in _sweep_operands(23, npad)]
    p, h = _t(np.array(perm, np.int32)), _t(np.array(has, np.int32))
    got = _windowed_bf16x3(*ops, p, h)
    ref = S.cd_sweep_large_plain(*ops, p, h)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    torch.testing.assert_close(got[4], ref[4], rtol=1e-3, atol=1e-9)
    # the flushed q is G x' (the invariant the next sweep starts from)
    assert (got[1] - ops[0] @ got[0]).abs().max().item() <= 1e-4 * qscale


def test_split_bf16():
    """hi = bf16(G) and hi + lo within 2^-16 of G; integer counts below
    2^16 (a binary Gram's entries) split exactly."""
    rng = np.random.default_rng(3)
    G = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 1e3,
        rng.integers(0, 1 << 16, 4096).astype(np.float64)]).astype(np.float32))
    hi, lo = S.split_bf16(G)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, G.to(torch.bfloat16))
    back = hi.to(torch.float32) + lo.to(torch.float32)
    assert ((back - G).abs() <= G.abs() * 2.0 ** -16).all()
    assert torch.equal(back[4096:], G[4096:])


def test_split_made_once_per_g():
    """The wrapper's split is kept for the same unchanged G and remade when
    G changes in place or another G comes."""
    G = torch.rand(64, 64)
    a = S._split_of(G)
    assert S._split_of(G) is a
    G.mul_(2.0)
    b = S._split_of(G)
    assert b is not a and torch.equal(b[0], G.to(torch.bfloat16))
    H = G.clone()
    assert S._split_of(H) is not b


@pytest.mark.parametrize("M,N,clusters,bn", [
    (28672, 1024, 66, 256),    # ML-20M: 7 waves of 256 or 14 of 128
    (8192, 1024, 66, 256),     # FSLIM's widest v4 union: 2 waves of 256
    (6144, 1024, 66, 128),     # 96 pairs of 256 leave a half-empty wave
    (28672, 654, 66, 256),     # 3 tiles of 256 or 6 of 128, 768 columns
    (25600, 1024, 66, 256),    # 13 waves of 128 against 7 of 256
    (28672, 1000, 64, 256)])
def test_flush_tile_n(M, N, clusters, bn):
    """The flush's tile width follows the observed (M, N): the width whose
    waves of ``clusters`` tile pairs take the least time, a 128-wide
    tile's column at 1.14 times a 256-wide one's."""
    assert S.flush_tile_n(M, N, clusters) == bn


@pytest.mark.parametrize("ngroups,B,has,g0,nslots", [
    (4, 70, [1, 0, 1, 1], 0, 4),            # a middle slot without work
    (5, 33, [1, 1, 1, 1, 1], 4, 1),         # a partial last window
    (8, 16, [1, 1, 1, 1, 0, 0, 0, 0], 4, 4)])   # a window without work
def test_flush_window_plain_is_the_bf16x3_window_sum(ngroups, B, has, g0,
                                                     nslots):
    """flush_window on the CPU adds, for each slot with work, the window
    group's columns of G times its deltas with the lo . lo term left out
    (float64 oracle), in place; slots without work add nothing."""
    rng = np.random.default_rng(ngroups)
    npad = ngroups * GROUP
    G = _t(rng.standard_normal((npad, npad)).astype(np.float32))
    d = _t((rng.standard_normal(K_FLUSH * B * GROUP) * 1e-2)
           .astype(np.float32))
    gh, gl = S.split_bf16(G)
    dh, dl = S.split_bf16(d)
    perm = _t(rng.permutation(ngroups).astype(np.int32))
    q = _t(rng.standard_normal((npad, B)).astype(np.float32))
    f64 = lambda t: t.to(torch.float64)
    Dh = f64(dh).reshape(K_FLUSH, B, GROUP)
    Dl = f64(dl).reshape(K_FLUSH, B, GROUP)
    ref = f64(q)
    for s in range(nslots):
        if has[g0 + s]:
            c = slice(int(perm[g0 + s]) * GROUP, (int(perm[g0 + s]) + 1)
                      * GROUP)
            ref += f64(gh)[:, c] @ (Dh[s] + Dl[s]).T + f64(gl)[:, c] @ Dh[s].T
    got = S.flush_window(gh, gl, dh, dl, perm, _t(np.array(has, np.int32)),
                         q, g0, nslots)
    assert got is q
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    if not any(has[g0:g0 + nslots]):
        assert torch.equal(got, ref.to(torch.float32))
