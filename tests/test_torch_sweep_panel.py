"""Row-major group sweeps with a deferred q flush (ports of
pallas_cd_sweep_large_v3 and the eager pallas_cd_sweep_large) and their
solve loop, held against the Pallas kernels in interpret mode; the card
kernel's windowed bf16x3 schedule, restated in PyTorch, against the plain
version."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from conftest import random_csr
from slim_tpu.ops.gram import gram_host
from slim_tpu.ops.pallas_cd import (GROUP, K_FLUSH, pallas_cd_sweep_large,
                                    pallas_cd_sweep_large_v3,
                                    pallas_solve_large_core)
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops.cd_kernel import per_col


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NPAD = GROUP * 2 * K_FLUSH
PLAIN = {"v3": S.cd_sweep_v3_plain, "eager": S.cd_sweep_eager_plain}
PALLAS = {"v3": pallas_cd_sweep_large_v3, "eager": pallas_cd_sweep_large}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(seed, npad=NPAD, B=32, l1r=0.3):
    """Actives in group 0 and, by planted mass, in the last group (as in
    tests/test_pallas.py), so most groups are inactive."""
    rng = np.random.default_rng(seed)
    n = 90
    mat = random_csr(rng, 120, n, density=0.25, seed=seed)
    G = gram_host(mat, pad_to=npad)
    g = npad - GROUP
    G[g:g + 8, :32] = 0.9
    G[:32, g:g + 8] = 0.9
    np.fill_diagonal(G, np.maximum(np.diagonal(G), 1.0))
    J = np.arange(B) % n
    gj = G[:, J].T.copy()
    active = (gj > l1r) & (np.arange(npad)[None, :] != J[:, None])
    return rng, G, J, gj, active


def _sweep_operands(seed, npad, has_pattern):
    rng, G, J, gj, active = _problem(seed, npad)
    B = gj.shape[0]
    ngroups = npad // GROUP
    x = np.where(active, rng.random(active.shape) * 0.05, 0.0) \
        .astype(np.float32)
    q = (x @ G).astype(np.float32)
    live = (rng.random(B) < 0.85).astype(np.float32)[:, None]
    regs = np.stack([np.full(B, 0.3), np.full(B, 0.5),
                     np.where(np.arange(B) % 3, 200.0, 1.0),
                     np.zeros(B), np.full(B, 1e-6)], axis=1).astype(np.float32)
    perm = np.array([0, 3, 5, 1, 2, 7, 4, 6], np.int32)
    perm = perm[perm < ngroups]
    has = np.array(has_pattern, np.int32)
    diag2d = np.diagonal(G).reshape(1, npad).astype(np.float32).copy()
    return (G, gj.astype(np.float32), active.astype(np.int8), x, q, live,
            diag2d, regs, perm, has)


@pytest.mark.parametrize("variant,npad,has_pattern", [
    ("v3", NPAD, [1, 0, 1, 1, 0, 1, 0, 1]),
    ("v3", NPAD, [1, 1, 0, 0, 0, 0, 0, 0]),
    ("eager", NPAD, [1, 0, 1, 1, 0, 1, 0, 1]),
    ("eager", 1024, [0, 1]),
])
def test_one_sweep_matches_pallas_interpret(variant, npad, has_pattern):
    """Same perm/has (inactive groups inside windows): x atol 1e-4, q rel
    1e-4, live and nit equal."""
    ops = _sweep_operands(11, npad, has_pattern)
    want = [np.asarray(a) for a in PALLAS[variant](
        *map(jnp.asarray, ops), interpret=True)]
    got = [a.numpy() for a in PLAIN[variant](*map(t, ops))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)     # x
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)  # q
    np.testing.assert_array_equal(got[2], want[2])                     # live
    np.testing.assert_array_equal(got[3], want[3])                     # nit
    np.testing.assert_allclose(got[4], want[4], rtol=1e-3, atol=1e-9)  # dltx


def test_wrappers_route_and_check():
    """CPU tensors take the plain version; a window that does not tile the
    groups and a device that is neither CPU nor CUDA raise."""
    ops = list(map(t, _sweep_operands(11, NPAD, [1, 0, 1, 1, 0, 1, 0, 1])))
    n3 = S.cd_sweep_v3.launches
    for a, b in zip(S.cd_sweep_v3(*ops), S.cd_sweep_v3_plain(*ops)):
        assert torch.equal(a, b)
    assert S.cd_sweep_v3.launches == n3          # no kernel on the CPU
    two = list(map(t, _sweep_operands(11, 1024, [1, 1])))
    with pytest.raises(ValueError):
        S.cd_sweep_v3(*two)
    S.cd_sweep_eager(*two)                        # windows of one always fit
    with pytest.raises(ValueError):
        S.cd_sweep_eager(*[a.to("meta") for a in two])


@pytest.mark.parametrize("variant", ["v3", "eager"])
def test_solve_panel_core_matches_pallas_solve(variant):
    """Full loop, unshuffled, against pallas_solve_large_core on the same
    variant in interpret mode: x atol 2e-4, objective rtol 1e-4."""
    rng, G, J, gj, active = _problem(11)
    B = gj.shape[0]
    diag = np.diagonal(G).copy()
    yty = diag[J]
    x0 = np.zeros((B, NPAD), np.float32)
    caps = np.full(B, 200, np.int32)
    solve = jax.jit(pallas_solve_large_core, static_argnames=(
        "shuffle", "interpret", "use_v3", "use_v4"))
    want = solve(*map(jnp.asarray, (G, gj, diag, active, x0, caps, yty)),
                 0.3, 0.5, 1e-10, 5, shuffle=False, interpret=True,
                 use_v3=variant == "v3", use_v4=False)
    got = S.solve_panel_core(t(G), t(gj), t(diag), t(active), t(x0),
                             t(caps), t(yty), per_col(0.3, B, "cpu"),
                             per_col(0.5, B, "cpu"), 1e-10, None,
                             shuffle=False, variant=variant)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-4)
    # f32 sums taken in another order can move a column's optTol crossing
    # (1e-10 here) by a sweep or two (tests/test_torch_sweep_large.py)
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 3


def test_group_sweeps_agree_at_the_optimum():
    """v3, eager and the v4 counterpart, shuffled, warm-started from a
    nonzero x0: the same optimum (x atol 2e-4, objective rtol 1e-4)."""
    rng, G, J, gj, active = _problem(17)
    B = gj.shape[0]
    diag = np.diagonal(G).copy()
    x0 = np.where(active, rng.random(active.shape) * 0.1, 0.0) \
        .astype(np.float32)
    args = (t(G), t(gj), t(diag), t(active), t(x0),
            t(np.full(B, 300, np.int32)), t(diag[J]), per_col(0.3, B, "cpu"),
            per_col(0.5, B, "cpu"), 1e-10)
    ref = S.solve_large_core(*args, torch.Generator().manual_seed(1))
    for variant in ("v3", "eager"):
        got = S.solve_panel_core(*args, torch.Generator().manual_seed(2),
                                 variant=variant)
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=2e-4)
        np.testing.assert_allclose(got[4].numpy(), ref[4].numpy(),
                                   rtol=1e-4)
    with pytest.raises(ValueError):
        S.solve_panel_core(*args, None, variant="v4")


@pytest.mark.parametrize("value,want", [(None, 8), ("3", 3), ("0", 1 << 30),
                                        ("-2", 1 << 30)])
def test_q_refresh_knob(monkeypatch, value, want):
    """SLIM_PALLAS_QREFRESH is read at call time; 0 or less never
    refreshes (the JAX package's pallas_cd.py:1359-1361)."""
    if value is None:
        monkeypatch.delenv("SLIM_PALLAS_QREFRESH", raising=False)
    else:
        monkeypatch.setenv("SLIM_PALLAS_QREFRESH", value)
    assert S.q_refresh() == want


def test_solve_panel_core_without_q_refresh_agrees(monkeypatch):
    """With SLIM_PALLAS_QREFRESH=0 the carried q is never recomputed; the
    solve reaches the default's optimum (x atol 2e-4, objective rtol
    1e-4)."""
    rng, G, J, gj, active = _problem(13)
    B = gj.shape[0]
    diag = np.diagonal(G).copy()
    x0 = np.where(active, rng.random(active.shape) * 0.1, 0.0) \
        .astype(np.float32)
    args = (t(G), t(gj), t(diag), t(active), t(x0),
            t(np.full(B, 300, np.int32)), t(diag[J]), per_col(0.3, B, "cpu"),
            per_col(0.5, B, "cpu"), 1e-10)
    ref = S.solve_panel_core(*args, None, shuffle=False, variant="eager")
    monkeypatch.setenv("SLIM_PALLAS_QREFRESH", "0")
    got = S.solve_panel_core(*args, None, shuffle=False, variant="eager")
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(got[4].numpy(), ref[4].numpy(), rtol=1e-4)
    assert int(got[1].max()) > 8          # the default refreshed on the way


def _windowed_bf16x3(G, gj, act, x, q, live, diag2d, regs, perm, has, K):
    """The schedule of csrc/sweep_panel.cu in PyTorch, row-major: per
    position with work the group's q tile (q itself at a window's first
    slot, else corrected by the window's earlier slots with work), four GS
    sub-chunks with the in-group product after each, and at the window's
    last slot a flush over its slots with work.  Every product is bf16x3
    (hi . hi + hi . lo + lo . hi, float32 sums) and reads G's rows for its
    columns, G[n, k] for G[k, n], as the kernel does (G is symmetric)."""
    def mm(d, g_rows):
        """d @ g_rows.T in bf16x3: d (B, k) deltas, g_rows (n, k)."""
        dh, dl = S.split_bf16(d)
        gh, gl = S.split_bf16(g_rows)
        f = lambda a: a.to(torch.float32)
        return (f(dh) @ f(gh).T + f(dl) @ f(gh).T) + f(dh) @ f(gl).T

    CH = 128
    x, q = x.clone(), q.clone()
    B = gj.shape[0]
    lv, d = live[:, 0], diag2d[0]
    l1, l2, cap, t0, tol = regs.unbind(dim=1)
    D = torch.zeros((K, B, GROUP))
    dltx = torch.zeros(B)
    perm, has = perm.tolist(), has.tolist()
    for pos, g in enumerate(perm):
        slot, g0 = pos % K, pos - pos % K
        win = [(k, perm[g0 + k] * GROUP) for k in range(slot + 1)
               if has[g0 + k]]
        lo, hi = g * GROUP, (g + 1) * GROUP
        if has[pos]:
            qt = q[:, lo:hi].clone()
            for k, c in win:
                if k < slot:
                    qt += mm(D[k], G[lo:hi, c:c + GROUP])
            for o in range(0, GROUP, CH):
                sl = slice(lo + o, lo + o + CH)
                okf = act[:, sl].to(torch.float32) * lv[:, None]
                dx = S._gs_chain(gj[:, sl], x[:, sl],
                                 qt[:, o:o + CH].clone(), okf, d[sl],
                                 G[sl, sl], l1, l2)
                D[slot, :, o:o + CH] = dx
                x[:, sl] += dx
                dltx += (dx * dx).sum(dim=1)
                if o + CH < GROUP:
                    qt[:, o + CH:] += mm(dx, G[lo + o + CH:hi, sl])
        if slot == K - 1:
            for k, c in win:
                q += mm(D[k], G[:, c:c + GROUP])
    end = S._end_of_sweep(lv, dltx, cap, t0, tol)
    return x, q, end[:, None], lv[:, None].clone(), dltx[:, None]


# (K, npad in groups, perm, has): a window whose first slot has no work and
# an all-inactive window, inactive slots inside windows, windows of one
PANEL_WINDOWS = [(4, 8, [0, 3, 5, 1, 2, 7, 4, 6], [0, 1, 1, 1, 0, 0, 0, 0]),
                 (4, 8, [0, 3, 5, 1, 2, 7, 4, 6], [1, 0, 1, 1, 0, 1, 0, 1]),
                 (4, 4, [2, 0, 3, 1], [0, 0, 1, 1]),
                 (1, 3, [2, 0, 1], [0, 1, 1]),
                 (1, 8, [0, 3, 5, 1, 2, 7, 4, 6], [0, 0, 0, 0, 1, 1, 0, 1]),
                 (1, 2, [1, 0], [1, 1])]


def _coupled_operands(seed, npad, perm, has, B=32):
    """One sweep's operands on G = AᵀA of a random binary A whose columns
    co-occur across all groups, and a small x0, so each group's updates
    depend on the pending deltas of its window (a schedule that dropped the
    load corrections, the in-group products or a slot of the flush would
    move x by ~0.1)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((300, npad)) < 0.02).astype(np.float32)
    G = A.T @ A
    np.fill_diagonal(G, np.maximum(np.diagonal(G), 1.0))
    J = np.arange(B) * (npad // B)
    gj = G[:, J].T.copy()
    active = (gj > 0.3) & (np.arange(npad)[None, :] != J[:, None])
    x = np.where(active, rng.random(active.shape) * 1e-3, 0.0) \
        .astype(np.float32)
    live = (rng.random(B) < 0.85).astype(np.float32)[:, None]
    regs = np.stack([np.full(B, 0.3), np.full(B, 0.5),
                     np.where(np.arange(B) % 3, 200.0, 1.0),
                     np.zeros(B), np.full(B, 1e-6)], axis=1).astype(np.float32)
    diag2d = np.diagonal(G).reshape(1, npad).copy()
    return [t(a) for a in (G, gj, active.astype(np.int8), x, x @ G, live,
                           diag2d, regs, np.array(perm, np.int32),
                           np.array(has, np.int32))]


@pytest.mark.parametrize("K,ngroups,perm,has", PANEL_WINDOWS)
def test_windowed_bf16x3_schedule_matches_plain(K, ngroups, perm, has):
    """The card kernel's schedule (window loads, in-group products, flushes)
    with bf16x3 products agrees with the plain version within the card
    check's tolerances: x 1e-4 abs, q 1e-4 of max |q|, live and nit equal;
    the flushed q is x'G."""
    ops = _coupled_operands(23, ngroups * GROUP, perm, has)
    got = _windowed_bf16x3(*ops, K)
    ref = PLAIN["v3" if K == K_FLUSH else "eager"](*ops)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    torch.testing.assert_close(got[4], ref[4], rtol=1e-3, atol=1e-9)
    assert (got[1] - got[0] @ ops[0]).abs().max().item() <= 1e-4 * qscale


@pytest.mark.parametrize("v4,v3,width,want", [
    (None, None, 28672, "v4"),
    ("0", None, 28672, "v3"),
    ("0", None, 6144, "v3"),
    ("0", None, 5120, "eager"),      # 10 groups: no whole windows of 4
    ("0", "0", 28672, "eager"),
    ("1", "0", 28672, "v4"),
])
def test_pick_large_variant(monkeypatch, v4, v3, width, want):
    for name, val in (("SLIM_PALLAS_V4", v4), ("SLIM_PALLAS_V3", v3)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    assert S.pick_large_variant(1024, width) == want
