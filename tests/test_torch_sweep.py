"""Row-major CD sweep (port of pallas_cd_sweeps) and its solve loop, held
against the Pallas kernel in interpret mode and against the JAX XLA
block solve; the card kernel's bf16x3 schedule, restated in PyTorch,
against the plain version; the routing of an ML-1M-shaped catalogue."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from conftest import random_csr
from slim_tpu.ops.cd_kernel import cd_solve_block
from slim_tpu.ops.gram import gram_host
from slim_tpu.ops.pallas_cd import pallas_cd_solve, pallas_cd_sweeps
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops.cd_kernel import _cd_core, per_col
from slim_tpu_torch.solvers.cd import bucket_npad, pick_impl


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=200, npad=256, B=32, l1r=0.3):
    rng = np.random.default_rng(seed)
    mat = random_csr(rng, 3 * n, n, density=0.08, seed=seed)
    G = gram_host(mat, pad_to=npad)
    J = (np.arange(B) * 7) % n
    gj = G[:, J].T.copy()
    active = (gj > l1r) & (np.arange(npad)[None, :] != J[:, None])
    caps = np.minimum(50 * mat.col_nnz()[J], 10000).astype(np.int32)
    return rng, G, J, gj, active, caps


def _sweep_operands(rng, G, gj, active):
    B, npad = gj.shape
    nchunks = npad // 128
    x = np.where(active, rng.random((B, npad)) * 0.05, 0.0).astype(np.float32)
    q = (x @ G).astype(np.float32)
    live = (rng.random(B) < 0.8).astype(np.float32)[:, None]
    regs = np.stack([np.full(B, 0.3), rng.random(B) + 0.5,
                     np.where(np.arange(B) % 2, 3.0, 50.0), np.full(B, 2.0),
                     np.full(B, 1e-6)], axis=1).astype(np.float32)
    perm = rng.permutation(nchunks).astype(np.int32)[None, :]
    has = np.ones((1, nchunks), np.int32)
    has[0, 0] = 0                              # a skipped chunk
    diag2d = np.diagonal(G).reshape(1, npad).astype(np.float32).copy()
    return (G, gj.astype(np.float32), active.astype(np.int8), x, q, live,
            diag2d, regs, perm, has)


@pytest.mark.parametrize("seed,B", [(0, 32), (1, 32), (2, 40)],
                         ids=["0", "1", "2-B40"])
def test_one_sweep_matches_pallas_interpret(seed, B):
    """Same perm/has (a skipped chunk), B = 40 off the warp and block
    multiples too."""
    rng, G, J, gj, active, caps = _problem(seed, B=B)
    ops = _sweep_operands(rng, G, gj, active)
    want = pallas_cd_sweeps(*map(jnp.asarray, ops), interpret=True)
    got = S.cd_sweep(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in ops))
    w = [np.asarray(a) for a in want]
    g = [a.numpy() for a in got]
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)     # x
    np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)  # q
    np.testing.assert_array_equal(g[2], w[2])                     # live
    np.testing.assert_array_equal(g[3], w[3])                     # nit
    np.testing.assert_allclose(g[4], w[4], rtol=1e-4, atol=1e-9)  # dltx


@pytest.mark.parametrize("per_column", [False, True])
def test_solve_core_matches_pallas_solve(per_column):
    """Full loop, unshuffled: x atol 2e-4, objective rtol 1e-4
    (the tolerances of tests/test_pallas.py)."""
    rng, G, J, gj, active, caps = _problem(3)
    B, npad = gj.shape
    l1 = (rng.random(B) * 0.3 + 0.2).astype(np.float32) if per_column else 0.3
    l2 = (rng.random(B) + 0.5).astype(np.float32) if per_column else 0.5
    active = (gj > np.reshape(l1, (-1, 1))) \
        & (np.arange(npad)[None, :] != J[:, None])
    diag = np.diagonal(G).copy()
    yty = diag[J]
    x0 = np.zeros((B, npad), np.float32)
    want = pallas_cd_solve(*map(jnp.asarray, (G, gj, diag, active, x0, caps,
                                              yty, l1, l2)),
                           1e-10, 3, shuffle=False, interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = S.solve_core(t(G), t(gj), t(diag), t(active), t(x0), t(caps),
                       t(yty), per_col(l1, B, "cpu"), per_col(l2, B, "cpu"),
                       1e-10, None, shuffle=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-4)
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_cd_core_matches_xla_block_solve():
    """The plain oracle itself against the JAX XLA solve (unshuffled, same
    visit order): x atol 2e-4, objective rtol 1e-4, equal sweep counts."""
    rng, G, J, gj, active, caps = _problem(5)
    B, npad = gj.shape
    diag = np.diagonal(G).copy()
    yty = diag[J]
    x0 = np.zeros((B, npad), np.float32)
    want = cd_solve_block(*map(jnp.asarray, (G, gj, diag, active, x0, caps,
                                             yty)), 0.3, 0.5, 1e-10, 3,
                          shuffle=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = _cd_core(t(G), t(gj), t(diag), t(active), t(x0), t(caps), t(yty),
                   0.3, 0.5, 1e-10, None, shuffle=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_shuffled_solves_reach_the_same_optimum():
    """Shuffled orders (torch.Generator) differ from the JAX stream but
    converge to the same strongly convex optimum."""
    rng, G, J, gj, active, caps = _problem(7)
    B, npad = gj.shape
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    diag = np.diagonal(G).copy()
    args = (t(G), t(gj), t(diag), t(active), torch.zeros(B, npad), t(caps),
            t(diag[J]))
    a = S.solve_core(*args, per_col(0.3, B, "cpu"), per_col(0.5, B, "cpu"),
                     1e-10, torch.Generator().manual_seed(1))
    b = _cd_core(*args, 0.3, 0.5, 1e-10, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(a[4].numpy(), b[4].numpy(), rtol=1e-4)


def test_sweep_validates_and_stays_plain_on_cpu():
    rng, G, J, gj, active, caps = _problem(0)
    ops = [torch.from_numpy(np.ascontiguousarray(a))
           for a in _sweep_operands(rng, G, gj, active)]
    before = S.cd_sweep.launches
    S.cd_sweep(*ops)
    assert S.cd_sweep.launches == before
    bad = list(ops)
    bad[2] = ops[2].to(torch.int32)            # act must be int8
    with pytest.raises(ValueError):
        S.cd_sweep(*bad)


def _row_bf16x3(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """The schedule of the card's whole-array sweep (csrc/sweep_panel.cu at
    a group width of 128, windows of one) in PyTorch: per chunk with work
    in visit order, the GS chain on q's f32 chunk tile, then the flush
    q += dx . G[chunk rows, :] in bf16x3 (hi . hi + hi . lo + lo . hi,
    float32 sums), reading G[n, chunk] for G[chunk, n] as the kernel does
    (G is symmetric)."""
    def mm(d, g_rows):
        dh, dl = S.split_bf16(d)
        gh, gl = S.split_bf16(g_rows)
        f = lambda a: a.to(torch.float32)
        return (f(dh) @ f(gh).T + f(dl) @ f(gh).T) + f(dh) @ f(gl).T

    x, q = x.clone(), q.clone()
    lv, d = live[:, 0], diag2d[0]
    l1, l2, cap, t0, tol = regs.unbind(dim=1)
    dltx = torch.zeros(gj.shape[0])
    for c, h in zip(perm.tolist(), has.tolist()):
        if not h:
            continue
        sl = slice(c * 128, (c + 1) * 128)
        okf = act[:, sl].to(torch.float32) * lv[:, None]
        dx = S._gs_chain(gj[:, sl], x[:, sl], q[:, sl].clone(), okf, d[sl],
                         G[sl, sl], l1, l2)
        x[:, sl] += dx
        dltx += (dx * dx).sum(dim=1)
        q += mm(dx, G[:, sl])
    end = S._end_of_sweep(lv, dltx, cap, t0, tol)
    return x, q, end[:, None], lv[:, None].clone(), dltx[:, None]


def _coupled_row_operands(seed, npad, has, B):
    """One sweep's operands on G = AᵀA of a random binary A whose columns
    co-occur across all chunks (a schedule that dropped a chunk's flush
    would move the later chunks' x), a small x0, every third column dead
    (live = 0)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((300, npad)) < 0.03).astype(np.float32)
    G = A.T @ A
    np.fill_diagonal(G, np.maximum(np.diagonal(G), 1.0))
    J = (np.arange(B) * 7) % (npad - 1)
    gj = G[:, J].T.copy()
    active = (gj > 0.3) & (np.arange(npad)[None, :] != J[:, None])
    x = np.where(active, rng.random(active.shape) * 1e-3, 0.0) \
        .astype(np.float32)
    live = (np.arange(B) % 3 != 2).astype(np.float32)[:, None]
    regs = np.stack([np.full(B, 0.3), np.full(B, 0.5),
                     np.where(np.arange(B) % 4, 200.0, 1.0),
                     np.zeros(B), np.full(B, 1e-6)], axis=1).astype(np.float32)
    perm = rng.permutation(npad // 128).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        G, gj, active.astype(np.int8), x, x @ G, live,
        np.diagonal(G).reshape(1, npad).copy(), regs, perm,
        np.array(has, np.int32))]


@pytest.mark.parametrize("npad,B,has", [(384, 40, [1, 0, 1]),
                                        (512, 32, [0, 1, 1, 0]),
                                        (512, 33, [1, 1, 1, 1])])
def test_row_bf16x3_schedule_matches_plain(npad, B, has):
    """The card kernel's schedule with bf16x3 flushes agrees with the plain
    version within the card check's tolerances: x 1e-4 abs, q 1e-4 of
    max |q|, live and nit equal, dltx rtol 1e-3; the flushed q is x'G."""
    ops = _coupled_row_operands(31, npad, has, B)
    got = _row_bf16x3(*ops)
    ref = S.cd_sweep_plain(*ops)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    assert (got[0] - ops[3]).abs().max().item() > 1e-4   # the sweep moved x
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    torch.testing.assert_close(got[4], ref[4], rtol=1e-3, atol=1e-9)
    assert (got[1] - got[0] @ ops[0]).abs().max().item() <= 1e-4 * qscale


def test_ml1m_shape_routes_to_the_whole_array_sweep():
    """MovieLens-1M's 3,706 rated movies pad to 4096, the compact threshold
    itself, so every block of such a learn solves on the whole-array sweep
    on the card."""
    assert bucket_npad(3706) == 4096
    assert pick_impl(4096, torch.device("cuda"), 4096) == "sweep"
    assert pick_impl(bucket_npad(3706), torch.device("cpu"), 4096) == "plain"
