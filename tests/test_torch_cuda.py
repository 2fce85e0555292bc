"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not reach (block sizes off the kernels'
tile multiples, output slices).  Needs an NVIDIA card and nvcc; skipped
elsewhere.  Run on the card with ``python -m pytest -m cuda
tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu_torch.checks import ranked_mismatches
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops import densify as D
from slim_tpu_torch.ops import gram as G
from slim_tpu_torch.ops import pack as P
from slim_tpu_torch.ops.cd_kernel import _cd_core, per_col, screen
from slim_tpu_torch.predict import predict_topn
from slim_tpu_torch.types import CSR
from test_torch_predict_sparse import assert_topn_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    G.pin_f32()
    return torch.device("cuda", 0)


def test_densify_ragged_and_sliced(dev, rng):
    npad, W, R = 384, 40, 300
    ids = rng.integers(-2, npad + 3, (W, R)).astype(np.int32)
    vals = rng.integers(1, 4, (W, R)).astype(np.float32)
    idsT, valsT = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    wmax = D.densify_meta(idsT, npad)
    wide = torch.zeros((npad, R + 17), device=dev)
    got = D.densify(idsT, valsT, wmax, npad, out=wide[:, 5:5 + R])
    ref = D.densify_plain(idsT, valsT, wmax, npad,
                          torch.zeros((npad, R), device=dev))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert wide[:, :5].abs().sum() == 0 and wide[:, 5 + R:].abs().sum() == 0
    g8 = D.densify(idsT, None, wmax, npad, out_dtype=torch.int8)
    r8 = D.densify_plain(idsT, None, wmax, npad, torch.zeros(
        (npad, R), dtype=torch.int8, device=dev))
    assert torch.equal(g8, r8)


def test_pack_ragged(dev, rng):
    B, K = 5, 700
    x = np.where(rng.random((B, K)) < 0.3, rng.random((B, K)) + 0.5, 0) \
        .astype(np.float32)
    c = (x > np.float32(1e-7)).sum(1)
    off = np.zeros(B, np.int32)
    np.cumsum(c[:-1], out=off[1:])
    xd, od = torch.from_numpy(x).to(dev), torch.from_numpy(off).to(dev)
    Tpad = int(c.sum()) - 3          # the last entries fall off the end
    got, ref = P.pack(xd, od, 1e-7, Tpad), P.pack_plain(xd, od, 1e-7, Tpad)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _pack_case(dev, rng, B, K, cut=0, misalign=False):
    """pack vs pack_plain, bit for bit, on a (B, K) block with ~4% entries
    over eps and some just under it; ``cut`` entries fall off the end
    (Tpad = T - cut); ``misalign`` puts x 4 bytes off a 16-byte boundary,
    so the kernel takes its scalar loads."""
    x = np.where(rng.random((B, K)) < 0.04, rng.random((B, K)) + 0.5, 0.0)
    x[rng.random((B, K)) < 0.01] = 5e-8
    x = x.astype(np.float32)
    c = (x > np.float32(1e-7)).sum(1)
    off = np.zeros(B, np.int32)
    np.cumsum(c[:-1], out=off[1:])
    flat = torch.zeros(B * K + 1, device=dev)
    xd = flat[1:].view(B, K) if misalign else flat[:B * K].view(B, K)
    xd.copy_(torch.from_numpy(x))
    od = torch.from_numpy(off).to(dev)
    Tpad = int(c.sum()) - cut
    launches = P.pack.launches
    got, ref = P.pack(xd, od, 1e-7, Tpad), P.pack_plain(xd, od, 1e-7, Tpad)
    torch.cuda.synchronize()
    assert P.pack.launches == launches + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("B,K,cut,misalign", [(1024, 28672, 0, False),
                                              (9, 300, 0, False),
                                              (6, 301, 5, False),
                                              (40, 8200, 50, False),
                                              (8, 1024, 0, True)])
def test_pack_matches_plain(dev, rng, B, K, cut, misalign):
    """The main path's block; K = 300 (a multiple of 4, not of 16); K = 301
    (scalar loads); a row just past one 8,192-column tile with Tpad below
    T; an x off the 16-byte alignment."""
    _pack_case(dev, rng, B, K, cut, misalign)


def test_predict_tie_order_matches_cpu(dev, rng):
    """A model of equal weights and binary histories: integer scores with
    many ties, exact on both devices.  The card's top-10 equals the CPU
    path's, lowest id first among equal scores (lax.top_k's order)."""
    n, nusers = 300, 200
    W = (rng.random((n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(W, 0.0)
    r, c = np.nonzero(W)
    model = CSR.from_ijv(r, c, W[r, c], nrows=n, ncols=n)
    h = (rng.random((nusers, n)) < 0.03).astype(np.float32)
    hr, hc = np.nonzero(h)
    hist = CSR.from_ijv(hr, hc, h[hr, hc], nrows=nusers, ncols=n).binarize()
    ids_g, sc_g, cnt_g = predict_topn(model, hist, nrcmds=10, device=dev)
    ids_c, sc_c, cnt_c = predict_topn(model, hist, nrcmds=10, device="cpu")
    np.testing.assert_array_equal(cnt_g, cnt_c)
    np.testing.assert_array_equal(sc_g, sc_c)
    np.testing.assert_array_equal(ids_g, ids_c)
    tied = (sc_c[:, 1:] == sc_c[:, :-1]) & (ids_c[:, 1:] >= 0)
    assert tied.sum() > 100
    assert np.all(ids_c[:, 1:][tied] > ids_c[:, :-1][tied])


def _solve_inputs(dev, rng, n, npad, B):
    mat = random_csr(rng, 3 * n, n, density=0.08)
    Gm = G.compute_gram(CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr,
                                        mat.indices, mat.data), "device",
                        pad_to=npad, device=dev)
    J = torch.arange(B, device=dev, dtype=torch.int32) % n
    gj = Gm[:, J.long()].T.contiguous()
    act = screen(gj, J, per_col(0.3, B, dev))
    caps = torch.full((B,), 100, dtype=torch.int32, device=dev)
    diag = torch.diagonal(Gm)
    return Gm, gj, diag, act, caps, diag[J.long()]


SOLVES = {"sweep": (S.solve_core, S.cd_sweep),
          "sweep_large": (S.solve_large_core, S.cd_sweep_large),
          "v3": (lambda *a, **k: S.solve_panel_core(*a, variant="v3", **k),
                 S.cd_sweep_v3),
          "eager": (lambda *a, **k: S.solve_panel_core(*a, variant="eager",
                                                       **k),
                    S.cd_sweep_eager)}


@pytest.mark.parametrize("impl,npad,B", [("sweep", 384, 50),
                                         ("sweep_large", 1024, 70),
                                         ("v3", 2048, 70),
                                         ("eager", 1024, 70)])
def test_solve_on_card_matches_plain_oracle(dev, rng, impl, npad, B):
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, 200, npad, B)
    l1, l2 = per_col(0.3, B, dev), per_col(0.5, B, dev)
    x0 = torch.zeros_like(gj)
    fn, wrapper = SOLVES[impl]
    launches = wrapper.launches
    got = fn(Gm, gj, diag, act, x0, caps, yty, l1, l2, 1e-10, None,
             shuffle=False)
    assert wrapper.launches > launches
    cpu = [t.cpu() for t in (Gm, gj, diag, act, x0, caps, yty)]
    ref = _cd_core(*cpu, 0.3, 0.5, 1e-10, None, shuffle=False)
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=0, atol=2e-4)
    torch.testing.assert_close(got[4].cpu(), ref[4], rtol=1e-4, atol=1e-4)


def _panel_sweep_case(dev, rng, variant, npad, B, has=None):
    """One row-major sweep on the card against its plain version (default
    ``has``: every third group inactive): x atol 1e-4, q rel 1e-4, live
    and nit equal, one launch counted."""
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, 600, npad, B)
    ng = npad // S.GROUP
    x = torch.where(act, torch.rand(act.shape, device=dev) * 0.05, 0.0)
    live = (torch.rand(B, 1, device=dev) < 0.9).float()
    regs = torch.tensor([0.3, 0.5, 50.0, 0.0, 1e-7], device=dev) \
        .repeat(B, 1).contiguous()
    perm = torch.randperm(ng, device=dev).to(torch.int32)
    has = (torch.arange(ng, device=dev) % 3 != 1) if has is None \
        else torch.tensor(has, device=dev)
    args = (Gm, gj, act.to(torch.int8), x, x @ Gm, live,
            diag.reshape(1, npad).contiguous(), regs, perm,
            has.to(torch.int32))
    kern = S.cd_sweep_v3 if variant == "v3" else S.cd_sweep_eager
    plain = S.cd_sweep_v3_plain if variant == "v3" else S.cd_sweep_eager_plain
    launches = kern.launches
    got, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == launches + 1
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


@pytest.mark.parametrize("variant,npad,B", [("v3", 2048, 70),
                                            ("eager", 1536, 33)])
def test_panel_sweep_kernel_matches_plain(dev, rng, variant, npad, B):
    """One sweep at a B off the kernels' tiles, inactive groups inside
    windows."""
    _panel_sweep_case(dev, rng, variant, npad, B)


@pytest.mark.parametrize("variant,npad,B,has", [
    ("v3", 4096, 1024, [0, 1, 1, 1, 0, 0, 0, 0]),
    ("eager", 2048, 200, [1, 0, 1, 1])])
def test_panel_sweep_kernel_windows(dev, rng, variant, npad, B, has):
    """v3 with a window whose first slot has no work and an all-inactive
    window at the main path's B; eager at a B off the 64- and 128-row
    tiles of its products."""
    _panel_sweep_case(dev, rng, variant, npad, B, has)


@pytest.mark.parametrize("npad,B", [(384, 512), (4096, 512), (512, 300)])
def test_row_sweep_kernel_matches_plain(dev, rng, npad, B):
    """The whole-array sweep at the synth and ML-1M paths' shapes and at a
    B off its blocks: every third chunk without work, ~10% dead columns.  x
    atol 1e-4, q rel 1e-4, live and nit equal, one launch counted."""
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, npad - 90, npad,
                                                 B)
    nch = npad // 128
    x = torch.where(act, torch.rand(act.shape, device=dev) * 0.05, 0.0)
    live = (torch.rand(B, 1, device=dev) < 0.9).float()
    regs = torch.tensor([0.3, 0.5, 50.0, 0.0, 1e-7], device=dev) \
        .repeat(B, 1).contiguous()
    perm = torch.randperm(nch, device=dev).to(torch.int32)
    has = (torch.arange(nch, device=dev) % 3 != 1).to(torch.int32)
    args = (Gm, gj, act.to(torch.int8), x, x @ Gm, live,
            diag.reshape(1, npad).contiguous(), regs, perm, has)
    launches = S.cd_sweep.launches
    ref = S.cd_sweep_plain(*args)
    qscale = max(1.0, ref[1].abs().max().item())
    got = S.cd_sweep(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    assert S.cd_sweep.launches == launches + 1


@pytest.mark.parametrize("npad,B,has", [
    (1024, 70, [0, 1]),
    (1536, 33, [1, 0, 1]),
    (4096, 1024, [0, 1, 1, 1, 0, 0, 0, 0]),
    # FSLIM's v4 union widths at its B: the flush's 128- and 256-wide tiles
    (6144, 1024, [1] * 12),
    (8192, 1024, [1] * 16),
    # B off the flush's tile widths; a window whose middle slot has no work
    (4096, 1000, [1, 1, 0, 1, 1, 1, 1, 1]),
    (4096, 654, [1, 0, 1, 1, 1, 1, 0, 1]),
    # a partial last window of one group
    (2560, 300, [1, 1, 1, 1, 1])])
def test_large_sweep_kernel_matches_plain(dev, rng, npad, B, has):
    """One coordinate-major sweep: partial last windows (1, 2 and 3
    groups), windows whose first or middle slot has no work, an
    all-inactive window, FSLIM's union widths, B off the flush's tiles,
    columns with live = 0: x atol 1e-4, q rel 1e-4, live and nit equal."""
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, 600, npad, B)
    ng = npad // S.GROUP
    x = torch.where(act, torch.rand(act.shape, device=dev) * 0.05, 0.0)
    live = (torch.rand(1, B, device=dev) < 0.8).float()
    regsT = torch.tensor([0.3, 0.5, 50.0, 0.0, 1e-7], device=dev)[:, None] \
        .repeat(1, B).contiguous()
    perm = torch.randperm(ng, device=dev).to(torch.int32)
    xT = x.T.contiguous()
    args = (Gm, gj.T.contiguous(), act.T.to(torch.int8).contiguous(), xT,
            Gm @ xT, live, diag.reshape(1, npad).contiguous(), regsT, perm,
            torch.tensor(has, dtype=torch.int32, device=dev))
    launches = S.cd_sweep_large.launches
    got, ref = S.cd_sweep_large(*args), S.cd_sweep_large_plain(*args)
    torch.cuda.synchronize()
    assert S.cd_sweep_large.launches == launches + 1
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


def test_gram_on_card_matches_host(dev, rng):
    for implicit in (True, False):
        mat = random_csr(rng, 300, 150, density=0.1, implicit=implicit)
        m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                            mat.data)
        got = G.gram_device(m, pad_to=256, device=dev).cpu().numpy()
        np.testing.assert_allclose(got, G.gram_host(m, 256), rtol=1e-6)


def _skewed_model(rng, n, nnz_row, long_row, long_len):
    """A model of ``nnz_row`` entries per row, plus one row ``long_row``
    of ``long_len`` entries (a popular item that neighbours most
    targets)."""
    mr = np.concatenate([np.repeat(np.arange(n), nnz_row),
                         np.full(long_len, long_row)])
    mc = np.concatenate([rng.integers(0, n, n * nnz_row),
                         rng.choice(n, long_len, replace=False)])
    return CSR.from_ijv(mr, mc, rng.random(mr.size).astype(np.float32)
                        + 0.01, nrows=n, ncols=n)


@pytest.mark.parametrize("route", ["rows", "coo"])
def test_sparse_routes_on_card_match_cpu(dev, rng, monkeypatch, route):
    """Sparse top-N, 1-vs-k and candidate scores on the card against the
    CPU path, score rows and COO, on a skewed model."""
    from slim_tpu_torch.predict import (predict_candidate_scores,
                                        predict_topn_1vsk)

    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD",
                       "1" if route == "coo" else "0")
    n, nusers = 3000, 700
    model = _skewed_model(rng, n, 20, 5, 2500)
    hist = random_csr(rng, nusers, n, density=0.01, implicit=True)
    hist = CSR.from_arrays(nusers, n, hist.indptr, hist.indices, None)
    cand = rng.integers(-1, n, (nusers, 40)).astype(np.int32)
    for fn, args in ((predict_topn, dict(nrcmds=10)),
                     (predict_topn_1vsk, dict(negitems=cand, nrcmds=10))):
        got = fn(model, hist, sparse=True, device=dev, **args)
        ref = fn(model, hist, sparse=True, device="cpu", **args)
        assert_topn_match(got, ref)
    cs, ns = predict_candidate_scores(model, hist, cand, sparse=True,
                                      device=dev)
    cs_c, ns_c = predict_candidate_scores(model, hist, cand, sparse=True,
                                          device="cpu")
    np.testing.assert_array_equal(ns, ns_c)
    np.testing.assert_allclose(cs, cs_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["rows", "coo"])
def test_sparse_step_memory_on_card(dev, rng, monkeypatch, route):
    """Under a skewed model one step of the ragged scoring takes at most
    STEP_BYTES of device memory beyond the route's inputs: the peak over a
    score block's steps (score rows; the block itself set aside, no top-k
    run) or of one COO step, at a 16 MiB budget.  One unbounded step
    measures the bytes a pair takes, held to PAIR_BYTES, the constant that
    turns the budget into pairs per step."""
    import slim_tpu_torch.predict as PR

    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD",
                       "1" if route == "coo" else "0")
    n, nusers = 20000, 1024
    model = _skewed_model(rng, n, 10, 3, 19000)
    h = random_csr(rng, nusers, n, density=0.002, implicit=True)
    hr = np.concatenate([np.repeat(np.arange(nusers), np.diff(h.indptr)),
                         np.arange(nusers)])
    hc = np.concatenate([h.indices, np.full(nusers, 3)])
    hist = CSR.from_ijv(hr, hc, np.ones(hr.size, np.float32), nrows=nusers,
                        ncols=n).binarize()

    def first_step(step_bytes):
        """(device bytes at the peak of the route's first step beyond its
        inputs and its score block, the pairs that step expands)."""
        monkeypatch.setattr(PR, "STEP_BYTES", step_bytes)
        r = PR._Route(model, hist, None, True, dev)             # uploads
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        if route == "rows":
            users, sc = next(r.score_blocks(hist, nusers, True))
            held = sc.numel() * sc.element_size()
            pairs = int(r.L_h[:int(hist.indptr[len(users)])].sum())
        else:
            u0, u1, keys, sums = next(r.coo_runs(hist, True))
            held = 0
            end = int(hist.indptr[u1])
            pairs = int(r.L_h[:end].sum() + r.ok_h[:end].sum())
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base - held, pairs

    budget = 1 << 24
    step, _ = first_step(budget)
    assert step <= budget, (step, budget)
    whole, pairs = first_step(1 << 34)
    assert pairs > 4 * budget // PR.PAIR_BYTES, pairs    # many budgets' worth
    print(f"{route}: step peak {step} bytes at a {budget}-byte budget; "
          f"{whole / pairs:.2f} bytes per pair over {pairs} pairs")
    assert whole <= pairs * PR.PAIR_BYTES, (whole / pairs, PR.PAIR_BYTES)


def test_fslim_learn_on_card_matches_cpu(dev, rng):
    """A compact FSLIM learn (unions and masks on the card, blocks on the
    sweep kernels) against the CPU path: loss rtol 1e-4, nnz ±1%, at most
    nnbrs coordinates per column."""
    from slim_tpu_torch import SlimConfig, learn

    mat = random_csr(rng, 400, 900, density=0.02, implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    cfg = SlimConfig(l1r=0.2, l2r=0.5, nnbrs=8, simtype="cos",
                     block_size=128, compact_threshold=256)
    sweeps = (S.cd_sweep, S.cd_sweep_large)
    launches = sum(w.launches for w in sweeps)
    mg, sg = learn(m, cfg, device=dev)
    assert sum(w.launches for w in sweeps) > launches and sg["unions"]
    mc, sc = learn(m, cfg, device="cpu")
    np.testing.assert_allclose(sg["loss"], sc["loss"], rtol=1e-4)
    assert abs(sg["nnz"] - sc["nnz"]) <= 0.01 * sc["nnz"]
    assert (mg.to_dense() > 0).sum(axis=0).max() <= 8


def _mixed_regs(B, dev, layout_rows=True):
    """Per-column [l1r, l2r, cap, t0, optTol]: the first half of the
    columns at (2, 2) with cap 40, the rest at (1, 1) with cap 60, as a
    packed grid block that straddles two points."""
    half = torch.arange(B, device=dev) < B // 2
    regs = torch.stack([torch.where(half, 2.0, 1.0),
                        torch.where(half, 2.0, 1.0),
                        torch.where(half, 40.0, 60.0),
                        torch.full((B,), 3.0, device=dev),
                        torch.full((B,), 1e-7, device=dev)], dim=1)
    return (regs if layout_rows else regs.T).contiguous()


@pytest.mark.parametrize("npad,B", [(4096, 512), (512, 300)])
def test_row_sweep_with_mixed_regs(dev, rng, npad, B):
    """The whole-array sweep with two (l1r, l2r, cap) groups of columns in
    one block against its plain version: x atol 1e-4, q rel 1e-4, live and
    nit equal; the two halves' x differ (each reads its own regs)."""
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, npad - 90, npad,
                                                 B)
    x = torch.where(act, torch.rand(act.shape, device=dev) * 0.05, 0.0)
    live = torch.ones(B, 1, device=dev)
    nch = npad // 128
    args = (Gm, gj, act.to(torch.int8), x, x @ Gm, live,
            diag.reshape(1, npad).contiguous(), _mixed_regs(B, dev),
            torch.randperm(nch, device=dev).to(torch.int32),
            torch.ones(nch, dtype=torch.int32, device=dev))
    ref = S.cd_sweep_plain(*args)
    got = S.cd_sweep(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    flat = _mixed_regs(B, dev)
    flat[:, :2] = 1.0
    other = S.cd_sweep_plain(*args[:7], flat, *args[8:])
    assert not torch.equal(other[0][:B // 2], ref[0][:B // 2])
    torch.testing.assert_close(other[0][B // 2:], ref[0][B // 2:], rtol=0,
                               atol=0)


@pytest.mark.parametrize("npad,has", [(4096, [1, 1, 1, 1, 0, 0, 0, 0]),
                                      (2560, [1, 0, 1, 1, 1])])
def test_flush_launches_count_the_windows(dev, rng, npad, has):
    """One coordinate-major sweep adds one flush launch a window of K_FLUSH
    positions, the partial last one too (a window whose slots have no
    work launches and exits)."""
    B = 64
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, 300, npad, B)
    ng = npad // S.GROUP
    xT = torch.zeros(npad, B, device=dev)
    regsT = torch.tensor([0.3, 0.5, 50.0, 0.0, 1e-7], device=dev)[:, None] \
        .repeat(1, B).contiguous()
    args = (Gm, gj.T.contiguous(), act.T.to(torch.int8).contiguous(), xT,
            Gm @ xT, torch.ones(1, B, device=dev),
            diag.reshape(1, npad).contiguous(), regsT,
            torch.randperm(ng, device=dev).to(torch.int32),
            torch.tensor(has, dtype=torch.int32, device=dev))
    flushes = S.cd_sweep_large.flush_launches
    S.cd_sweep_large(*args)
    torch.cuda.synchronize()
    assert S.cd_sweep_large.flush_launches == flushes + -(-ng // S.K_FLUSH)


@pytest.mark.parametrize("npad,B,has,g0,nslots", [
    (28672, 1024, [1] * 56, 0, 4),
    (6144, 1024, [1] * 12, 8, 4),
    (4096, 654, [1, 1, 1, 1, 1, 0, 1, 1], 4, 4),
    (2560, 33, [1] * 5, 4, 1),
    (2048, 256, [0, 0, 0, 0], 0, 4)])
def test_flush_window_matches_plain(dev, rng, npad, B, has, g0, nslots):
    """The window flush alone against its plain version: ML-20M's shape,
    FSLIM's 128-wide tiles, B off the tiles with a slot without work, an
    odd B in a partial window, a window without work (q untouched).  q is
    ~100 times the window's increment, and the flush is held to 1e-5 of
    the largest increment plus two float32 ulps of the largest q: products
    summed onto q inside the tensor cores (whose f32 sums drop low bits)
    miss that by far.  The feed-only ring leaves q untouched."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    ng = npad // S.GROUP
    gh, gl = S.split_bf16(torch.randn(npad, npad, device=dev, generator=gen))
    dh, dl = S.split_bf16(torch.randn(S.K_FLUSH * B * S.GROUP, device=dev,
                                      generator=gen) * 1e-2)
    perm = torch.randperm(ng, device=dev, generator=gen).to(torch.int32)
    hs = torch.tensor(has, dtype=torch.int32, device=dev)
    q = torch.randn(npad, B, device=dev, generator=gen) * 100.0
    ref = S.flush_window_plain(gh, gl, dh, dl, perm, hs, q.clone(), g0,
                               nslots)
    got = S.flush_window(gh, gl, dh, dl, perm, hs, q.clone(), g0, nslots)
    torch.cuda.synchronize()
    eps = torch.finfo(torch.float32).eps
    tol = 1e-5 * (ref - q).abs().max().item() \
        + 2 * eps * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    if not any(has[g0:g0 + nslots]):
        assert torch.equal(got, q)
    fed = S.flush_window(gh, gl, dh, dl, perm, hs, q.clone(), g0, nslots,
                         feed_only=True)
    torch.cuda.synchronize()
    assert torch.equal(fed, q)


@pytest.mark.parametrize("npad,B,has", [(28672, 1024, None),
                                        (4096, 70, [1, 0, 1, 1, 1, 0, 1, 1])])
def test_large_sweep_with_mixed_regs(dev, rng, npad, B, has):
    """The coordinate-major sweep with two (l1r, l2r, cap) groups of
    columns against its plain version (the ML-20M grid's block, all groups
    active; and a small one with inactive groups): x atol 1e-4, q rel 1e-4,
    live and nit equal."""
    Gm, gj, diag, act, caps, yty = _solve_inputs(dev, rng, 600, npad, B)
    ng = npad // S.GROUP
    x = torch.where(act, torch.rand(act.shape, device=dev) * 0.05, 0.0)
    xT = x.T.contiguous()
    has = torch.ones(ng, dtype=torch.int32, device=dev) if has is None \
        else torch.tensor(has, dtype=torch.int32, device=dev)
    args = (Gm, gj.T.contiguous(), act.T.to(torch.int8).contiguous(), xT,
            Gm @ xT, torch.ones(1, B, device=dev),
            diag.reshape(1, npad).contiguous(),
            _mixed_regs(B, dev, layout_rows=False),
            torch.randperm(ng, device=dev).to(torch.int32), has)
    got, ref = S.cd_sweep_large(*args), S.cd_sweep_large_plain(*args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    qscale = max(1.0, ref[1].abs().max().item())
    assert (got[1] - ref[1]).abs().max().item() <= 1e-4 * qscale
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


def test_admm_on_card_matches_f64(dev):
    """ADMM's float32 solve on the card against its float64 version on the
    card (tests/test_admm.py's bar: W atol 2e-2, fit within 1e-3 rel);
    zero diagonal, W >= 0."""
    from slim_tpu_torch.solvers import admm as A

    mat = random_csr(np.random.default_rng(11), 3000, 400, density=0.05,
                     implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    T = G.compute_gram(m, "device", pad_to=512, device=dev)
    W, err, obj = A.admm_solve(T, 2.0, 2.0)
    W64 = A.admm_solve_f64(T, 2.0, 2.0)
    torch.testing.assert_close(W.double(), W64, rtol=0, atol=2e-2)
    e64, _ = A.admm_stats(T.double(), W64, 2.0, 2.0)
    assert abs(err - e64) <= 1e-3 * e64 and obj >= err > 0
    assert torch.diagonal(W).abs().max().item() < 1e-3
    assert W.min().item() >= 0


def test_checkpoint_resume_on_card(dev, tmp_path):
    """A checkpointed learn on the card resumed after a lost block equals
    the uninterrupted learn: the lost block's sweeps are launched again,
    no other block's, and the model is the same to 1e-6."""
    import glob
    import os

    from slim_tpu_torch import SlimConfig, learn

    mat = random_csr(np.random.default_rng(12), 600, 500, density=0.05,
                     implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, block_size=128,
                     checkpoint_dir=str(tmp_path))
    m1, s1 = learn(m, cfg, device=dev)
    files = sorted(glob.glob(str(tmp_path / "cdblk_*")))
    assert len(files) == 4
    lost = np.load(files[2])
    os.remove(files[2])
    launches = S.cd_sweep.launches
    m2, s2 = learn(m, cfg, device=dev)
    assert S.cd_sweep.launches - launches == int(lost["sweeps"])
    np.testing.assert_allclose(m2.to_dense(), m1.to_dense(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(s2["loss"], s1["loss"], rtol=1e-6)


def _dist_calls(m, cfg, model):
    from slim_tpu_torch.parallel import dist as PD
    from slim_tpu_torch.parallel import launch as L

    model = CSR.from_arrays(model.nrows, model.ncols, model.indptr,
                            model.indices, model.data)
    return [L.Call("replicated", PD.distributed_learn, (m, cfg)),
            L.Call("blockwise", PD.distributed_learn_blockwise, (m, cfg)),
            L.Call("sharded_g", PD.distributed_learn_sharded_g, (m, cfg)),
            L.Call("predict", PD.sharded_predict, (model, m),
                   dict(nrcmds=10))]


@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (2, "gloo")])
def test_distributed_learns_on_card_match_one_device(dev, ranks, backend):
    """The three distributed learns in a one-rank NCCL world and in a
    2-rank gloo world on one card: loss within 1e-5 rel and nnz within 1%
    of the single-device learn on the card, the same model on every rank,
    each learn through densify, the whole-array sweep and pack."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.parallel import launch as L

    mat = random_csr(np.random.default_rng(13), 800, 600, density=0.04,
                     implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, block_size=64)
    ref_model, ref = learn(m, cfg, device=dev)
    out = L.run_world(L.run_calls, ranks, args=(_dist_calls(m, cfg,
                                                            ref_model),
                                                "cuda"),
                      device="cuda", backend=backend, timeout_s=600)
    assert out[0]["replicated"]["result"][1]["assembly"] == "card"
    for mode in ("replicated", "blockwise", "sharded_g"):
        (model, st) = out[0][mode]["result"]
        assert abs(st["loss"] - ref["loss"]) <= 1e-5 * ref["loss"], mode
        assert abs(st["nnz"] - ref["nnz"]) <= 0.01 * ref["nnz"], mode
        assert all(r[mode]["result"][0] == model for r in out), mode
        assert all(out[0][mode]["launches"][k] for k in
                   ("densify", "cd_sweep", "pack")), out[0][mode]
    ids, sc, cnt = out[0]["predict"]["result"]
    want = predict_topn(ref_model, m, nrcmds=10, device=dev)
    assert_topn_match((ids, sc, cnt), want)


def test_one_rank_nccl_world_without_torchrun(dev):
    """``make_mesh()`` with no device and no torchrun environment: a
    one-rank NCCL world on the card, whose sharded Gram is the card's."""
    import torch.distributed as dist

    from slim_tpu_torch.parallel import dist as PD
    from slim_tpu_torch.parallel import make_mesh

    mat = random_csr(np.random.default_rng(5), 300, 150, density=0.1,
                     implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        got = PD.sharded_gram_sparse(m, mesh, pad_to=256)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      G.gram_host(m, 256))
    finally:
        dist.destroy_process_group()


def test_native_route_matches_card_dense(dev, rng, monkeypatch):
    """The native host route against the card's dense route on the same
    users: the same counts, scores within 1e-5 rel, ids equal up to the
    order within exact ties; an unpinned call takes the native route."""
    from slim_tpu_torch import native
    from slim_tpu_torch import predict as PR
    from slim_tpu_torch.checks import tie_order_mismatches

    model = _skewed_model(rng, 3000, 30, 7, 2500)
    hist = random_csr(rng, 2000, 3000, density=0.02)
    hist = CSR.from_arrays(hist.nrows, hist.ncols, hist.indptr, hist.indices,
                           hist.data)
    card = predict_topn(model, hist, nrcmds=10, sparse=False, device=dev)
    assert PR.last_route == "dense"
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    got = predict_topn(model, hist, nrcmds=10, device=dev)
    assert PR.last_route == "native"
    np.testing.assert_array_equal(got[2], card[2])
    np.testing.assert_allclose(got[1], card[1], rtol=1e-5, atol=1e-6)
    assert tie_order_mismatches(got[0], *card)[1] == 0
    for a, b in zip(got, native.predict_topn(model, hist, nrcmds=10)):
        np.testing.assert_array_equal(a, b)


def _reference_assembly(monkeypatch, sizes):
    """CD learns assemble through ``native.csr_from_blocks`` over the same
    blocks (as host arrays); each held block's entry count is appended to
    ``sizes``."""
    from slim_tpu_torch import native
    from slim_tpu_torch.solvers import cd as C

    def assemble(coord, target, vals, n):
        host = [[a.cpu().numpy() for a in lst]
                for lst in (coord, target, vals)]
        return CSR.from_arrays(n, n, *native.csr_from_blocks(*host, n))

    real = C._Held.add
    monkeypatch.setattr(C._Held, "add", lambda self, rec, key=0: (
        sizes.append(len(rec.vals)), real(self, rec, key))[1])
    monkeypatch.setattr(C, "_assemble", assemble)


def _move_at(monkeypatch, at, sizes):
    """Held entries moved to host memory at block ``at``: the card's
    budget patched to the bytes of the blocks before it."""
    from slim_tpu_torch.solvers import cd as C

    assert sizes[at] > 0
    budget = 12 * sum(sizes[:at])
    monkeypatch.setattr(C, "_card_budget", lambda dev: budget)


def _same_model(got, ref):
    (m, s), (r, t) = got, ref
    assert m.nnz == r.nnz > 0
    np.testing.assert_array_equal(m.indptr, r.indptr)
    np.testing.assert_array_equal(m.indices, r.indices)
    np.testing.assert_array_equal(m.data, r.data)
    assert m.indices.dtype == r.indices.dtype and m.data.dtype == r.data.dtype
    for key in ("loss", "fit", "niters", "sweeps"):
        assert s[key] == t[key], key


def test_ml20m_shaped_assembly_equals_native(dev, monkeypatch):
    """A quarter-scale ML-20M-shaped learn on the card (wide blocks): its
    entries held on the card and sorted there (``assembly`` "card"),
    moved to host memory at block 1 and sorted there ("host"), and the
    reference (``native.csr_from_blocks`` over the same blocks) give the
    same model entry for entry."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.datagen import synth_ml20m

    trn = synth_ml20m(seed=0, scale=0.25)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, block_size=1024)
    held = learn(trn, cfg, device=dev)
    assert held[1]["assembly"] == "card"
    sizes = []
    with pytest.MonkeyPatch.context() as mp:
        _reference_assembly(mp, sizes)
        ref = learn(trn, cfg, device=dev)
    _move_at(monkeypatch, 1, sizes)
    moved = learn(trn, cfg, device=dev)
    assert moved[1]["assembly"] == "host"
    _same_model(held, ref)
    _same_model(moved, ref)


def test_checkpointed_card_learn_assembly(dev, tmp_path):
    """A checkpointed learn on the card (each block's arrays copied out
    and written in the phase ``checkpoint``) assembles on the card too
    and gives the model of the same learn without checkpoints, entry for
    entry."""
    from slim_tpu_torch import SlimConfig, learn

    mat = random_csr(np.random.default_rng(12), 600, 500, density=0.05,
                     implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices, None)
    cfg = SlimConfig(l1r=0.5, l2r=0.5, block_size=128)
    first = learn(m, cfg, device=dev)
    ckpt = learn(m, cfg.replace(checkpoint_dir=str(tmp_path)), device=dev)
    assert first[1]["assembly"] == ckpt[1]["assembly"] == "card"
    assert ckpt[1]["phases"]["checkpoint"] > 0
    _same_model(ckpt, first)


def test_card_assembly_peak_memory(dev, monkeypatch):
    """A learn whose entries stay on the card to be sorted there reaches
    no higher ``max_memory_allocated`` than the same learn with its
    entries moved to host memory at the first block, at a quarter-scale
    ML-20M shape."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.datagen import synth_ml20m
    from slim_tpu_torch.solvers import cd as C

    trn = synth_ml20m(seed=0, scale=0.25)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, block_size=1024)
    peaks = {}
    for where in ("card", "host"):
        if where == "host":
            monkeypatch.setattr(C, "_card_budget", lambda dev: 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _, st = learn(trn, cfg, device=dev)
        torch.cuda.synchronize()
        assert st["assembly"] == where
        peaks[where] = torch.cuda.max_memory_allocated(dev)
    assert peaks["card"] <= peaks["host"], peaks


def test_one_history_upload_per_card(dev):
    """learn with no device (the card as "cuda") and get_topn on its
    device pack (whose tensors say "cuda:0") upload the matrix's ids once;
    so do SLIM.train and SLIM.predict with no device."""
    from slim_tpu_torch import SLIM, SLIMatrix, SlimConfig, get_topn, learn

    mat = random_csr(np.random.default_rng(21), 300, 200, density=0.05)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                        mat.data)
    cfg = SlimConfig(l1r=0.5, l2r=0.5)
    model, stats = learn(m, cfg, keep_device_model=True)
    get_topn(model, m, W_dev=stats["W_dev"])
    assert [k for k in m._dev if k[1] == "idx32"] == [("cuda:0", "idx32")]
    sm = SLIMatrix(m.to_scipy())
    slim = SLIM()
    slim.train(cfg, sm)
    slim.predict(sm, nrcmds=10)
    assert [k for k in sm.mat._dev if k[1] == "idx32"] == \
        [("cuda:0", "idx32")]


@pytest.mark.parametrize("valued", [False, True])
def test_densify_bf16_matches_plain(dev, rng, valued):
    """The bfloat16 output (out_kind 2) against densify_plain into
    bfloat16, exact on integer values 1-5 with duplicate ids, into a
    column slice of a wider block; one launch counted on densify_bf16."""
    npad, W, R = 9216, 40, 300
    ids = rng.integers(-2, npad + 3, (W, R)).astype(np.int32)
    ids[1, ::3] = ids[0, ::3]
    vals = rng.integers(1, 6, (W, R)).astype(np.float32)
    idsT = torch.from_numpy(ids).to(dev)
    valsT = torch.from_numpy(vals).to(dev) if valued else None
    wmax = D.densify_meta(idsT, npad)
    wide = torch.zeros((npad, R + 9), dtype=torch.bfloat16, device=dev)
    n16, n32 = D.densify_bf16.launches, D.densify.launches
    got = D.densify_bf16(idsT, valsT, wmax, npad, out=wide[:, 4:4 + R])
    torch.cuda.synchronize()
    assert D.densify_bf16.launches == n16 + 1 and D.densify.launches == n32
    ref = D.densify_plain(idsT, valsT, wmax, npad, torch.zeros(
        (npad, R), dtype=torch.bfloat16, device=dev))
    assert torch.equal(got, ref) and ref.float().max() > 1
    assert wide[:, :4].abs().sum() == 0 and wide[:, 4 + R:].abs().sum() == 0


def _csr_runs(rng, R, npad, long_run=0):
    """Runs of a flat CSR for densify_runs: 0-60 ids each, below npad + 40
    (ids >= npad and >= n_valid drop), unordered, every third run with
    its first id twice; integer values 1-5; with ``long_run`` run 1 has
    that many entries (ids repeating)."""
    lens = rng.integers(0, 61, R)
    lens[3] = 0
    if long_run:
        lens[1] = long_run
    idx = rng.integers(0, npad + 40, int(lens.sum())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for r in range(0, R, 3):
        if lens[r] > 1:
            idx[starts[r] + 1] = idx[starts[r]]
    vals = rng.integers(1, 6, idx.size).astype(np.float32)
    return idx, vals, starts, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("row_major", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_densify_runs_kernel_matches_plain(dev, rng, dtype, row_major,
                                           accumulate):
    """densify_runs's kernel against densify_runs_plain, exact on integer
    values, at a ragged shape (R 300, npad 9216 off the tile multiples, a
    run of 5,000 entries), into a slice of a wider block (a column slice
    transposed, a row slice row-major) that is either overwritten or
    accumulated into (from values 0-2); the columns / rows around it stay
    as they were.  One launch per call, counted on densify_bf16 for a
    bfloat16 block and on densify otherwise."""
    npad, R, n_valid = 9216, 300, 9000
    idx, vals, starts, lens = _csr_runs(rng, R, npad, long_run=5000)
    val = None if dtype == torch.int8 else torch.from_numpy(vals).to(dev)
    idx_d = torch.from_numpy(idx).to(dev)
    shape = (R + 11, npad) if row_major else (npad, R + 11)
    base = torch.from_numpy(rng.integers(0, 3, shape).astype(
        np.float32)).to(dev).to(dtype)
    wide = base.clone()
    out = wide[5:5 + R] if row_major else wide[:, 5:5 + R]
    ref = (base[5:5 + R] if row_major else base[:, 5:5 + R]).clone()
    counter = D.densify_bf16 if dtype == torch.bfloat16 else D.densify
    n0 = counter.launches
    D.densify_runs(idx_d, val, starts, lens, npad, n_valid, out,
                   accumulate=accumulate, row_major=row_major)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    D.densify_runs_plain(idx_d, val, starts, lens, npad, n_valid, ref,
                         accumulate=accumulate, row_major=row_major)
    assert counter.launches == n0 + 1
    assert torch.equal(out, ref) and ref.float().max() > 2
    keep = torch.ones(shape[0] if row_major else shape[1], dtype=torch.bool)
    keep[5:5 + R] = False
    rest = wide[keep] if row_major else wide[:, keep]
    assert torch.equal(rest, base[keep] if row_major else base[:, keep])


@pytest.mark.parametrize("entry", ["runs", "layout"])
def test_densify_bf16_sums_above_256(dev, rng, entry):
    """The kernel's bfloat16 output sums in float32 and rounds once: a
    column of 256, 1 and 1 gives 258 (per-entry rounding gave 256), and
    integer sums of up to ~700 equal the plain version's, on the CSR
    runs and on the TPU kernel's (W, R) layout."""
    npad, W, R = 4096, 128, 512
    ids = rng.integers(0, 8, (W, R)).astype(np.int32)      # many repeats
    vals = rng.integers(1, 40, (W, R)).astype(np.float32)
    ids[:3, 7], vals[:3, 7] = 5, (256.0, 1.0, 1.0)
    ids[3:, 7] = npad
    if entry == "layout":
        idsT = torch.from_numpy(ids).to(dev)
        valsT = torch.from_numpy(vals).to(dev)
        wmax = D.densify_meta(idsT, npad)
        got = D.densify_bf16(idsT, valsT, wmax, npad)
        ref = D.densify_plain(idsT, valsT, wmax, npad, torch.zeros(
            (npad, R), dtype=torch.bfloat16, device=dev))
    else:
        lens = (ids < npad).sum(axis=0)
        keep = ids.T < npad
        args = (torch.from_numpy(ids.T[keep].copy()).to(dev),
                torch.from_numpy(vals.T[keep].copy()).to(dev),
                np.concatenate([[0], np.cumsum(lens)[:-1]]), lens, npad,
                None)
        got = D.densify_runs(*args, torch.empty(
            (npad, R), dtype=torch.bfloat16, device=dev))
        ref = D.densify_runs_plain(*args, torch.empty(
            (npad, R), dtype=torch.bfloat16, device=dev))
    assert got[5, 7].item() == 258.0
    assert torch.equal(got, ref) and ref.float().max() > 512


@pytest.mark.parametrize("kind", ["binary", "ratings", "fractional"])
def test_high_precision_on_card_matches_highest(dev, rng, kind):
    """Above npad 8192 a call that names no precision scores at "high"
    (the split bfloat16 product on the tensor cores; fractional ratings
    densify to float32 and split): against "highest" on the card, the same
    counts, scores within 2^-16 rel and ids equal but at near ties, for a
    few hundred users."""
    from slim_tpu_torch import predict as Pr

    n, nusers = 9000, 300
    r, c = rng.integers(0, n, 160_000), rng.integers(0, n, 160_000)
    model = CSR.from_ijv(r, c, rng.random(r.size).astype(np.float32) + 0.01,
                         nrows=n, ncols=n)
    u, i = rng.integers(0, nusers, 30_000), rng.integers(0, n, 30_000)
    v = rng.integers(1, 6, u.size).astype(np.float32)
    hist = CSR.from_ijv(u, i, v + (0.3 if kind == "fractional" else 0.0),
                        nrows=nusers, ncols=n)
    if kind == "binary":
        hist = hist.binarize()
    n16 = D.densify_bf16.launches
    got = predict_topn(model, hist, nrcmds=10, sparse=False, device=dev)
    assert Pr.last_route == "dense"
    assert (D.densify_bf16.launches > n16) == (kind != "fractional")
    ref = predict_topn(model, hist, nrcmds=10, sparse=False,
                       precision="highest", device=dev)
    np.testing.assert_array_equal(got[2], ref[2])
    ok = ref[0] >= 0
    assert np.all(np.abs(got[1][ok] - ref[1][ok])
                  <= 2.0 ** -16 * ref[1][ok])
    assert ranked_mismatches(got[0], got[1], ref[0], ref[1], ref[2])[1] == 0


def test_kept_split_on_card_equals_a_fresh_one(dev, rng, monkeypatch):
    """Above npad 8192 a resident W is split once on the card: the calls
    served its kept halves give the ids, scores and counts of a call that
    splits a copy of W afresh, bit for bit."""
    from slim_tpu_torch import predict as Pr

    n, nusers = 9000, 300
    r, c = rng.integers(0, n, 160_000), rng.integers(0, n, 160_000)
    model = CSR.from_ijv(r, c, rng.random(r.size).astype(np.float32) + 0.01,
                         nrows=n, ncols=n)
    u, i = rng.integers(0, nusers, 30_000), rng.integers(0, n, 30_000)
    hist = CSR.from_ijv(u, i, rng.integers(1, 6, u.size).astype(np.float32),
                        nrows=nusers, ncols=n)
    made = []
    split = Pr.split_bf16
    monkeypatch.setattr(Pr, "split_bf16",
                        lambda W, h: made.append(h) or split(W, h))
    W = Pr.densify_model(model, device=dev)
    kept = [predict_topn(model, hist, nrcmds=10, W_dev=W) for _ in range(3)]
    assert Pr.last_precision == "high" and made == [2]
    fresh = predict_topn(model, hist, nrcmds=10, W_dev=W.clone())
    assert made == [2, 2]
    for got in kept:
        for a, b in zip(got, fresh):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", ["npad384", "compact"])
def test_harvest_on_card_equals_reference_assembly(dev, monkeypatch, shape):
    """The learn on the card with its entries held there, and moved to
    host memory at block 1 and at block 3, equals the learn assembled by
    ``native.csr_from_blocks`` over the same blocks entry for entry, with
    equal stats and one pack launch a block in each: at npad 384 (the
    vendored synth set's 300 items) and on compact blocks (ids through
    S)."""
    import os

    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.io.readers import read_matrix
    from slim_tpu_torch.solvers import cd as C

    if shape == "npad384":
        m = read_matrix(os.path.join(os.path.dirname(__file__), "data",
                                     "synth-train.ijv"),
                        fmt="ijv").infer_ncols()
        cfg = SlimConfig(l1r=1.0, l2r=1.0, block_size=64)
    else:
        mat = random_csr(None, 150, 400, density=0.03, seed=31)
        m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                            mat.data)
        cfg = SlimConfig(l1r=3.0, l2r=1.0, block_size=64,
                         compact_threshold=64)
    nblocks = -(-m.ncols // cfg.block_size)

    def run():
        packs = P.pack.launches
        model, stats = C.estimate_model_cd(m, cfg, device=dev)
        assert P.pack.launches - packs == nblocks
        return model, stats

    sizes = []
    with pytest.MonkeyPatch.context() as mp:
        _reference_assembly(mp, sizes)
        ref = run()
    if shape == "compact":
        assert any(k < 512 for k in ref[1]["union_widths"])
    held = run()
    assert held[1]["assembly"] == "card"
    _same_model(held, ref)
    for at in (1, 3):
        with pytest.MonkeyPatch.context() as mp:
            _move_at(mp, at, sizes)
            moved = run()
        assert moved[1]["assembly"] == "host"
        _same_model(moved, ref)


@pytest.mark.parametrize("n,ld,R,C,trans", [(4096, 4096, 3000, 3000, False),
                                           (4096, 4100, 1000, 2999, True),
                                           (640, 640, 37, 600, True),
                                           (640, 768, 600, 37, False)])
def test_gather_kernel_matches_plain(dev, n, ld, R, C, trans):
    """csrc/gather.cu against two index_selects, bit for bit, on a G that
    is not symmetric (a row stride ``ld`` above its width), ragged R and
    C, ids repeated and out of order."""
    from slim_tpu_torch.ops import gather as GA

    g = torch.Generator(device=dev).manual_seed(n + R)
    big = torch.rand((n, ld), generator=g, device=dev)
    Gm = big[:, :n]
    rows = torch.randint(0, n, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    cols = torch.sort(torch.randint(0, n, (C,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    before = GA.gather.launches
    got = GA.gather(Gm, rows, cols, trans)
    assert GA.gather.launches == before + 1
    assert torch.equal(got, GA.gather_plain(Gm, rows, cols, trans))


def test_compact_gather_makes_no_wide_intermediate(dev):
    """G[S, S] and G[j, S] at npad 16,384 and K 8,192 allocate their
    outputs and nothing as wide as a (K, npad) block."""
    from slim_tpu_torch.ops.cd_kernel import gather_compact

    npad, K, B = 16384, 8192, 1024
    G = torch.rand((npad, npad), device=dev)
    S = torch.sort(torch.randperm(npad - 1, device=dev)[:K]).values \
        .to(torch.int32)
    J = torch.arange(B, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    Gs, gjs, yty = gather_compact(G, S, J)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    assert extra <= 4 * (K * K + B * K + B) + (1 << 20), extra
    Sl, Jl = S.long(), J.long()
    assert torch.equal(Gs, G.index_select(0, Sl).index_select(1, Sl))
    assert torch.equal(gjs, G[:, Jl].T[:, Sl])
    assert torch.equal(yty, torch.diagonal(G)[Jl])


def test_rank_space_gram_on_card(dev, rng):
    """The card's Gram through ``col_map`` is the permuted item-space
    Gram: bit for bit on binary data, to float32 rounding on valued."""
    for implicit in (True, False):
        mat = random_csr(rng, 900, 700, density=0.05, implicit=implicit)
        m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                            mat.data)
        npad = 768
        p = np.argsort(-m.col_nnz(), kind="stable")
        rank = np.empty(m.ncols, np.int64)
        rank[p] = np.arange(m.ncols)
        pp = torch.from_numpy(np.concatenate(
            [p, np.arange(m.ncols, npad)])).to(dev)
        item = G.compute_gram(m, "device", pad_to=npad, device=dev)
        want = item.index_select(0, pp).index_select(1, pp)
        got = G.compute_gram(m, "device", pad_to=npad, device=dev,
                             col_map=rank)
        if implicit:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_rank_space_counts_columns_on_card(dev, rng):
    """On the card ``_rank_space`` counts each column's ratings there, as
    ``CSR.col_nnz`` does, and its rank-space Gram equals the host's."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.solvers import cd as C

    mat = random_csr(rng, 500, 300, density=0.05, implicit=True)
    m = CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices)
    g, p, *_, nnz = C._rank_space(m, SlimConfig(), 384, None, dev)
    np.testing.assert_array_equal(nnz, m.col_nnz())
    host = C._rank_space(m, SlimConfig(), 384, None, torch.device("cpu"))
    np.testing.assert_array_equal(p, host[1])
    assert torch.equal(g.cpu(), host[0])
