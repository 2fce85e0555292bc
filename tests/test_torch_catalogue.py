"""The pieces that let the port learn a catalogue whose Gram fills most of
the card, on the CPU at small sizes: the Gram built straight in rank space
in one buffer, the compact gathers in one pass each, the kept bf16 halves
of the full G freed once no full-width block is left, and the learn's
counters of them (``gather`` phase, ``sweep_work``, ``block_width``)."""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch.ops import _build
from slim_tpu_torch.ops import cd_kernel as CK
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops import gather as GA
from slim_tpu_torch.ops import gram as tgram
from slim_tpu_torch.solvers import cd as C
from slim_tpu_torch.types import CSR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(binary, seed=3, nrows=700, ncols=300, density=0.08):
    rng = np.random.default_rng(seed)
    dense = rng.random((nrows, ncols)) < density
    dense[:, :20] |= rng.random((nrows, 20)) < 0.4      # popular items
    vals = dense.astype(np.float32) if binary else \
        np.where(dense, rng.random((nrows, ncols)) * 3, 0).astype(np.float32)
    m = sp.csr_matrix(vals)
    return CSR.from_arrays(nrows, ncols, m.indptr, m.indices,
                           None if binary else m.data)


def _long_tail():
    """500 users x 1,200 items, rank^-0.6 items: with blocks of 128 over a
    compact threshold of 256 its first two blocks snap to full width
    (npad 1,536) and the rest solve in unions 256-1,024 wide."""
    from slim_tpu_torch.datagen import synth_implicit

    m = synth_implicit(500, 1200, 15000, seed=11, pop_exp=0.6)
    return m, SlimConfig(l1r=1.0, l2r=1.0, block_size=128,
                         compact_threshold=256)


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("binary", [True, False])
def test_rank_space_gram_is_the_permuted_item_space_gram(binary, mode):
    """Through ``col_map`` (item -> frequency rank, as the solver relabels)
    the Gram comes out in rank space, bit for bit the item-space Gram
    permuted by the two gathers the solver took before."""
    mat = _matrix(binary)
    npad = C.bucket_npad(mat.ncols)
    p = np.argsort(-mat.col_nnz(), kind="stable")
    rank = np.empty(mat.ncols, np.int64)
    rank[p] = np.arange(mat.ncols)
    pp = torch.from_numpy(np.concatenate([p, np.arange(mat.ncols, npad)]))
    item = tgram.compute_gram(mat, mode, pad_to=npad, device="cpu")
    want = item.index_select(0, pp).index_select(1, pp)
    got = tgram.compute_gram(mat, mode, pad_to=npad, device="cpu",
                             col_map=rank)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_rank_space_gram_of_the_solver(monkeypatch):
    """``_rank_space`` builds G once, through ``col_map``, and equals the
    permutation of the item-space Gram; a given item-space Gram is still
    permuted.  The column counts are the matrix's own."""
    mat = _matrix(True)
    npad = C.bucket_npad(mat.ncols)
    calls = []
    real = C.compute_gram
    monkeypatch.setattr(C, "compute_gram",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    cpu = torch.device("cpu")
    g, p, p_pad, *_, nnz = C._rank_space(mat, SlimConfig(), npad, None, cpu)
    assert len(calls) == 1 and calls[0]["col_map"] is not None
    np.testing.assert_array_equal(nnz, mat.col_nnz())
    item = tgram.compute_gram(mat, "host", pad_to=npad, device="cpu")
    pp = torch.from_numpy(p_pad)
    assert torch.equal(g, item.index_select(0, pp).index_select(1, pp))
    g2 = C._rank_space(mat, SlimConfig(), npad, item, cpu)[0]
    assert torch.equal(g2, g)


def test_int32_accumulator_converts_in_its_own_memory(monkeypatch):
    """The binary Gram's int32 counts become float32 in the accumulator's
    own storage, a panel of rows at a time (panels of 128 rows here), and
    the row blocks' products are added panel by panel."""
    monkeypatch.setattr(tgram, "PANELS", 3)
    acc = torch.randint(0, 1 << 20, (384, 256), dtype=torch.int32)
    want = acc.to(torch.float32)
    ptr = acc.data_ptr()
    got = tgram.to_float32_(acc)
    assert got.dtype == torch.float32 and got.data_ptr() == ptr
    assert torch.equal(got, want)
    mat = _matrix(True)
    ref = tgram.gram_host(mat, pad_to=384)
    assert np.array_equal(tgram.gram_device(mat, 384, "cpu").numpy(), ref)


def _asymmetric(npad=512, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((npad, npad), generator=g)


@pytest.mark.parametrize("K,B", [(384, 64), (128, 100), (512, 7)])
def test_compact_gather_equals_two_index_selects(K, B):
    """G[S, S] and the targets' rows, read as G[S, j] (the solver's column
    j), in one call each, equal the two ``index_select``s they replace, on
    a G that is not symmetric, with S and j padded by npad - 1."""
    npad = 512
    G = _asymmetric(npad)
    g = torch.Generator().manual_seed(K + B)
    real = min(K, 300)
    S = torch.sort(torch.randperm(npad - 1, generator=g)[:real]).values
    S = torch.cat([S, torch.full((K - real,), npad - 1)]).to(torch.int32)
    J = torch.randperm(npad - 1, generator=g)[:B].to(torch.int32)
    J[-1] = npad - 1
    Gs, gjs, yty = CK.gather_compact(G, S, J)
    Sl, Jl = S.long(), J.long()
    assert torch.equal(Gs, G.index_select(0, Sl).index_select(1, Sl))
    assert torch.equal(gjs, G[:, Jl].T[:, Sl].contiguous())
    assert torch.equal(yty, torch.diagonal(G)[Jl])


def test_gather_checks_its_operands():
    G = _asymmetric(128)
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        GA.gather(G.double(), ids, ids)
    with pytest.raises(ValueError):
        GA.gather(G.T, ids, ids)
    with pytest.raises(ValueError):
        GA.gather(G, ids.long(), ids)
    before = GA.gather.launches
    assert torch.equal(GA.gather(G, ids, ids, trans=True), G[:4, :4].T)
    assert GA.gather.launches == before        # CPU tensors: plain version


def test_gather_c_entry_matches_its_binding():
    """ops/_build's ctypes argument list for slim_gather has one type per
    parameter of the C entry in csrc/gather.cu (ctypes passes an extra
    argument as a C int, which would cut a pointer)."""
    src = (_build.SRC_DIR / "gather.cu").read_text()
    params = re.search(r'extern "C" int slim_gather\(([^)]*)\)',
                       src).group(1).split(",")
    kinds = [_build._P if "*" in p else _build._LL if "long long" in p
             else _build._I for p in params]
    assert kinds == _build._SIGNATURES["slim_gather"]


@pytest.fixture(scope="module")
def tail_learn():
    """The long-tail learn, with the full-width blocks' solves splitting
    the full G into its kept bf16 halves as the card's wide sweep does
    (the CPU solve never splits), and at every compact gather a record of
    whether the kept slot still held the full G's halves."""
    mp = pytest.MonkeyPatch()
    seen = {"full": [], "gathers": [], "G": None}
    real_ids, real_gather = C.cd_solve_block_ids, C.gather_compact

    def full_width(G, *a, **k):
        seen["G"] = G
        S._split_of(G)
        out = real_ids(G, *a, **k)
        seen["full"].append(S._SPLIT["G"][0]() is G)
        return out

    def gather(G, *a, **k):
        hit = S._SPLIT.get("G")
        seen["gathers"].append(hit is not None and hit[0]() is G)
        return real_gather(G, *a, **k)

    mp.setattr(C, "cd_solve_block_ids", full_width)
    mp.setattr(C, "gather_compact", gather)
    try:
        mat, cfg = _long_tail()
        model, stats = learn(mat, cfg, device="cpu")
    finally:
        mp.undo()
    return mat, model, stats, seen


def test_full_g_halves_are_freed_before_the_first_compact_gather(tail_learn):
    _, _, stats, seen = tail_learn
    npad = C.bucket_npad(1200)
    assert stats["union_widths"][npad] == len(seen["full"]) == 2
    assert all(seen["full"])              # kept through the full blocks
    assert len(seen["gathers"]) == sum(
        v for k, v in stats["union_widths"].items() if k < npad) > 0
    assert not any(seen["gathers"])       # gone before every compact one
    assert "G" not in S._SPLIT or S._SPLIT["G"][0]() is not seen["G"]


def test_learn_counts_its_sweep_work_and_gathers(tail_learn):
    """``sweep_work`` sums K^2 x sweeps and npad^2 x sweeps over the
    blocks; the compact blocks' gathers are the phase ``compact-gather``."""
    _, model, stats, _ = tail_learn
    npad = C.bucket_npad(1200)
    assert stats["block_width"] == 128
    work, full = stats["sweep_work"]
    assert full == npad * npad * stats["sweeps"]
    assert 0 < work < full
    assert stats["phases"]["compact-gather"] > 0
    mat = _matrix(True)
    _, st = learn(mat, SlimConfig(block_size=64), device="cpu")
    assert "compact-gather" not in st["phases"]
    n2 = C.bucket_npad(mat.ncols) ** 2
    assert st["sweep_work"] == (n2 * st["sweeps"], n2 * st["sweeps"])


def test_long_tail_learn_equals_its_full_width_solve(tail_learn):
    """The mixed learn (two full-width blocks, compact unions after them)
    reaches the objective of the same learn with every block at full
    width (rtol 1e-4, nnz within 1%)."""
    mat, model, stats, _ = tail_learn
    _, cfg = _long_tail()
    cfg.compact_threshold = 4096
    full, st = learn(mat, cfg, device="cpu")
    assert "union_widths" not in st
    np.testing.assert_allclose(stats["loss"], st["loss"], rtol=1e-4)
    assert abs(model.nnz - full.nnz) <= 0.01 * full.nnz
