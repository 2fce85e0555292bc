"""The CD learn's and the packed grid's one harvest and assembly: each
solved block's entries held as tensors (``solvers/cd._Held``) until
``_assemble`` sorts them.  Each learn is run with its entries held to the
end, and moved to host memory at block 1 and at block 3 (a patched
``_card_budget``: room for the entries of the blocks before it), and
must equal, entry for entry and with equal loss, fit, niters and sweeps,
the same learn with ``_assemble`` replaced by ``native.csr_from_blocks``
over the same blocks; checkpoint files are written in block order on the
main thread; a failing block fails the learn; and each result stays
within the goldens' tolerances (objective rtol 1e-4, nnz within 1%) of
``slim_tpu``'s ``estimate_model_cd`` on JAX-CPU on the same numpy-made
matrix.  All on the CPU (``device="cpu"``), where the move to host memory
takes the same steps and copies nothing; tests/test_torch_cuda.py repeats
the equality on the card."""

import glob
import logging
import os
import threading

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_grid_cd as jax_grid
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SlimConfig, native
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.parallel import dist as D
from slim_tpu_torch.parallel import launch as L
from slim_tpu_torch.solvers import cd as C
from slim_tpu_torch.types import CSR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# where the entries are when the learn ends: held to the end, or moved to
# host memory at block 1 or at block 3 (the blocks before it held)
HOLDS = {"held": None, "moved_at_1": 1, "moved_at_3": 3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, nrows, ncols, density):
    m = random_csr(None, nrows, ncols, density=density, seed=seed)
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def _synth():
    return read_matrix(os.path.join(DATA, "synth-train.ijv"),
                       fmt="ijv").infer_ncols()


# case -> (matrix, config): SLIM at full width on the vendored synth set
# (5 blocks), the compact screen path and FSLIM's compact path (400 items
# at npad 512 above a compact threshold of 64, 7 blocks: the screen's four
# on unions 256 and 384 wide, ids through S, three snapped to full width;
# FSLIM's all on unions of 256)
CASES = {
    "synth": (_synth, dict(l1r=1.0, l2r=1.0, block_size=64)),
    "compact": (lambda: _rand(31, 150, 400, 0.03),
                dict(l1r=3.0, l2r=1.0, block_size=64, optTol=1e-5,
                     compact_threshold=64)),
    "fslim_compact": (lambda: _rand(31, 150, 400, 0.03),
                      dict(l1r=3.0, l2r=1.0, block_size=64, optTol=1e-5,
                           nnbrs=5, simtype="cos", compact_threshold=64)),
}
_MATS = {}


def _mat(case):
    if case not in _MATS:
        _MATS[case] = CASES[case][0]()
    return _MATS[case]


def _native_assemble(coord, target, vals, n):
    """``_assemble``'s reference: ``native.csr_from_blocks`` over the same
    blocks, as host arrays."""
    host = [[a.cpu().numpy() for a in lst] for lst in (coord, target, vals)]
    return CSR.from_arrays(n, n, *native.csr_from_blocks(*host, n))


def _as_reference(monkeypatch, sizes):
    """Learns assemble through :func:`_native_assemble`; each held block's
    entry count is appended to ``sizes``, in order."""
    real = C._Held.add

    def add(self, rec, key=0):
        sizes.append(len(rec.vals))
        return real(self, rec, key)

    monkeypatch.setattr(C._Held, "add", add)
    monkeypatch.setattr(C, "_assemble", _native_assemble)


def _move_at(monkeypatch, at, sizes):
    """Entries moved to host memory at held block ``at`` (None: held to
    the end): the card's budget patched to the bytes of the blocks before
    it (``sizes``: each block's entry count)."""
    if at is not None:
        assert sizes[at] > 0, "the block that moves them holds no entry"
        budget = 12 * sum(sizes[:at])
        monkeypatch.setattr(C, "_card_budget", lambda dev: budget)


_REF = {}


def _reference(case, kind="cold"):
    """((model, stats), held blocks' entry counts) of the case's learn
    through the reference assembly (cached per module)."""
    key = (case, kind)
    if key not in _REF:
        mp, sizes = pytest.MonkeyPatch(), []
        try:
            _as_reference(mp, sizes)
            _REF[key] = (_learn(case, kind), sizes)
        finally:
            mp.undo()
    return _REF[key]


def _learn(case, kind):
    """The learn of ``case`` on the CPU: cold; warm from the reference's
    cold model (``imodel``); warm from a retained pack (``warm_pack``, the
    reference learn's with keep_device_model); or keeping its device
    model."""
    mat, cfg = _mat(case), SlimConfig(**CASES[case][1])
    kw = {}
    if kind == "imodel":
        cfg, kw = cfg.replace(l1r=cfg.l1r * 1.5), dict(
            imodel=_reference(case)[0][0])
    elif kind == "keep":
        kw = dict(keep_device_model=True)
    elif kind == "warm_pack":
        cfg, kw = cfg.replace(l1r=cfg.l1r * 1.5), dict(
            warm_pack=_reference(case, "keep")[0][1]["W_dev"])
    return C.estimate_model_cd(mat, cfg, device="cpu", **kw)


def _run(monkeypatch, hold, case, kind="cold"):
    """The learn of ``case`` with its entries where ``hold`` says."""
    _move_at(monkeypatch, HOLDS[hold], _reference(case, kind)[1])
    return _learn(case, kind)


def _same(got, ref):
    """Two learns equal entry for entry, with equal stats."""
    (m, s), (r, t) = got, ref
    assert m.shape == r.shape
    np.testing.assert_array_equal(m.indptr, r.indptr)
    np.testing.assert_array_equal(m.indices, r.indices)
    np.testing.assert_array_equal(m.data, r.data)
    assert m.data.dtype == r.data.dtype and m.indices.dtype == r.indices.dtype
    for k in ("loss", "fit", "niters", "sweeps", "nnz"):
        assert s[k] == t[k], k


def _moves(caplog):
    """The messages of the moves to host memory logged."""
    return [r.getMessage() for r in caplog.records
            if "held in host memory" in r.getMessage()]


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_learn_equals_reference_assembly(monkeypatch, case, hold):
    got = _run(monkeypatch, hold, case)
    _same(got, _reference(case)[0])
    assert set(C.WAITS) <= set(got[1]["phases"])
    assert got[1]["assembly"] == "host"


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("kind", ["imodel", "warm_pack"])
def test_warm_learn_equals_reference_assembly(monkeypatch, kind, hold):
    _same(_run(monkeypatch, hold, "compact", kind),
          _reference("compact", kind)[0])


@pytest.mark.parametrize("hold", HOLDS)
def test_keep_device_model_equals_reference_assembly(monkeypatch, hold):
    got = _run(monkeypatch, hold, "compact", "keep")
    ref = _reference("compact", "keep")[0]
    _same(got, ref)
    a, b = got[1]["W_dev"], ref[1]["W_dev"]
    for k in ("vals", "idx"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("run_starts", "run_lens", "p_pad", "posmap_pad"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert torch.equal(a.densify(), b.densify())


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_held_entries_move_once_at_the_budget(monkeypatch, caplog, case,
                                             hold):
    """The budget is read once, at the first held block; the entries move
    to host memory once, at the block that passes it, with the blocks held
    before it; the model is the reference's."""
    reads = []
    _move_at(monkeypatch, HOLDS[hold], _reference(case)[1])
    budget = C._card_budget
    monkeypatch.setattr(C, "_card_budget",
                        lambda dev: reads.append(dev) or budget(dev))
    with caplog.at_level(logging.INFO, logger="slim_tpu_torch"):
        got = _learn(case, "cold")
    _same(got, _reference(case)[0])
    assert reads == [torch.device("cpu")]
    at, moves = HOLDS[hold], _moves(caplog)
    assert len(moves) == (at is not None)
    assert all(f"after {at} held blocks" in m for m in moves)


def test_move_at_the_first_block(monkeypatch, caplog):
    """A budget of no byte moves the entries at the first block, none
    held before it: the reference's model."""
    monkeypatch.setattr(C, "_card_budget", lambda dev: 0)
    with caplog.at_level(logging.INFO, logger="slim_tpu_torch"):
        got = _learn("fslim_compact", "cold")
    _same(got, _reference("fslim_compact")[0])
    assert len(_moves(caplog)) == 1
    assert "after 0 held blocks" in _moves(caplog)[0]


def test_assembly_where():
    """``stats["assembly"]``: "host" for a CPU learn and for a learn whose
    entries moved; "card" while a holder's entries are on a CUDA device,
    "host" once they moved."""
    assert _reference("synth")[0][1]["assembly"] == "host"
    held = C._Held(torch.device("cpu"))
    assert held.where == "host"
    held = C._Held(torch.device("cuda"))       # nothing added: no card
    assert held.where == "card"
    held._move()
    assert held.where == "host" and held.dev == torch.device("cpu")
    assert C._card_budget(torch.device("cpu")) == float("inf")


def _as_jax(stats, mat, cfg, **kw):
    _, ref = jax_cd(JCSR.from_arrays(mat.nrows, mat.ncols, mat.indptr,
                                     mat.indices, mat.data),
                    JaxConfig(**vars(cfg)), **kw)
    np.testing.assert_allclose(stats["loss"], ref["loss"], rtol=1e-4)
    assert abs(stats["nnz"] - ref["nnz"]) <= max(2, 0.01 * ref["nnz"])


@pytest.mark.parametrize("case,kind", [
    ("synth", "cold"), ("compact", "cold"), ("fslim_compact", "cold"),
    ("compact", "imodel"), ("compact", "warm_pack")])
def test_learn_as_jax(case, kind):
    """The learn against the JAX package's learn; both warm starts against
    its ``imodel`` warm start from the same model."""
    _, stats = _learn(case, kind)
    cfg = SlimConfig(**CASES[case][1])
    if kind == "cold":
        _as_jax(stats, _mat(case), cfg)
        return
    m0 = _reference(case)[0][0]
    _as_jax(stats, _mat(case), cfg.replace(l1r=cfg.l1r * 1.5),
            imodel=JCSR.from_arrays(m0.nrows, m0.ncols, m0.indptr,
                                    m0.indices, m0.data))


# --------------------------------------------------------------------- #
# checkpoints: written on the main thread, in block order
# --------------------------------------------------------------------- #
@pytest.fixture
def saves(monkeypatch):
    """(block, thread name) of every checkpoint write, in order."""
    seen = []
    real = C._Checkpoint.save

    def save(self, blk, rec):
        seen.append((blk, threading.current_thread().name))
        return real(self, blk, rec)

    monkeypatch.setattr(C._Checkpoint, "save", save)
    return seen


def _files(d):
    return {int(f.rsplit("_", 1)[1][:-4]): f
            for f in glob.glob(os.path.join(d, "cdblk_*.npz"))}


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ckpt_learn(tmp, **kw):
    return C.estimate_model_cd(_mat("compact"), SlimConfig(
        **CASES["compact"][1], checkpoint_dir=str(tmp)), device="cpu", **kw)


@pytest.mark.parametrize("hold", HOLDS)
def test_checkpoints_in_block_order(monkeypatch, tmp_path, saves, hold):
    """The checkpointed learn against the reference's checkpointed learn:
    the same model, the same files, written in block order on the main
    thread in the phase ``checkpoint``."""
    with pytest.MonkeyPatch.context() as mp:
        sizes = []
        _as_reference(mp, sizes)
        ref = _ckpt_learn(tmp_path / "ref")
    nblocks = len(saves)
    assert [b for b, _ in saves] == list(range(nblocks)) == \
        list(range(len(sizes)))
    saves.clear()
    _move_at(monkeypatch, HOLDS[hold], sizes)
    got = _ckpt_learn(tmp_path / "got")
    _same(got, ref)
    _same(got, _reference("compact")[0])
    main = threading.main_thread().name
    assert saves == [(b, main) for b in range(nblocks)]
    assert got[1]["phases"]["checkpoint"] > 0
    a, b = _files(str(tmp_path / "ref")), _files(str(tmp_path / "got"))
    assert sorted(a) == sorted(b) == list(range(nblocks))
    for blk in a:
        x, y = _arrays(a[blk]), _arrays(b[blk])
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype


def test_resume_after_every_third_file_lost(tmp_path, saves):
    """Delete every third block file, resume bit-equal, re-writing
    exactly those blocks, in order."""
    first = _ckpt_learn(tmp_path)
    files = _files(str(tmp_path))
    lost = sorted(files)[::3]
    before = {b: _arrays(files[b]) for b in lost}
    for b in lost:
        os.remove(files[b])
    saves.clear()
    again = _ckpt_learn(tmp_path)
    _same(again, first)
    assert [b for b, _ in saves] == lost
    files = _files(str(tmp_path))
    for b in lost:
        after = _arrays(files[b])
        for k in before[b]:
            np.testing.assert_array_equal(after[k], before[b][k])
    assert "restore" in again[1]["phases"]


def test_resumed_learn_mixes_restored_and_solved_blocks(
        monkeypatch, caplog, tmp_path, saves):
    """Blocks 0, 2 and 5 solved again between restored ones (their arrays
    uploaded as tensors), the entries moved to host memory at block 3, a
    restored one: the reference's model, and a keep_device_model learn
    keeps none."""
    _ckpt_learn(tmp_path)
    files = _files(str(tmp_path))
    for b in (0, 2, 5):
        os.remove(files[b])
    saves.clear()
    _move_at(monkeypatch, 3, _reference("compact")[1])
    with caplog.at_level(logging.INFO, logger="slim_tpu_torch"):
        got = _ckpt_learn(tmp_path, keep_device_model=True)
    _same(got, _reference("compact")[0])
    assert [b for b, _ in saves] == [0, 2, 5]
    assert got[1]["W_dev"] is None and "restore" in got[1]["phases"]
    assert ["after 3 held blocks" in m for m in _moves(caplog)] == [True]


def test_failing_block_fails_the_learn(monkeypatch, tmp_path):
    """A block whose checkpoint write raises makes the learn raise, and no
    later block's file is written after it."""
    real = C._Checkpoint.save

    def save(self, blk, rec):
        if blk == 1:
            raise OSError("disk full")
        return real(self, blk, rec)

    monkeypatch.setattr(C._Checkpoint, "save", save)
    with pytest.raises(OSError, match="disk full"):
        _ckpt_learn(tmp_path)
    assert sorted(_files(str(tmp_path))) == [0]


# --------------------------------------------------------------------- #
# the packed grid
# --------------------------------------------------------------------- #
# a 2 x 2 grid over 100 items: 400 virtual columns in 7 blocks of 64,
# blocks 1, 3 and 5 holding the columns of two points (10 held parts)
GRID = [(0.5, 0.5), (0.5, 2.0), (2.0, 0.5), (2.0, 2.0)]
GRID_CFG = dict(block_size=64, optTol=1e-5)


def _grid():
    if "grid" not in _MATS:
        _MATS["grid"] = _rand(33, 80, 100, 0.1)
    return C.estimate_grid_cd(_MATS["grid"], SlimConfig(**GRID_CFG), GRID,
                              device="cpu")


def _grid_reference():
    if "grid" not in _REF:
        with pytest.MonkeyPatch.context() as mp:
            sizes = []
            _as_reference(mp, sizes)
            _REF["grid"] = (_grid(), sizes)
    return _REF["grid"]


@pytest.mark.parametrize("hold", HOLDS)
def test_grid_equals_reference_assembly(monkeypatch, hold):
    ref, sizes = _grid_reference()
    assert len(sizes) == 10
    _move_at(monkeypatch, HOLDS[hold], sizes)
    got = _grid()
    assert len(got) == len(GRID)
    for g, r in zip(got, ref):
        _same(g, r)
    if hold == "held":
        m = _MATS["grid"]
        jref = jax_grid(JCSR.from_arrays(m.nrows, m.ncols, m.indptr,
                                         m.indices, m.data),
                        JaxConfig(**GRID_CFG), GRID)
        for (_, s), (_, t) in zip(got, jref):
            np.testing.assert_allclose(s["loss"], t["loss"], rtol=1e-4)
            assert abs(s["nnz"] - t["nnz"]) <= max(2, 0.01 * t["nnz"])


# --------------------------------------------------------------------- #
# the assembly
# --------------------------------------------------------------------- #
# n^2 < 2^31 up to n = 46,340
WIDE_N = {"wide": 50_000, "edge32": 46_340, "edge64": 46_341}


def _fragments(case):
    """(row, column, value) fragments with each pair once, and n: pairs
    in shuffled order over fragments of any length (one empty) with empty
    rows; no fragment at all; a full row of n - 1 columns; and, with
    entries at ids near n - 1, an n with n^2 >= 2^31 (the int64 key) and
    the last n of the int32 key and the first of the int64 one."""
    rng = np.random.default_rng(17)
    if case == "none":
        return [], 4
    if case in WIDE_N:
        n = WIDE_N[case]
        r = np.array([n - 1, 0, n - 2, n - 1, n - 3, 7], np.int32)
        c = np.array([n - 2, n - 1, n - 1, 0, n - 3, n - 1], np.int32)
        cuts = [0, 2, 2, 6]
    else:
        n = 57 if case == "shuffled" else 30
        pairs = rng.permutation(n * n)[:300]
        r, c = (pairs // n).astype(np.int32), (pairs % n).astype(np.int32)
        keep = r != 11                            # row 11 empty
        if case == "full_row":
            keep &= r != 4
        r, c = r[keep], c[keep]
        if case == "full_row":                    # row 4: every other column
            cols = rng.permutation(np.setdiff1d(np.arange(n), [4]))
            r = np.concatenate([r, np.full(n - 1, 4, np.int32)])
            c = np.concatenate([c, cols.astype(np.int32)])
            order = rng.permutation(r.size)
            r, c = r[order], c[order]
        cuts = [0, 13, 13, 14, 90, r.size]
    v = rng.random(r.size).astype(np.float32)
    return [(r[a:b], c[a:b], v[a:b]) for a, b in zip(cuts, cuts[1:])], n


@pytest.mark.parametrize("case", ["shuffled", "none", "full_row",
                                  *WIDE_N])
def test_assembly_equals_native(case):
    """``_assemble`` on CPU tensors: entry for entry the native counting
    sort's CSR and scipy's over the concatenation."""
    frags, n = _fragments(case)
    lists = [[f[i] for f in frags] for i in range(3)]
    got = C._assemble(
        *[[torch.from_numpy(a) for a in lst] for lst in lists], n)
    indptr, indices, data = native.csr_from_blocks(*lists, n)
    cat = [np.concatenate(lst) if lst else np.zeros(0, dt)
           for lst, dt in zip(lists, (np.int32, np.int32, np.float32))]
    want = CSR.from_ijv(*cat, nrows=n, ncols=n, no_duplicates=True)
    assert got.shape == (n, n) and got.nnz == want.nnz == indices.size
    for a, b in ((got.indptr, indptr), (got.indices, indices),
                 (got.values(), data), (got.indptr, want.indptr),
                 (got.indices, want.indices), (got.values(), want.values())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case == "full_row":
        assert got.indptr[5] - got.indptr[4] == n - 1
    if case in ("shuffled", "full_row"):
        assert got.indptr[12] == got.indptr[11]


# --------------------------------------------------------------------- #
# the replicated distributed learn (shard=), two gloo ranks
# --------------------------------------------------------------------- #
def _shard_learn(kind, mat, cfg, mesh=None):
    """A rank's ``distributed_learn``: its entries held (``held``), moved
    to host memory at its first block and after the gather (``moved``), or
    assembled by the reference (``reference``)."""
    with pytest.MonkeyPatch.context() as mp:
        if kind == "moved":
            mp.setattr(C, "_card_budget", lambda dev: 0)
        elif kind == "reference":
            _as_reference(mp, [])
        return D.distributed_learn(mat, cfg, mesh)


def test_shard_learn_equals_reference():
    mat, kw = _mat("compact"), CASES["compact"][1]
    cfg = SlimConfig(**kw)
    calls = [L.Call(k, _shard_learn, (k, mat, cfg))
             for k in ("held", "moved", "reference")]
    ranks = L.run_world(L.run_calls, 2, args=(calls, "cpu"), device="cpu",
                        backend="gloo")
    ref = ranks[0]["reference"]["result"]
    for r in ranks:
        for k in ("held", "moved", "reference"):
            _same(r[k]["result"], ref)
            assert r[k]["result"][1]["assembly"] == "host"
    _same(ref, _reference("compact")[0])
    _as_jax(ref[1], mat, cfg)
