"""The CD learn's and the packed grid's pipelined harvest
(``solvers/cd._Harvest``): with SLIM_HARVEST_CHUNK unset (8 blocks in
flight), 1 and 3, each learn must equal the one with SLIM_HARVEST_CHUNK=0
(every block's harvest complete before the next solve, the JAX package's
unpipelined order) entry for entry, with equal loss, fit, niters and
sweeps; checkpoint files are written in block order by the worker thread;
a failing block fails the learn; and each result stays within the goldens'
tolerances (objective rtol 1e-4, nnz within 1%) of ``slim_tpu``'s
``estimate_model_cd`` on JAX-CPU on the same numpy-made matrix.  All on the
CPU (``device="cpu"``), where the same queue and worker run without a copy
stream; tests/test_torch_cuda.py repeats the equality on the card."""

import glob
import os
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_grid_cd as jax_grid
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu.types import CSR as JCSR
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.parallel import dist as D
from slim_tpu_torch.parallel import launch as L
from slim_tpu_torch.solvers import cd as C
from slim_tpu_torch.types import CSR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEPTHS = [None, "1", "3"]   # SLIM_HARVEST_CHUNK: unset (8), 1, 3


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
# (3 blocks), the compact screen path and FSLIM's compact path (400 items
# at npad 512 above a compact threshold of 64, 7 blocks: the screen's four
# on unions 256 and 384 wide, ids through S, three snapped to full width;
# FSLIM's all on unions of 256)
CASES = {
    "synth": (_synth, dict(l1r=1.0, l2r=1.0, block_size=100)),
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


def _learn(monkeypatch, depth, mat, cfg, **kw):
    """estimate_model_cd on the CPU at the given SLIM_HARVEST_CHUNK."""
    if depth is None:
        monkeypatch.delenv("SLIM_HARVEST_CHUNK", raising=False)
    else:
        monkeypatch.setenv("SLIM_HARVEST_CHUNK", depth)
    return C.estimate_model_cd(mat, cfg, device="cpu", **kw)


_SERIAL = {}


def _serial(case, kind="cold"):
    """The case's learn at SLIM_HARVEST_CHUNK=0 (cached per module)."""
    key = (case, kind)
    if key not in _SERIAL:
        mp = pytest.MonkeyPatch()
        try:
            _SERIAL[key] = _run(mp, "0", case, kind)
        finally:
            mp.undo()
    return _SERIAL[key]


def _run(monkeypatch, depth, case, kind):
    """The learn of ``case``: cold; warm from the serial cold model
    (``imodel``); warm from a retained pack (``warm_pack``, the serial
    learn's with keep_device_model); or keeping its device model."""
    mat, cfg = _mat(case), SlimConfig(**CASES[case][1])
    if kind == "cold":
        return _learn(monkeypatch, depth, mat, cfg)
    if kind == "imodel":
        return _learn(monkeypatch, depth, mat, cfg.replace(l1r=cfg.l1r * 1.5),
                      imodel=_serial(case)[0])
    if kind == "keep":
        return _learn(monkeypatch, depth, mat, cfg, keep_device_model=True)
    return _learn(monkeypatch, depth, mat, cfg.replace(l1r=cfg.l1r * 1.5),
                  warm_pack=_serial(case, "keep")[1]["W_dev"])


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


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_equals_serial(monkeypatch, case, depth):
    got = _run(monkeypatch, depth, case, "cold")
    _same(got, _serial(case))
    assert set(C.WAITS) <= set(got[1]["phases"])


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["imodel", "warm_pack"])
def test_warm_pipelined_equals_serial(monkeypatch, kind, depth):
    _same(_run(monkeypatch, depth, "compact", kind),
          _serial("compact", kind))


@pytest.mark.parametrize("depth", DEPTHS)
def test_keep_device_model_pipelined(monkeypatch, depth):
    got = _run(monkeypatch, depth, "compact", "keep")
    ref = _serial("compact", "keep")
    _same(got, ref)
    a, b = got[1]["W_dev"], ref[1]["W_dev"]
    for k in ("vals", "idx"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("run_starts", "run_lens", "p_pad", "posmap_pad"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert torch.equal(a.densify(), b.densify())


def _as_jax(stats, mat, cfg, **kw):
    _, ref = jax_cd(JCSR.from_arrays(mat.nrows, mat.ncols, mat.indptr,
                                     mat.indices, mat.data),
                    JaxConfig(**vars(cfg)), **kw)
    np.testing.assert_allclose(stats["loss"], ref["loss"], rtol=1e-4)
    assert abs(stats["nnz"] - ref["nnz"]) <= max(2, 0.01 * ref["nnz"])


@pytest.mark.parametrize("case,kind", [
    ("synth", "cold"), ("compact", "cold"), ("fslim_compact", "cold"),
    ("compact", "imodel"), ("compact", "warm_pack")])
def test_pipelined_as_jax(monkeypatch, case, kind):
    """The default pipelined learn against the JAX package's learn; both
    warm starts against its ``imodel`` warm start from the same model."""
    _, stats = _run(monkeypatch, None, case, kind)
    cfg = SlimConfig(**CASES[case][1])
    if kind == "cold":
        _as_jax(stats, _mat(case), cfg)
        return
    m0 = _serial(case)[0]
    _as_jax(stats, _mat(case), cfg.replace(l1r=cfg.l1r * 1.5),
            imodel=JCSR.from_arrays(m0.nrows, m0.ncols, m0.indptr,
                                    m0.indices, m0.data))


def test_pipelined_equals_serial_under_fast_switching(monkeypatch):
    """The main thread and the worker interleaved every microsecond: the
    queue's order, the failure flag and the worker's seconds still give
    the serial learn."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _run(monkeypatch, "1", "fslim_compact", "cold")
    finally:
        sys.setswitchinterval(old)
    _same(got, _serial("fslim_compact"))


# --------------------------------------------------------------------- #
# checkpoints: written by the worker, in block order
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


@pytest.mark.parametrize("depth", DEPTHS)
def test_checkpoints_in_block_order(monkeypatch, tmp_path, saves, depth):
    mat, kw = _mat("compact"), CASES["compact"][1]
    serial = _learn(monkeypatch, "0", mat, SlimConfig(
        **kw, checkpoint_dir=str(tmp_path / "serial")))
    nblocks = len(saves)
    assert [b for b, _ in saves] == list(range(nblocks))
    saves.clear()
    got = _learn(monkeypatch, depth, mat, SlimConfig(
        **kw, checkpoint_dir=str(tmp_path / "pipe")))
    _same(got, serial)
    assert [b for b, _ in saves] == list(range(nblocks))
    assert all(t.startswith("slim-harvest") for _, t in saves)
    a, b = _files(str(tmp_path / "serial")), _files(str(tmp_path / "pipe"))
    assert sorted(a) == sorted(b) == list(range(nblocks))
    for blk in a:
        x, y = _arrays(a[blk]), _arrays(b[blk])
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype


def test_resume_after_every_third_file_lost(monkeypatch, tmp_path, saves):
    """Pipelined: delete every third block file, resume bit-equal,
    re-writing exactly those blocks, in order."""
    mat, kw = _mat("compact"), CASES["compact"][1]
    cfg = SlimConfig(**kw, checkpoint_dir=str(tmp_path))
    first = _learn(monkeypatch, None, mat, cfg)
    files = _files(str(tmp_path))
    lost = sorted(files)[::3]
    before = {b: _arrays(files[b]) for b in lost}
    for b in lost:
        os.remove(files[b])
    saves.clear()
    again = _learn(monkeypatch, None, mat, cfg)
    _same(again, first)
    assert [b for b, _ in saves] == lost
    files = _files(str(tmp_path))
    for b in lost:
        after = _arrays(files[b])
        for k in before[b]:
            np.testing.assert_array_equal(after[k], before[b][k])
    assert "restore" in again[1]["phases"]


def test_failing_block_fails_the_learn(monkeypatch, tmp_path):
    """A block whose host completion raises makes the learn raise, and no
    later block's file is written after it."""
    mat, kw = _mat("compact"), CASES["compact"][1]
    real = C._Checkpoint.save

    def save(self, blk, rec):
        if blk == 1:
            raise OSError("disk full")
        return real(self, blk, rec)

    monkeypatch.setattr(C._Checkpoint, "save", save)
    with pytest.raises(OSError, match="disk full"):
        _learn(monkeypatch, "3", mat, SlimConfig(
            **kw, checkpoint_dir=str(tmp_path)))
    assert sorted(_files(str(tmp_path))) == [0]


def test_next_solve_runs_while_a_block_completes(monkeypatch, tmp_path):
    """With blocks in flight, block 0's host completion is still running
    when block 2's solve starts: the worker's checkpoint write of block 0
    waits for that solve (a serial harvest would wait for ever: the wait
    is bounded and must not time out)."""
    mat, kw = _mat("compact"), CASES["compact"][1]
    started = threading.Event()
    real_save = C._Checkpoint.save

    def save(self, blk, rec):
        if blk == 0:
            assert started.wait(30), "block 2 did not solve during block 0"
        return real_save(self, blk, rec)

    def watch(real, at):
        def solve(*a, **k):
            if int(a[at][0]) == 2 * kw["block_size"]:
                started.set()
            return real(*a, **k)
        return solve

    monkeypatch.setattr(C._Checkpoint, "save", save)
    monkeypatch.setattr(C, "cd_solve_block_compact",
                        watch(C.cd_solve_block_compact, 2))
    monkeypatch.setattr(C, "cd_solve_block_ids",
                        watch(C.cd_solve_block_ids, 1))
    got = _learn(monkeypatch, "3", _mat("compact"), SlimConfig(
        **kw, checkpoint_dir=str(tmp_path)))
    _same(got, _serial("compact"))


# --------------------------------------------------------------------- #
# the packed grid
# --------------------------------------------------------------------- #
# a 2 x 2 grid over 100 items: 400 virtual columns in 7 blocks of 64,
# blocks 1, 3 and 5 holding the columns of two points
GRID = [(0.5, 0.5), (0.5, 2.0), (2.0, 0.5), (2.0, 2.0)]
GRID_CFG = dict(block_size=64, optTol=1e-5)
_GRID_SERIAL = []


def _grid(monkeypatch, depth):
    if depth is None:
        monkeypatch.delenv("SLIM_HARVEST_CHUNK", raising=False)
    else:
        monkeypatch.setenv("SLIM_HARVEST_CHUNK", depth)
    if "grid" not in _MATS:
        _MATS["grid"] = _rand(33, 80, 100, 0.1)
    return C.estimate_grid_cd(_MATS["grid"], SlimConfig(**GRID_CFG), GRID,
                              device="cpu")


@pytest.mark.parametrize("depth", DEPTHS)
def test_grid_pipelined_equals_serial(monkeypatch, depth):
    if not _GRID_SERIAL:
        _GRID_SERIAL.append(_grid(monkeypatch, "0"))
    got = _grid(monkeypatch, depth)
    assert len(got) == len(GRID)
    for g, r in zip(got, _GRID_SERIAL[0]):
        _same(g, r)
    if depth is None:
        m = _MATS["grid"]
        ref = jax_grid(JCSR.from_arrays(m.nrows, m.ncols, m.indptr,
                                        m.indices, m.data),
                       JaxConfig(**GRID_CFG), GRID)
        for (_, s), (_, t) in zip(got, ref):
            np.testing.assert_allclose(s["loss"], t["loss"], rtol=1e-4)
            assert abs(s["nnz"] - t["nnz"]) <= max(2, 0.01 * t["nnz"])


# --------------------------------------------------------------------- #
# the card route's assembly, run on CPU tensors
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
def test_card_assembly_equals_native(case):
    """``_assemble_on_card`` on CPU tensors: entry for entry the native
    counting sort's CSR and scipy's over the concatenation."""
    from slim_tpu_torch import native

    frags, n = _fragments(case)
    lists = [[f[i] for f in frags] for i in range(3)]
    got = C._assemble_on_card(
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


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_route_learn_equals_host(monkeypatch, case, spill):
    """The learn with the card route forced on the CPU (the blocks'
    entries held, then ``_assemble_on_card``) equals the host route's
    serial learn; with the card's room for half the model's entries,
    the blocks held by then go to the host and the learn ends on the host
    route, the same model again."""
    ref = _serial(case)          # on the host route, before the patches
    monkeypatch.setattr(C, "assembly_route", lambda *a: "card")
    # room for half the model's entries, or for all of them
    monkeypatch.setattr(C, "_card_budget", lambda dev: 12 * ref[0].nnz
                        // (2 if spill else 1))
    got = _run(monkeypatch, None, case, "cold")
    _same(got, ref)
    assert ref[1]["assembly"] == "host"
    assert got[1]["assembly"] == ("host" if spill else "card")
    assert not got[1]["harvest_worker"] or spill


def test_assembly_route_choice():
    """The card route only on a CUDA device with no checkpoints and no
    shard: the CPU, a checkpoint_dir and a shard keep the host's."""
    cfg, cuda = SlimConfig(), torch.device("cuda")
    assert C.assembly_route(cuda, cfg, None) == "card"
    assert C.assembly_route(torch.device("cpu"), cfg, None) == "host"
    assert C.assembly_route(cuda, cfg.replace(checkpoint_dir="ck"),
                            None) == "host"
    assert C.assembly_route(cuda, cfg, (0, 2)) == "host"
    assert _serial("synth")[1]["assembly"] == "host"


# --------------------------------------------------------------------- #
# the replicated distributed learn (shard=), two gloo ranks
# --------------------------------------------------------------------- #
def test_shard_learn_pipelined_equals_serial():
    mat, kw = _mat("compact"), CASES["compact"][1]
    cfg = SlimConfig(**kw)
    calls = [L.Call("pipelined", D.distributed_learn, (mat, cfg)),
             L.Call("serial", D.distributed_learn, (mat, cfg),
                    env={"SLIM_HARVEST_CHUNK": "0"})]
    ranks = L.run_world(L.run_calls, 2, args=(calls, "cpu"), device="cpu",
                        backend="gloo")
    for r in ranks:
        _same(r["pipelined"]["result"], r["serial"]["result"])
    _same(ranks[0]["pipelined"]["result"], ranks[1]["pipelined"]["result"])
    _as_jax(ranks[0]["pipelined"]["result"][1], mat, cfg)
