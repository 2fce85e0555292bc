"""The port's parallel/ (torch.distributed, one process per rank, gloo on
the CPU) against the JAX package's on the same numpy data.  The JAX side
runs as tests/test_dist.py runs it, on conftest's 8-device virtual CPU
mesh; the port's ranks are spawned worlds (``parallel.launch``), one per
world shape for the whole module.  Tolerances are test_dist.py's: W atol
5e-4 and fit rtol 1e-3 at shuffle=False, optTol=1e-12; ranked ids by
``checks.ranked_mismatches``."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.io.readers import read_matrix as jax_read
from slim_tpu.mselect import mselect_pairs as jax_mselect_pairs
from slim_tpu.parallel import dist as jdist
from slim_tpu.parallel.mesh import default_mesh_shape as jax_mesh_shape
from slim_tpu.parallel.mesh import make_mesh as jax_make_mesh
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu.types import CSR as JaxCSR
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.checks import ranked_mismatches
from slim_tpu_torch.datagen import synth_longtail
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.mselect import mselect_grid, mselect_pairs
from slim_tpu_torch.ops import _build
from slim_tpu_torch.ops import gram as tgram
from slim_tpu_torch.parallel import dist as D
from slim_tpu_torch.parallel import launch as L
from slim_tpu_torch.parallel import mesh as M
from slim_tpu_torch.predict import predict_topn
from slim_tpu_torch.solvers.cd import estimate_model_cd
from slim_tpu_torch.types import CSR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TRN_CSR, TST_CSR = (os.path.join(DATA, f) for f in ("synth-train.csr",
                                                     "synth-test.csr"))
PAIRS = [(0.1, 0.5), (5.0, 0.5)]
W_ATOL, FIT_RTOL, LOSS_RTOL = 5e-4, 1e-3, 1e-5
EXACT = dict(l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def _rand(seed, nrows, ncols, density, implicit=False):
    return random_csr(None, nrows, ncols, density=density, implicit=implicit,
                      seed=seed)


# the data and configs of tests/test_dist.py, by case: (matrix, config
# kwargs, environment)
CASES = {
    "replicated": (lambda: _rand(77, 64, 40, 0.25), dict(EXACT, block_size=8),
                   {}),
    "blockwise": (lambda: _rand(78, 64, 40, 0.25), dict(EXACT, block_size=8),
                  {}),
    # 300 items, superblocks of 2 x 32; a screen budget of 128 columns
    # gives two chunks per superblock at 1 rank's width
    "chunked": (lambda: _rand(79, 96, 300, 0.18), dict(EXACT, block_size=32),
                {"SLIM_SCREEN_BYTES": str(128 * 384 * 4)}),
    "sharded_g": (lambda: _rand(81, 96, 300, 0.18),
                  dict(EXACT, block_size=16), {}),
    "fslim": (lambda: _rand(79, 60, 30, 0.3),
              dict(l1r=0.2, l2r=0.5, nnbrs=3, simtype="cos", block_size=4,
                   shuffle=False),
              {"SLIM_SCREEN_BYTES": str(128 * 300 * 4)}),
}
LEARN_FN = {"replicated": D.distributed_learn,
            "blockwise": D.distributed_learn_blockwise,
            "chunked": D.distributed_learn_blockwise,
            "sharded_g": D.distributed_learn_sharded_g,
            "fslim": D.distributed_learn_blockwise,
            "warm": D.distributed_learn_blockwise}
JAX_FN = {"replicated": jdist.distributed_learn,
          "blockwise": jdist.distributed_learn_blockwise,
          "chunked": jdist.distributed_learn_blockwise,
          "sharded_g": jdist.distributed_learn_sharded_g,
          "fslim": jdist.distributed_learn_blockwise}

# warm start (tests/test_dist.py::test_blockwise_warm_start_matches_single)
WARM_CFG = dict(l1r=0.3, l2r=0.3, block_size=4, shuffle=False)


def _warm_case():
    trn = _rand(310, 60, 40, 0.15, implicit=True)
    base, _ = jax_cd(trn, JaxConfig(**WARM_CFG))
    return trn, base


def _predict_cases():
    """(model, histories, nrcmds, env) of the dense and the COO sharded
    predict (tests/test_dist.py's)."""
    mat = _rand(5, 50, 30, 0.3)
    model, _ = jax_cd(mat, JaxConfig(l1r=0.3, l2r=0.5))
    return {"dense": (model, mat, 5, {}),
            "coo": (_rand(300, 50, 50, 0.2), _rand(301, 37, 50, 0.2), 6,
                    {"SLIM_PREDICT_COO_NPAD": "1"})}


def _last_predict_route(mesh=None):
    """A world's call: the route of the rank's latest predict_topn."""
    from slim_tpu_torch import predict

    return predict.last_route


def _routed(fn, *args, mesh=None, **kw):
    """A world's call: ``fn(*args, mesh=mesh, **kw)`` and the route of the
    rank's latest predict_topn in it (None if it made none)."""
    from slim_tpu_torch import predict

    predict.last_route = None
    return fn(*args, mesh=mesh, **kw), predict.last_route


@pytest.fixture(scope="module")
def world2():
    """Every mode in one 2-rank gloo world: {key: [rank 0's, rank 1's]}."""
    calls = [L.Call(k, LEARN_FN[k], (_port(mk()), SlimConfig(**kw)), env=env)
             for k, (mk, kw, env) in CASES.items()]
    trn, base = _warm_case()
    calls.append(L.Call("warm", D.distributed_learn_blockwise,
                        (_port(trn), SlimConfig(**WARM_CFG).replace(
                            l1r=0.4)), dict(imodel=_port(base))))
    for k, (model, hist, k_, env) in _predict_cases().items():
        calls.append(L.Call(f"predict_{k}", D.sharded_predict,
                            (_port(model), _port(hist)),
                            dict(nrcmds=k_, sparse=k == "coo"), env=env))
    # unpinned, with the native route on as outside the suite
    model, hist, k_, _ = _predict_cases()["dense"]
    on = {"SLIM_PREDICT_NATIVE_NPAD": "4096"}
    calls.append(L.Call("predict_unpinned", D.sharded_predict,
                        (_port(model), _port(hist)), dict(nrcmds=k_),
                        env=on))
    calls.append(L.Call("predict_unpinned_route", _last_predict_route,
                        env=on))
    trn, tst = read_matrix(TRN_CSR), read_matrix(TST_CSR)
    calls.append(L.Call("mselect", mselect_pairs, (trn, tst, SlimConfig(),
                                                    PAIRS)))
    calls.append(L.Call("grid", mselect_grid, (trn, tst, SlimConfig(),
                                               [1.0, 4.0], [0.5, 2.0]),
                        dict(parallel=True)))
    # the same two with the native route on, as outside the suite
    calls.append(L.Call("mselect_native_on", _routed,
                        (mselect_pairs, trn, tst, SlimConfig(), PAIRS),
                        env=on))
    calls.append(L.Call("grid_native_on", _routed,
                        (mselect_grid, trn, tst, SlimConfig(), [1.0, 4.0],
                         [0.5, 2.0]), dict(parallel=True), env=on))
    ranks = L.run_world(L.run_calls, 2, args=(calls, "cpu"), device="cpu",
                        timeout_s=600)
    return {k: [r[k] for r in ranks] for k in ranks[0]}


@pytest.fixture(scope="module")
def world4():
    """A 4-rank world on the (2, 2) mesh: the learn step (its dp group has
    two ranks) and the replicated learn."""
    a, j, caps = _step_inputs()
    mk, kw, env = CASES["replicated"]
    calls = [L.Call("step", L.learn_step, (a, j, caps, 0),
                    dict(l1r=0.5, l2r=0.5, optTol=1e-12, shuffle=False)),
             L.Call("replicated", D.distributed_learn,
                    (_port(mk()), SlimConfig(**kw)))]
    ranks = L.run_world(L.run_calls, 4, args=(calls, "cpu", (2, 2)),
                        device="cpu", timeout_s=600)
    return {k: [r[k] for r in ranks] for k in ranks[0]}


def _step_inputs():
    """tests/test_dist.py::test_sharded_learn_step's operands at 4
    devices: a dense (16, 128) matrix, 8 target columns, caps of 200."""
    rng = np.random.default_rng(0)
    a = (rng.random((16, 128)) < 0.3).astype(np.float32)
    a[:, 100:] = 0
    S = 4 * 2
    return a, np.arange(S, dtype=np.int32), np.full(S, 200, dtype=np.int32)


def _dense(m):
    return m.to_scipy().toarray()


def test_default_mesh_shape_matches_jax():
    for n in range(1, 17):
        assert M.default_mesh_shape(n) == jax_mesh_shape(n)


def test_make_mesh_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.make_mesh()


@pytest.mark.parametrize("case", list(CASES))
def test_learn_matches_jax(world2, monkeypatch, case):
    """Each mode at 2 ranks: W within 5e-4 of the JAX package's mode on its
    8-device mesh, fit within 1e-3 rel; the loss within 1e-5 rel of the
    port's single-process learn."""
    mk, kw, env = CASES[case]
    mat = mk()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm, js = JAX_FN[case](mat, JaxConfig(**kw), jax_make_mesh(8))
    model, stats = world2[case][0]["result"]
    np.testing.assert_allclose(_dense(model), _dense(jm), atol=W_ATOL)
    np.testing.assert_allclose(stats["fit"], js["fit"], rtol=FIT_RTOL)
    _, single = estimate_model_cd(_port(mat), SlimConfig(**kw), device="cpu")
    np.testing.assert_allclose(stats["loss"], single["loss"], rtol=LOSS_RTOL)
    assert stats["ndevices"] == 2 and stats["nnz"] == model.nnz


def test_blockwise_warm_start_matches_jax(world2):
    trn, base = _warm_case()
    cfg = JaxConfig(**WARM_CFG).replace(l1r=0.4)
    _, js = jdist.distributed_learn_blockwise(trn, cfg, jax_make_mesh(8),
                                              imodel=base)
    ms, ss = estimate_model_cd(_port(trn), SlimConfig(**WARM_CFG).replace(
        l1r=0.4), imodel=_port(base), device="cpu")
    model, stats = world2["warm"][0]["result"]
    assert abs(stats["loss"] - js["loss"]) <= 1e-4 * abs(js["loss"])
    assert abs(stats["loss"] - ss["loss"]) <= 1e-4 * abs(ss["loss"])
    assert model.nnz == ms.nnz


@pytest.mark.parametrize("case", list(CASES) + ["warm"])
def test_every_rank_returns_the_same_model(world2, case):
    (m0, s0), (m1, s1) = (r["result"] for r in world2[case])
    assert m0 == m1 and np.array_equal(m0.values(), m1.values())
    assert s0["loss"] == s1["loss"] and s0["nnz"] == s1["nnz"]


@pytest.mark.parametrize("route", ["dense", "coo"])
def test_sharded_predict_matches_single_device(world2, monkeypatch, route):
    """The ids of the port's single-device predict_topn (ties at the lowest
    id), the same counts and scores; every rank the same."""
    model, hist, k, env = _predict_cases()[route]
    got = world2[f"predict_{route}"]
    for a, b in zip(got[0]["result"], got[1]["result"]):
        assert np.array_equal(a, b)
    ids, sc, cnt = got[0]["result"]
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    ri, rs, rc = predict_topn(_port(model), _port(hist), nrcmds=k,
                              sparse=route == "coo", device="cpu")
    assert np.array_equal(cnt, rc)
    np.testing.assert_allclose(sc, rs, rtol=1e-5, atol=1e-6)
    assert ranked_mismatches(ids, sc, ri, rs, rc)[1] == 0


def test_sharded_predict_stays_on_the_device_routes(world2):
    """With the native route on and no route given, every rank scores its
    shard on the dense device route (as the JAX package's sharded predict
    scores on the mesh devices), with the pinned call's results."""
    assert [r["result"] for r in world2["predict_unpinned_route"]] == \
        ["dense", "dense"]
    for a, b in zip(world2["predict_unpinned"][0]["result"],
                    world2["predict_dense"][0]["result"]):
        assert np.array_equal(a, b)


def test_sharded_predict_matches_jax(world2):
    """The dense sharded predict against the JAX package's on its mesh."""
    model, hist, k, _ = _predict_cases()["dense"]
    ji, js, jc = jdist.sharded_predict(model, hist, jax_make_mesh(8), nrcmds=k)
    ids, sc, cnt = world2["predict_dense"][0]["result"]
    assert np.array_equal(cnt, jc)
    np.testing.assert_allclose(sc, js, rtol=1e-5)
    assert ranked_mismatches(ids, sc, ji, js, jc)[1] == 0


def test_learn_step_on_a_2x2_mesh_matches_jax(world4):
    """The fused step with a real dp group: x within 5e-4 of the JAX
    step's on a (2, 2) mesh; the sums the same on every rank."""
    a, j, caps = _step_inputs()
    step = jdist.sharded_learn_step(jax_make_mesh(4, (2, 2)), l1r=0.5,
                                    l2r=0.5, optTol=1e-12, shuffle=False)
    jx, _, _ = step(a, j, caps, 0)
    outs = [r["result"] for r in world4["step"]]
    x, err, obj = outs[0]
    np.testing.assert_allclose(x, np.asarray(jx), atol=W_ATOL)
    assert x.shape == (8, 128) and np.all(x >= 0)
    assert all(x[b, j[b]] == 0 for b in range(8))
    assert np.isfinite(err) and np.isfinite(obj)
    assert all(o[1] == err and o[2] == obj for o in outs)


def test_replicated_on_a_2x2_mesh(world4):
    mk, kw, _ = CASES["replicated"]
    _, single = estimate_model_cd(_port(mk()), SlimConfig(**kw), device="cpu")
    res = [r["result"] for r in world4["replicated"]]
    assert all(m == res[0][0] for m, _ in res)
    np.testing.assert_allclose(res[0][1]["loss"], single["loss"],
                               rtol=LOSS_RTOL)
    assert res[0][1]["ndevices"] == 4


def test_mselect_on_a_mesh_matches_jax(world2):
    """mselect_pairs(mesh=): one all-reduced Gram, warm starts across
    points; per point nnz ±1%, HR ±0.015, ARHR ±0.010 of the JAX package's
    mesh walk, and the same best pairs."""
    got = world2["mselect"][0]["result"]
    want = jax_mselect_pairs(jax_read(TRN_CSR), jax_read(TST_CSR),
                             JaxConfig(), PAIRS, mesh=jax_make_mesh(8))
    for g, w in zip(got["results"], want["results"]):
        assert (g["l1r"], g["l2r"]) == (w["l1r"], w["l2r"])
        assert abs(g["nnz"] - w["nnz"]) <= 0.01 * w["nnz"]
        assert abs(g["hr"] - w["hr"]) <= 0.015
        assert abs(g["arhr"] - w["arhr"]) <= 0.010
    for key in ("bestl1HR", "bestl2HR", "bestl1AR", "bestl2AR"):
        assert got[key] == want[key]
    other = world2["mselect"][1]["result"]["results"]
    assert [(r["nnz"], r["loss"]) for r in other] == \
        [(r["nnz"], r["loss"]) for r in got["results"]]


def test_packed_grid_on_a_mesh_matches_one_device(world2):
    """mselect_grid(parallel=True, mesh=): the packed blocks round-robin
    over the ranks give each point the single-device packed grid's model
    and loss."""
    got = world2["grid"][0]["result"]
    want = mselect_grid(read_matrix(TRN_CSR), read_matrix(TST_CSR),
                        SlimConfig(), [1.0, 4.0], [0.5, 2.0], parallel=True,
                        device="cpu")
    for g, w in zip(got["results"], want["results"]):
        assert (g["l1r"], g["l2r"], g["nnz"]) == (w["l1r"], w["l2r"],
                                                  w["nnz"])
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert g["hr"] == w["hr"] and g["arhr"] == w["arhr"]


def _untimed(records):
    return [{k: v for k, v in r.items()
             if k not in ("time", "time_predict", "time_metric")}
            for r in records]


@pytest.mark.parametrize("key", ["mselect", "grid"])
def test_mesh_mselect_scores_on_the_device_routes(world2, key):
    """With the native route on and no route given, the mesh walk and the
    packed grid score each point once, on rank 0's dense device route
    (the other rank scores nothing and gets rank 0's records), and no rank
    takes the native host route; every rank's records and best pairs are
    those of the run with the route off."""
    got = world2[f"{key}_native_on"]
    routes = [r["result"][1] for r in got]
    assert "native" not in routes
    assert routes == ["dense", None]
    want = world2[key][0]["result"]
    for r in got:
        res = r["result"][0]
        assert _untimed(res["results"]) == _untimed(want["results"])
        for k in ("bestl1HR", "bestl2HR", "bestl1AR", "bestl2AR"):
            assert res[k] == want[k]


def test_launcher_reraises_a_rank_failure():
    """A rank that raises stops the world, and its traceback comes back."""
    from torch.multiprocessing import ProcessRaisedException

    calls = [L.Call("bad", D.distributed_learn, (None, None))]
    with pytest.raises(ProcessRaisedException, match="AttributeError"):
        L.run_world(L.run_calls, 2, args=(calls, "cpu"), device="cpu",
                    timeout_s=120)


@pytest.mark.parametrize("entry", ["run_world", "run_calls"])
def test_launcher_without_a_device_needs_a_card(monkeypatch, entry):
    """run_world / run_calls with no device run on the card: with none
    they raise before any rank is spawned or any group is joined."""
    import torch.multiprocessing as mp

    def no_spawn(*a, **k):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "start_processes", no_spawn)
    monkeypatch.setattr(M, "init_distributed", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if entry == "run_world":
            L.run_world(_last_predict_route, 1)
        else:
            L.run_calls([])


def test_init_distributed_is_a_noop_when_initialised():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        dev = M.init_distributed("cpu")
        assert dev == torch.device("cpu") and dist.get_world_size() == 1
        group = dist.group.WORLD
        assert M.init_distributed("cpu") == dev
        assert dist.group.WORLD is group
        mesh = M.make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("dp", "mp") and mesh.size() == 1
    finally:
        dist.destroy_process_group()


def test_one_rank_world_leaves_no_files(tmp_path, monkeypatch):
    """A world started without torchrun's environment writes nothing
    into the temporary directory."""
    import tempfile

    import torch.distributed as dist

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    try:
        M.make_mesh(device="cpu")
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert os.listdir(tmp_path) == []


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo world in this process, destroyed after the test."""
    import torch.distributed as dist

    mesh = M.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("step", [1 << 26, 128 * 37])
def test_screen_flags_match_scipy(one_rank_mesh, monkeypatch, step):
    """The blockwise screen's union flags of a chunk of targets, in one
    step or in steps of 37 entries: the rows i with (AᵀA)[i, j] > l1r for
    some target j != i, as scipy computes them."""
    monkeypatch.setattr(D, "SCREEN_STEP_FLOATS", step)
    m = _port(_rand(82, 120, 500, 0.08))
    R = D._Ranked(m, SlimConfig(block_size=64), one_rank_mesh, 512)
    A = R.part.to_scipy()
    jc = np.full(128, R.npad - 1)
    jc[:90] = np.arange(10, 100)
    got = D._screen_flags(R, torch.from_numpy(jc), 128, 0.5, 0, "cos")
    aty = (A.T @ A[:, jc[:90]]).toarray()
    act = aty > 0.5
    act[jc[:90], np.arange(90)] = False
    want = np.zeros(R.npad, bool)
    want[:aty.shape[0]] = act.any(axis=1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["replicated", "blockwise", "sharded_g"])
def test_cli_under_torchrun_meets_the_synth_goldens(tmp_path, mode):
    """``torchrun --nproc-per-node 2 ... slim_learn --dist <mode>
    -device=cpu`` on the vendored synth set: loss 4730.0005 rtol 1e-4,
    nnz 10,613 ±1% (tests/test_goldens.py); rank 0 writes the model."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "slim_tpu_torch.cli.slim_learn",
         f"--dist={mode}", "-ifmt=ijv", "-device=cpu",
         os.path.join(DATA, "synth-train.ijv"), str(tmp_path / "m.model")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"dist: {mode}, ranks: 2" in out.stdout
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)",
                          out.stdout).groups()
    np.testing.assert_allclose(float(loss), 4730.0005, rtol=1e-4)
    assert abs(int(nnz) - 10613) <= 0.01 * 10613
    assert (tmp_path / "m.model").exists()


@pytest.mark.parametrize("binary", [True, False])
def test_gram_partial_compact_and_column_block(binary):
    """The accumulator behind the distributed Grams: through a column map
    it is G[S, S], with ``cols`` the column block G[:, c0:c1], both equal
    to the host Gram."""
    m = _port(_rand(11, 90, 300, 0.1, implicit=binary))
    G = tgram.gram_host(m, pad_to=384)
    S = np.array([0, 3, 7, 100, 299] + [383] * 123)
    pos = np.full(300, 128, np.int32)
    pos[S[:5]] = np.arange(5)
    got = tgram.gram_partial(m, 128, "cpu", col_map=torch.from_numpy(pos))
    assert got.dtype == (torch.int32 if binary else torch.float32)
    want = np.zeros((128, 128), np.float32)
    want[:5, :5] = G[np.ix_(S[:5], S[:5])]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6)
    blk = tgram.gram_partial(m, 384, "cpu", cols=(128, 256))
    np.testing.assert_allclose(blk.float().numpy(), G[:, 128:256], rtol=1e-6)


def test_build_names_objects_per_process(tmp_path, monkeypatch):
    """Concurrent builds never share a file: each object and the unlinked
    library carry the builder's pid, the objects go after the link, and
    the library takes its name by rename."""
    seen = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return b"", b""

    class Done:
        returncode, stdout = 0, b""

    def link(cmd, **kw):
        seen.append(cmd[-1])
        open(cmd[-1], "w").close()
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", link)
    so = _build.build()
    pid = str(os.getpid())
    assert len(seen) == len(_build._sources()) + 1
    assert all(pid in os.path.basename(p) for p in seen)
    assert sorted(os.listdir(tmp_path)) == [so.name]


# sha256 (first 32 hex digits) of 200,000 draws of numpy 2.0.2's
# default_rng(seed).zipf(a) as little-endian int64, and their largest
ZIPF_NUMPY_2_0 = {
    (1.2, 0): ("fac1c3112805bb2465e37804febd37cc", 7996117113832041472),
    (1.25, 1): ("c6e1f16ab7b9648e9b96f2a1fbade73a", 7568427690311713792),
    (1.3, 7): ("e389f18b85a1e9925915cef5c20e0788", 2742992055456998400),
    (1.01, 2): ("cca3f4a75b388f4a25966c5907814bba", 9219302882762770432),
}
# the same digest of scripts/amazon2m_dryrun.py's matrix under numpy 2.0.2
# (indptr then indices, little-endian int64), and its nnz
LONGTAIL_NUMPY_2_0 = ("b33790b1c1d2ce483fff1fdb5d940854", 349_171)


def _digest(*arrays) -> str:
    import hashlib

    return hashlib.sha256(b"".join(
        np.asarray(a).astype("<i8").tobytes() for a in arrays)).hexdigest()[:32]


@pytest.mark.parametrize("a,seed", [(1.2, 0), (1.25, 1), (1.3, 7), (1.01, 2)])
def test_zipf_draws_numpy_2_0_stream(a, seed):
    """datagen.zipf draws what numpy 2.0's Generator.zipf draws, whatever
    numpy runs: held to stored draws, huge values (2^40 and more)
    included."""
    from slim_tpu_torch.datagen import zipf

    got = zipf(np.random.default_rng(seed), a, 200_000)
    assert (_digest(got), int(got.max())) == ZIPF_NUMPY_2_0[(a, seed)]


def test_synth_longtail_is_the_dryrun_workload():
    """datagen.synth_longtail equals scripts/amazon2m_dryrun.py's matrix:
    built as the script builds it (with numpy 2.0's zipf draws) into the
    JAX package's CSR, and held to the script's matrix under numpy 2.0."""
    from slim_tpu_torch.datagen import zipf

    nrows, ncols, nnz = 50_000, 2_000_000, 400_000
    rng = np.random.default_rng(0)
    users = rng.integers(0, nrows, nnz)
    items = (zipf(rng, 1.2, nnz * 2) % 2000)[:nnz] * 997 % ncols
    want = JaxCSR.from_ijv(users, items, np.ones(nnz, np.float32), nrows,
                           ncols).binarize()
    got = synth_longtail()
    assert got.shape == want.shape and got.data is None
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert (_digest(got.indptr, got.indices), got.nnz) == LONGTAIL_NUMPY_2_0
