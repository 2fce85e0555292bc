"""Host layer of the PyTorch port against the JAX package: file formats,
evaluation, synthetic data, config, and the jax-free import."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import slim_tpu.datagen as jdatagen
import slim_tpu.eval as jeval
import slim_tpu.io as jio
from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu_torch import convert
from slim_tpu_torch import datagen as tdatagen
from slim_tpu_torch import eval as teval
from slim_tpu_torch import io as tio
from slim_tpu_torch.config import SlimConfig
from slim_tpu_torch.types import CSR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_csr(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


@pytest.mark.parametrize("fmt", ["csr", "csrnv", "cluto", "ijv", "binrow"])
def test_write_read_round_trip_byte_equal(tmp_path, fmt):
    """Writing tests/data's train set in each format gives the JAX
    package's bytes, and reading them back gives its matrix."""
    jm = jio.read_matrix(os.path.join(DATA, "synth-train.ijv"), fmt="ijv")
    tm = tio.read_matrix(os.path.join(DATA, "synth-train.ijv"), fmt="ijv")
    assert tm == _port_csr(jm)
    pj, pt = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
    jio.write_matrix(jm, str(pj), fmt=fmt)
    tio.write_matrix(tm, str(pt), fmt=fmt)
    assert pj.read_bytes() == pt.read_bytes()
    back_j = jio.read_matrix(str(pj), fmt=fmt)
    back_t = tio.read_matrix(str(pt), fmt=fmt)
    np.testing.assert_array_equal(back_t.indptr, back_j.indptr)
    np.testing.assert_array_equal(back_t.indices, back_j.indices)
    np.testing.assert_array_equal(back_t.values(), back_j.values())
    assert back_t.shape == back_j.shape


@pytest.mark.parametrize("name", ["synth-train.csr", "synth-test.csr"])
def test_read_vendored_csr_equal(name):
    a = jio.read_matrix(os.path.join(DATA, name), fmt="csr")
    b = tio.read_matrix(os.path.join(DATA, name), fmt="csr")
    assert b == _port_csr(a) and b.shape == a.shape


def test_eval_matches_jax(rng):
    trn = random_csr(rng, 40, 30, density=0.2)
    tst = random_csr(rng, 40, 30, density=0.1)
    ids = rng.integers(-1, 30, (40, 10)).astype(np.int32)
    counts = rng.integers(-1, 11, 40).astype(np.int32)
    fm_j = jeval.determine_head_tail(trn, 30)
    fm_t = teval.determine_head_tail(_port_csr(trn), 30)
    np.testing.assert_array_equal(fm_j, fm_t)
    for req in (False, True):
        rj = jeval.evaluate_topn(ids, counts, tst, fm_j,
                                 require_test_items=req)
        rt = teval.evaluate_topn(ids, counts, _port_csr(tst), fm_t,
                                 require_test_items=req)
        assert dataclasses.asdict(rj) == dataclasses.asdict(rt)


def test_synth_ml20m_arrays_equal():
    a = jdatagen.synth_ml20m(seed=0, scale=0.01)
    b = tdatagen.synth_ml20m(seed=0, scale=0.01)
    assert a.shape == b.shape and b.data is None
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def test_config_round_trip():
    jc = JaxConfig(l1r=0.5, l2r=2.0, optTol=1e-6, maxniters=77, seed=3,
                   block_size=128, compact_threshold=1024, shuffle=False)
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(SlimConfig()) == dataclasses.asdict(JaxConfig())
    assert dataclasses.asdict(SlimConfig.from_dict({"niters": 9})) \
        == dataclasses.asdict(JaxConfig.from_dict({"niters": 9}))
    with pytest.raises(ValueError):
        convert.config_from_dict({"l1r": -1.0})


def test_model_from_numpy(rng):
    m = random_csr(rng, 12, 12, density=0.3)
    t = convert.model_from_numpy(m.indptr, m.indices, m.data, 12, 12)
    assert t == _port_csr(m)
    t0 = convert.model_from_numpy(m.indptr, m.indices, None, 12, 12)
    assert t0.data is None and t0.nnz == m.nnz


def test_dev_put_caches_per_device(rng):
    import torch

    m = _port_csr(random_csr(rng, 5, 7, density=0.5))
    calls = []

    def build():
        calls.append(1)
        return m.indices.astype(np.int32)

    a = m.dev_put("idx32", build, "cpu")
    b = m.dev_put("idx32", build, torch.device("cpu"))
    assert a is b and len(calls) == 1 and a.dtype == torch.int32


@pytest.mark.parametrize("change", ["indices", "data"])
def test_history_changed_in_place_is_not_scored_stale(change):
    """After one predict_topn call, a write into the history's ids or
    ratings through the CSR either raises or is scored by the next call:
    its result is a fresh CSR's of the arrays as they then are (the
    device-upload cache never serves the old arrays)."""
    from slim_tpu_torch.predict import predict_topn

    rng = np.random.default_rng(12)
    model = _port_csr(random_csr(rng, 40, 40, density=0.2))
    hist = _port_csr(random_csr(rng, 30, 40, density=0.15))
    predict_topn(model, hist, nrcmds=5, sparse=False, device="cpu")
    try:
        if change == "indices":
            hist.indices[:] = (hist.indices + 7) % 40
        else:
            hist.data[:] = hist.data[::-1] * 2
    except ValueError:
        pass                                    # refused: nothing changed
    fresh = CSR.from_arrays(hist.nrows, hist.ncols, hist.indptr.copy(),
                            hist.indices.copy(), hist.data.copy())
    got = predict_topn(model, hist, nrcmds=5, sparse=False, device="cpu")
    want = predict_topn(model, fresh, nrcmds=5, sparse=False, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_csr_arrays_are_read_only_views():
    """A CSR views the arrays it is built from, read-only: writes through
    it raise, the caller's arrays keep their flags and memory, and the
    CSRs that transforms return are read-only too."""
    indptr = np.array([0, 2, 3], np.int64)
    indices = np.array([1, 2, 0], np.int32)
    data = np.array([1.0, 2.0, 3.0], np.float32)
    m = CSR.from_arrays(2, 3, indptr, indices, data)
    for own, mine in ((indptr, m.indptr), (indices, m.indices),
                      (data, m.data)):
        assert own.flags.writeable and not mine.flags.writeable
        assert np.shares_memory(own, mine)
        with pytest.raises(ValueError, match="read-only"):
            mine[0] = mine[0]
    for t in (m.binarize(), m.transpose(), m.with_ncols(5),
              m.sum_duplicate_entries()):
        assert not t.indices.flags.writeable
        assert not t.indptr.flags.writeable


def test_freed_device_pack_raises():
    """DeviceModelPack.free() drops the pack and its dense W; densify()
    after it raises, naming the call."""
    from slim_tpu_torch import learn

    m = _port_csr(random_csr(np.random.default_rng(13), 60, 30,
                             density=0.2))
    _, stats = learn(m, SlimConfig(l1r=0.5, l2r=0.5), keep_device_model=True,
                     device="cpu")
    pack = stats["W_dev"]
    assert pack.densify().shape == (pack.npad, pack.npad)
    pack.free()
    assert pack.vals is None and pack.idx is None and pack._W is None
    with pytest.raises(RuntimeError, match="free"):
        pack.densify()


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import slim_tpu_torch, slim_tpu_torch.cli.slim_learn, "
            "slim_tpu_torch.cli.slim_predict, slim_tpu_torch.convert, "
            "slim_tpu_torch.parallel, slim_tpu_torch.parallel.launch; "
            "assert 'slim_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
