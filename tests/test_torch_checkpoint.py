"""Checkpoint / resume of the port's CD learn (``solvers/cd._Checkpoint`` in
``estimate_model_cd``) against the JAX package's (slim_tpu/solvers/
cd.py:223-293): one file per block, resumed blocks loaded instead of
solved, a signature that keeps other runs' files out."""

import glob
import os

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu_torch import SlimConfig, learn
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


def _port(mat):
    return CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                           mat.data)


@pytest.fixture
def solves(monkeypatch):
    """The target ranks of every block solve the learns below run."""
    seen = []
    real = C.cd_solve_block_ids
    monkeypatch.setattr(C, "cd_solve_block_ids", lambda *a, **k: seen.append(
        int(a[1][0])) or real(*a, **k))
    return seen


def _cfg(tmp_path, **kw):
    return SlimConfig(**dict(dict(l1r=0.4, l2r=0.6, block_size=16), **kw),
                      checkpoint_dir=str(tmp_path))


def _files(tmp_path):
    return sorted(glob.glob(str(tmp_path / "cdblk_*")))


def test_resume_after_a_lost_block(tmp_path, solves):
    """One file per block; after one is lost, only its block is solved
    again and the model is the first one (W equal, loss rtol 1e-6, as
    tests/test_checkpoint.py:25-27)."""
    mat = _port(random_csr(np.random.default_rng(91), 50, 40, density=0.25))
    m1, s1 = C.estimate_model_cd(mat, _cfg(tmp_path), device="cpu")
    files = _files(tmp_path)
    assert len(files) == (40 + 15) // 16 and solves == [0, 16, 32]
    os.remove(files[1])
    solves.clear()
    m2, s2 = C.estimate_model_cd(mat, _cfg(tmp_path), device="cpu")
    assert solves == [16]
    np.testing.assert_array_equal(m1.to_dense(), m2.to_dense())
    np.testing.assert_allclose(s2["loss"], s1["loss"], rtol=1e-6)
    assert s2["sweeps"] == s1["sweeps"] and s2["niters"] == s1["niters"]
    # the block files are written in the phase "checkpoint"
    assert "restore" in s2["phases"] and "checkpoint" in s2["phases"]
    # another l1r never takes these files
    solves.clear()
    C.estimate_model_cd(mat, _cfg(tmp_path).replace(l1r=0.9), device="cpu")
    assert solves == [0, 16, 32]


def test_full_restore_solves_nothing(tmp_path, solves, monkeypatch):
    """With every block on disk the learn launches no solve and no pack,
    returns the same model, and a kept device model is None (as in the
    JAX package: restored blocks have no device pack)."""
    mat = _port(random_csr(np.random.default_rng(3), 40, 30, density=0.3))
    m1, _ = C.estimate_model_cd(mat, _cfg(tmp_path), device="cpu")
    solves.clear()
    monkeypatch.setattr(C, "pack", None)          # any pack call fails
    m2, s2 = C.estimate_model_cd(mat, _cfg(tmp_path), keep_device_model=True,
                                 device="cpu")
    assert solves == [] and s2["W_dev"] is None
    np.testing.assert_array_equal(m2.to_dense(), m1.to_dense())


def test_unreadable_file_is_solved_again(tmp_path, solves):
    mat = _port(random_csr(np.random.default_rng(4), 40, 30, density=0.3))
    m1, _ = C.estimate_model_cd(mat, _cfg(tmp_path), device="cpu")
    with open(_files(tmp_path)[0], "wb") as f:
        f.write(b"not a zip")
    solves.clear()
    m2, _ = C.estimate_model_cd(mat, _cfg(tmp_path), device="cpu")
    assert solves == [0]
    np.testing.assert_array_equal(m2.to_dense(), m1.to_dense())


def _sig(cfg, mat, B=16, imodel=None):
    return C._Checkpoint(cfg, mat, mat.ncols, B, imodel).sig


@pytest.mark.parametrize("change", ["entries", "warm_model", "block_width",
                                    "compact_threshold", "compact_frac"])
def test_signature_keys(tmp_path, monkeypatch, change):
    """The signature changes with the train entries (same shape and nnz),
    the warm-start model, the effective block width, compact_threshold and
    SLIM_COMPACT_FRAC."""
    mat = random_csr(np.random.default_rng(93), 50, 40, density=0.25)
    cfg = _cfg(tmp_path)
    base = _sig(cfg, _port(mat))
    assert _sig(cfg, _port(mat)) == base
    if change == "entries":
        data = mat.data.copy()
        data[0] += 1.0
        other = _sig(cfg, CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr,
                                          mat.indices, data))
    elif change == "warm_model":
        imodel = _port(random_csr(np.random.default_rng(94), 40, 40,
                                  density=0.1))
        other = _sig(cfg, _port(mat), imodel=imodel)
    elif change == "block_width":
        other = _sig(cfg, _port(mat), B=8)
    elif change == "compact_threshold":
        other = _sig(cfg.replace(compact_threshold=256), _port(mat))
    else:
        monkeypatch.setenv("SLIM_COMPACT_FRAC", "0.5")
        other = _sig(cfg, _port(mat))
    assert other != base


def test_jax_checkpoint_files_are_not_taken(tmp_path, solves):
    """Files the JAX package's _Checkpoint wrote for the same data and
    config stay untouched: the port solves every block and writes its own;
    its model meets the JAX learn (loss rtol 1e-4, nnz ±1%)."""
    mat = random_csr(np.random.default_rng(95), 50, 40, density=0.25)
    _, sj = jax_cd(mat, JaxConfig(l1r=0.4, l2r=0.6, block_size=16,
                                  checkpoint_dir=str(tmp_path)))
    theirs = _files(tmp_path)
    assert len(theirs) == 3
    _, st = C.estimate_model_cd(_port(mat), _cfg(tmp_path), device="cpu")
    assert solves == [0, 16, 32]
    assert len(_files(tmp_path)) == 6 and set(theirs) < set(_files(tmp_path))
    np.testing.assert_allclose(st["loss"], sj["loss"], rtol=1e-4)
    assert abs(st["nnz"] - sj["nnz"]) <= 0.01 * sj["nnz"]


def test_no_files_without_checkpoint_dir(tmp_path, monkeypatch):
    """checkpoint_dir "" (the default) writes nothing, in the working
    directory or anywhere under it."""
    monkeypatch.chdir(tmp_path)
    mat = _port(random_csr(np.random.default_rng(92), 30, 20, density=0.3))
    learn(mat, SlimConfig(l1r=0.5, l2r=0.5), device="cpu")
    assert not list(tmp_path.rglob("*"))


def test_warm_started_resume_on_the_compact_path(tmp_path):
    """A warm-started learn on the compact path (blocks in their union
    spaces) resumes to the same model; a cold learn with the same config
    does not take the warm run's files."""
    mat = _port(random_csr(np.random.default_rng(96), 200, 300, density=0.05,
                           implicit=True))
    cfg = _cfg(tmp_path, compact_threshold=256, block_size=64)
    warm, _ = learn(mat, SlimConfig(l1r=0.8, l2r=0.6, block_size=64),
                    device="cpu")
    m1, s1 = learn(mat, cfg, imodel=warm, device="cpu")
    assert s1["union_widths"]
    files = _files(tmp_path)
    os.remove(files[2])
    m2, _ = learn(mat, cfg, imodel=warm, device="cpu")
    np.testing.assert_array_equal(m2.to_dense(), m1.to_dense())
    assert len(_files(tmp_path)) == len(files)
    learn(mat, cfg, device="cpu")
    assert len(_files(tmp_path)) == 2 * len(files)
