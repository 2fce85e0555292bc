"""ADMM of the PyTorch port against the JAX package (slim_tpu/solvers/
admm.py) on JAX-CPU: the solve on one Gram, its float64 version, the
stats, ``api.learn(algo="admm")`` and the two CLIs' ``--algo admm``."""

import os
import re

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.api import learn as jax_learn
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.io.readers import read_matrix as jax_read
from slim_tpu.mselect import mselect_pairs as jax_mselect_pairs
from slim_tpu.solvers import admm as JA
from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch.cli import slim_learn, slim_mselect
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.solvers import admm as TA
from slim_tpu_torch.types import CSR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


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


def _gram(seed, nrows=45, ncols=14, npad=16):
    """A padded float32 Gram of a random valued matrix, and the matrix."""
    mat = random_csr(np.random.default_rng(seed), nrows, ncols, density=0.35)
    A = mat.to_dense().astype(np.float64)
    T = np.zeros((npad, npad), np.float32)
    T[:ncols, :ncols] = (A.T @ A).astype(np.float32)
    return T, A


@pytest.mark.parametrize("l1r,l2r", [(0.8, 1.2), (3.0, 0.5)])
def test_admm_solve_matches_jax(l1r, l2r):
    """The port's f32 solve against the JAX f32 solve on the same T: W
    atol 2e-2 (tests/test_admm.py's), err and obj rtol 5e-3; the float64
    versions to 1e-9."""
    T, _ = _gram(1)
    W, err, obj = TA.admm_solve(torch.from_numpy(T), l1r, l2r)
    Wj, errj, objj = JA.admm_solve(T, l1r, l2r, 14)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), atol=2e-2)
    np.testing.assert_allclose(err, float(errj), rtol=5e-3)
    np.testing.assert_allclose(obj, float(objj), rtol=5e-3)
    W64 = TA.admm_solve_f64(torch.from_numpy(T), l1r, l2r)
    assert W64.dtype == torch.float64
    np.testing.assert_allclose(W64.numpy(),
                               JA.admm_solve_f64(T, l1r, l2r, 14), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(W.numpy(), W64.numpy(), atol=2e-2)
    assert obj >= err > 0.0


def test_admm_stats_and_zero_diagonal():
    """loss and fit against the dense residual of the sparsified model
    (rtol 5e-3, tests/test_admm.py:75-76); the diagonal ~0, W >= 0."""
    mat = random_csr(np.random.default_rng(2), 50, 15, density=0.3)
    cfg = SlimConfig(l1r=0.5, l2r=2.0, algo="admm")
    model, stats = TA.estimate_model_admm(_port(mat), cfg, device="cpu")
    A = mat.to_dense().astype(np.float64)
    W = model.to_dense().astype(np.float64)
    R = A - A @ W
    err = 0.5 * np.sum(R * R)
    obj = err + 0.5 * 2.0 * np.sum(W * W) + 0.5 * np.sum(np.abs(W))
    np.testing.assert_allclose(stats["fit"], err, rtol=5e-3, atol=1e-2)
    np.testing.assert_allclose(stats["loss"], obj, rtol=5e-3, atol=1e-2)
    assert np.all(np.abs(np.diag(W)) < 1e-3) and np.all(W >= 0)
    assert stats["nnz"] == model.nnz and 0 < stats["density"] <= 1
    assert set(stats["phases"]) == {"gram", "factor", "iterate", "sparsify"}


@pytest.mark.parametrize("implicit", [False, True])
def test_learn_admm_matches_jax_learn(implicit):
    """api.learn(algo="admm") against the JAX api.learn: W atol 2e-2, loss
    and fit rtol 1e-4, nnz ±1%; an imodel is ignored."""
    mat = random_csr(np.random.default_rng(3), 80, 40, density=0.2,
                     implicit=implicit)
    model, st = learn(_port(mat), SlimConfig(l1r=1.0, l2r=1.0, algo="admm"),
                      device="cpu")
    mj, sj = jax_learn(mat, JaxConfig(l1r=1.0, l2r=1.0, algo="admm"))
    np.testing.assert_allclose(model.to_dense(), mj.to_dense(), atol=2e-2)
    np.testing.assert_allclose(st["loss"], sj["loss"], rtol=1e-4)
    np.testing.assert_allclose(st["fit"], sj["fit"], rtol=1e-4)
    assert abs(st["nnz"] - sj["nnz"]) <= 0.01 * sj["nnz"]
    again, _ = learn(_port(mat), SlimConfig(algo="admm"), imodel=model,
                     device="cpu")
    assert again == model


def test_factor_raises_instead_of_nans():
    """A Gram whose shifted matrix is not positive definite stops the solve
    at the Cholesky (info != 0), and a NaN in the Gram stops it too,
    instead of returning NaNs."""
    T = torch.diag(torch.full((8,), -2e4))
    with pytest.raises(RuntimeError, match="Cholesky"):
        TA.admm_solve(T, 1.0, 1.0)
    T = torch.eye(8)
    T[2, 5] = float("nan")
    with pytest.raises(RuntimeError, match="ADMM"):
        TA.admm_solve(T, 1.0, 1.0)


def _learned(out):
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)", out).groups()
    return int(nnz), float(loss)


def test_learn_cli_admm(tmp_path, capsys):
    """slim_learn --algo admm on the synth set: the model file against the
    JAX CLI's (atol 2e-2), loss rtol 1e-4."""
    from slim_tpu.cli import slim_learn as jax_learn_cli

    trn = os.path.join(DATA, "synth-train.ijv")
    mine, theirs = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    assert slim_learn.main(["-device=cpu", "-ifmt=ijv", "-algo=admm", trn,
                            mine]) == 0
    got = _learned(capsys.readouterr().out)
    assert jax_learn_cli.main(["-ifmt=ijv", "-algo=admm", trn, theirs]) == 0
    want = _learned(capsys.readouterr().out)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    a = read_matrix(mine, fmt="ijv").to_dense()
    b = jax_read(theirs, fmt="ijv").to_dense()
    np.testing.assert_allclose(a, b[:a.shape[0], :a.shape[1]], atol=2e-2)


def test_mselect_cli_admm(tmp_path, capsys, monkeypatch):
    """slim_mselect --algo admm selects the JAX package's pair, and each
    point's HR / ARHR is the JAX ADMM walk's within ±0.015 / ±0.010."""
    trn, tst = (os.path.join(DATA, f"synth-{s}.csr") for s in ("train",
                                                                "test"))
    l12 = os.path.join(DATA, "l12file")
    monkeypatch.chdir(tmp_path)
    assert slim_mselect.main(["-device=cpu", "-algo=admm", trn, tst,
                              l12]) == 0
    out = capsys.readouterr().out
    pairs = [tuple(map(float, ln.split())) for ln in open(l12)]
    want = jax_mselect_pairs(jax_read(trn), jax_read(tst),
                             JaxConfig(algo="admm"), pairs)
    got = [tuple(map(float, m)) for m in re.findall(   # the CLI's lines
        r"hr: (\S+) hr_head: \S+ hr_tail: \S+ arhr: (\S+) time: \S+$", out,
        re.M)]
    assert len(got) == len(pairs)
    for (hr, arhr), w in zip(got, want["results"]):
        assert abs(hr - w["hr"]) <= 0.015 and abs(arhr - w["arhr"]) <= 0.010
    sel = re.search(r"selected hyperparameters are l1r: (\S+) l2r: (\S+)",
                    out).groups()
    assert tuple(map(float, sel)) == (want["bestl1HR"], want["bestl2HR"])
    for l1, l2 in pairs:
        assert (tmp_path / f"{l1} {l2}.model").exists()
