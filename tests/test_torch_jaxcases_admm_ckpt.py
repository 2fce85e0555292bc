"""The JAX package's own ADMM and checkpoint cases (tests/test_admm.py and
tests/test_checkpoint.py) run on the port, on the CPU (``device="cpu"``).

Each case builds its input as the JAX test does and asserts what it
asserts, with its tolerances.  Where the JAX test compares a result with a
number (the float64 oracle, the fit of the data), the port's objective is
also held to ``slim_tpu``'s on JAX-CPU on the same matrix.  The JAX
package's distributed checkpoint case runs its mesh of 8 devices in one
process; the port runs one process per device, and
tests/test_torch_dist.py resumes the port's superblocks."""

import glob
import os

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.admm import estimate_model_admm as jax_admm
from slim_tpu.solvers.cd import estimate_model_cd as jax_cd
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.solvers.admm import (admm_solve, admm_solve_f64,
                                         estimate_model_admm)
from slim_tpu_torch.solvers.cd import _Checkpoint, estimate_model_cd
from slim_tpu_torch.types import CSR

from test_admm import oracle_admm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    """The port's CSR of a JAX CSR's arrays."""
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def _admm(mat, cfg):
    return estimate_model_admm(_port(mat), cfg, device="cpu")


def _dense(model):
    return model.to_scipy().toarray()


# --------------------------------------------------------------------- #
# tests/test_admm.py
# --------------------------------------------------------------------- #
def test_admm_matches_oracle(rng):
    mat = random_csr(rng, 40, 12, density=0.35)
    A = mat.to_dense()
    cfg = SlimConfig(l1r=1.0, l2r=1.0, algo="admm")
    model, stats = _admm(mat, cfg)
    W_ref = oracle_admm(A, 1.0, 1.0)
    W_ours = _dense(model)
    W_ref = np.where(W_ref > 0, W_ref, 0)
    np.testing.assert_allclose(W_ours, W_ref, atol=2e-2)

    def fit(W):
        R = A.astype(np.float64) - A.astype(np.float64) @ W
        return np.sum(R * R)

    assert abs(fit(W_ours) - fit(W_ref)) < 1e-3 * max(fit(W_ref), 1.0)
    _, ref = jax_admm(mat, JaxConfig(**vars(cfg)))
    np.testing.assert_allclose(stats["loss"], ref["loss"], rtol=1e-4)


def test_admm_f64_parity_mode(rng):
    mat = random_csr(rng, 45, 14, density=0.35)
    A = mat.to_dense().astype(np.float64)
    npad = 16
    T = np.zeros((npad, npad), np.float32)
    T[:14, :14] = (A.T @ A).astype(np.float32)
    W32, err, obj = admm_solve(torch.from_numpy(T), 0.8, 1.2)
    W64 = admm_solve_f64(torch.from_numpy(T), 0.8, 1.2)
    np.testing.assert_allclose(W32.numpy(), W64.numpy(), atol=2e-2)
    assert float(obj) >= float(err) > 0.0


def test_admm_stats_have_loss(rng):
    mat = random_csr(rng, 40, 12, density=0.35)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, algo="admm")
    model, stats = _admm(mat, cfg)
    A = mat.to_dense().astype(np.float64)
    W = _dense(model)
    R = A - A @ W
    err_ref = 0.5 * np.sum(R * R)
    obj_ref = err_ref + 0.5 * 1.0 * np.sum(W * W) + 1.0 * np.sum(np.abs(W))
    assert stats["loss"] > 0
    np.testing.assert_allclose(stats["fit"], err_ref, rtol=5e-3, atol=1e-2)
    np.testing.assert_allclose(stats["loss"], obj_ref, rtol=5e-3, atol=1e-2)
    _, ref = jax_admm(mat, JaxConfig(**vars(cfg)))
    np.testing.assert_allclose(stats["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(stats["fit"], ref["fit"], rtol=1e-4)


def test_admm_zero_diagonal(rng):
    mat = random_csr(rng, 50, 15, density=0.3)
    model, _ = _admm(mat, SlimConfig(l1r=0.5, l2r=2.0, algo="admm"))
    W = _dense(model)
    assert np.all(np.abs(np.diag(W)) < 1e-3)
    assert np.all(W >= 0)


def test_admm_vs_cd_similar_quality(rng):
    mat = random_csr(rng, 60, 20, density=0.3)
    cd_model, _ = estimate_model_cd(_port(mat), SlimConfig(l1r=1.0, l2r=1.0),
                                    device="cpu")
    admm_model, _ = _admm(mat, SlimConfig(l1r=1.0, l2r=1.0, algo="admm"))
    A = mat.to_dense().astype(np.float64)

    def fit(W):
        R = A - A @ W
        return np.sum(R * R)

    base = np.sum(A * A)
    assert fit(_dense(cd_model)) < base
    assert fit(_dense(admm_model)) < base


# --------------------------------------------------------------------- #
# tests/test_checkpoint.py
# --------------------------------------------------------------------- #
def test_checkpoint_resume_identical(tmp_path, rng):
    mat = random_csr(rng, 50, 40, density=0.25, seed=91)
    cfg = SlimConfig(l1r=0.4, l2r=0.6, block_size=16,
                     checkpoint_dir=str(tmp_path), shuffle=False)
    m1, s1 = estimate_model_cd(_port(mat), cfg, device="cpu")
    files = glob.glob(str(tmp_path / "cdblk_*"))
    assert len(files) == (40 + 15) // 16

    os.remove(files[1])
    m2, s2 = estimate_model_cd(_port(mat), cfg, device="cpu")
    np.testing.assert_allclose(_dense(m1), _dense(m2), atol=1e-7)
    np.testing.assert_allclose(s1["loss"], s2["loss"], rtol=1e-6)

    cfg3 = cfg.replace(l1r=0.9)
    m3, _ = estimate_model_cd(_port(mat), cfg3, device="cpu")
    assert m3.nnz != m1.nnz or not np.allclose(_dense(m3), _dense(m1))
    _, ref = jax_cd(mat, JaxConfig(**vars(cfg.replace(checkpoint_dir=None))))
    np.testing.assert_allclose(s2["loss"], ref["loss"], rtol=1e-4)


def test_checkpoint_keyed_by_warmstart_and_data(tmp_path, rng):
    """As the JAX case; the port's signature also takes the block width
    (``B``), here the block size the learn would use."""
    mat = _port(random_csr(rng, 50, 40, density=0.25, seed=93))
    imodel = _port(random_csr(rng, 40, 40, density=0.1, seed=94))
    cfg = SlimConfig(l1r=0.4, l2r=0.6, checkpoint_dir=str(tmp_path))
    B = cfg.block_size

    sig_plain = _Checkpoint(cfg, mat, 40, B).sig
    sig_warm = _Checkpoint(cfg, mat, 40, B, imodel).sig
    assert sig_plain != sig_warm

    mat2 = _port(random_csr(rng, 50, 40, density=0.25, seed=95))
    assert _Checkpoint(cfg, mat2, 40, B).sig != sig_plain


def test_checkpoint_off_by_default(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mat = random_csr(rng, 30, 20, density=0.3, seed=92)
    estimate_model_cd(_port(mat), SlimConfig(l1r=0.5, l2r=0.5), device="cpu")
    assert not glob.glob(str(tmp_path / "cdblk_*"))
