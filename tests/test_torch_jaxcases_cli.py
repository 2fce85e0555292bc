"""The JAX package's own CLI cases (tests/test_cli.py) run on the port's
three programs, in process, on the CPU (``-device=cpu`` on every call).

Each case writes its files as the JAX test does and asserts what it
asserts.  Where the JAX test checks a learned model, the port's model file
is also held to the one the JAX package's program writes from the same
files (model nnz within 1% or 2 entries, the same printed HR where both
predict)."""

import re

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.cli import slim_learn as jlearn
from slim_tpu.cli import slim_predict as jpredict
from slim_tpu.io.readers import write_matrix
from slim_tpu_torch.cli import slim_learn, slim_mselect, slim_predict
from slim_tpu_torch.io.readers import read_matrix

CPU = "-device=cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def data_files(tmp_path, rng):
    trn = random_csr(rng, 40, 25, density=0.3, seed=200)
    tst = random_csr(rng, 40, 25, density=0.08, seed=201)
    trn_f = str(tmp_path / "trn.csr")
    tst_f = str(tmp_path / "tst.csr")
    write_matrix(trn, trn_f, fmt="csr")
    write_matrix(tst, tst_f, fmt="csr")
    return tmp_path, trn_f, tst_f


def _nnz_as_jax(args, path, tmp_path):
    """The port's model file at ``path`` against the JAX program's model
    from the same arguments."""
    ref = str(tmp_path / "jax.model")
    assert jlearn.main(args + [ref]) == 0
    got, want = read_matrix(path, fmt="csr").nnz, \
        read_matrix(ref, fmt="csr").nnz
    assert abs(got - want) <= max(2, 0.01 * want)


def _hr(out):
    return float(re.search(r"hr:\s*([0-9.]+)", out).group(1))


def test_learn_then_predict_cli(data_files, capsys):
    tmp_path, trn_f, tst_f = data_files
    mdl_f = str(tmp_path / "m.model")
    rc = slim_learn.main([CPU, "-l1r=0.5", "-l2r=0.5", trn_f, mdl_f])
    assert rc == 0
    model = read_matrix(mdl_f, fmt="csr")
    assert model.nnz > 0

    capsys.readouterr()
    rc = slim_predict.main([CPU, mdl_f, trn_f, tst_f])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hr:" in out and "arhr:" in out

    _nnz_as_jax(["-l1r=0.5", "-l2r=0.5", trn_f], mdl_f, tmp_path)
    capsys.readouterr()
    assert jpredict.main([str(tmp_path / "jax.model"), trn_f, tst_f]) == 0
    assert abs(_hr(out) - _hr(capsys.readouterr().out)) < 0.015


def test_predict_cli_negfile(data_files, rng, capsys):
    tmp_path, trn_f, tst_f = data_files
    mdl_f = str(tmp_path / "m.model")
    slim_learn.main([CPU, "-l1r=0.3", "-l2r=0.5", trn_f, mdl_f])

    neg = random_csr(rng, 40, 25, density=0.25, seed=202)
    neg_f = str(tmp_path / "neg.csr")
    write_matrix(neg, neg_f, fmt="csr")
    out_f = str(tmp_path / "recs.txt")
    rc = slim_predict.main([CPU, "-nrcmds=5", f"-outfile={out_f}",
                            mdl_f, trn_f, tst_f, neg_f])
    assert rc == 0
    lines = open(out_f).read().splitlines()
    assert len(lines) == 40
    out = capsys.readouterr().out
    assert "hr:" in out


def test_mselect_cli(data_files, tmp_path, capsys, monkeypatch):
    _, trn_f, tst_f = data_files
    l12 = str(tmp_path / "l12file")
    with open(l12, "w") as fh:
        fh.write("0.2 0.5\n1.0 1.0\n")
    monkeypatch.chdir(tmp_path)
    rc = slim_mselect.main([CPU, trn_f, tst_f, l12])
    assert rc == 0
    out = capsys.readouterr().out
    assert "The selected hyperparameters" in out
    assert (tmp_path / "0.2 0.5.model").exists()
    assert (tmp_path / "1.0 1.0.model").exists()


def test_learn_cli_binarize_and_warmstart(data_files, capsys):
    tmp_path, trn_f, _ = data_files
    m1 = str(tmp_path / "m1.model")
    rc = slim_learn.main([CPU, "-binarize", "-l1r=0.5", "-l2r=0.5", trn_f,
                          m1])
    assert rc == 0
    m2 = str(tmp_path / "m2.model")
    rc = slim_learn.main([CPU, "-l1r=0.6", "-l2r=0.5", f"-ipmdlfile={m1}",
                          trn_f, m2])
    assert rc == 0


def test_learn_cli_admm(data_files):
    tmp_path, trn_f, _ = data_files
    mdl_f = str(tmp_path / "admm.model")
    rc = slim_learn.main([CPU, "-algo=admm", "-l1r=1.0", "-l2r=1.0", trn_f,
                          mdl_f])
    assert rc == 0
    model = read_matrix(mdl_f, fmt="csr")
    assert model.nnz > 0
    _nnz_as_jax(["-algo=admm", "-l1r=1.0", "-l2r=1.0", trn_f], mdl_f,
                tmp_path)


def test_learn_cli_fslim(data_files):
    tmp_path, trn_f, _ = data_files
    mdl_f = str(tmp_path / "fslim.model")
    rc = slim_learn.main([CPU, "-nnbrs=3", "-simtype=jac", "-l1r=0.2",
                          "-l2r=0.5", trn_f, mdl_f])
    assert rc == 0
    model = read_matrix(mdl_f, fmt="csr")
    W = model.to_scipy().toarray()
    assert (W > 0).sum(axis=0).max() <= 3
    _nnz_as_jax(["-nnbrs=3", "-simtype=jac", "-l1r=0.2", "-l2r=0.5",
                 trn_f], mdl_f, tmp_path)


def test_learn_cli_distributed(data_files):
    """-dist=blockwise launched plainly: the port's one-rank world."""
    tmp_path, trn_f, _ = data_files
    m_solo = str(tmp_path / "solo.model")
    m_dist = str(tmp_path / "dist.model")
    rc = slim_learn.main([CPU, "-l1r=0.5", "-l2r=0.5", trn_f, m_solo])
    assert rc == 0
    rc = slim_learn.main([CPU, "-l1r=0.5", "-l2r=0.5", "-dist=blockwise",
                          trn_f, m_dist])
    assert rc == 0
    a = read_matrix(m_solo, fmt="csr")
    b = read_matrix(m_dist, fmt="csr")
    assert abs(a.nnz - b.nnz) <= max(2, 0.01 * a.nnz)
    np.testing.assert_array_equal(a.shape, b.shape)
