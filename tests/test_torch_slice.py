"""The port's main path end to end on the CPU: learn -> top-N -> eval, by
the API and by the CLIs, against the synth goldens and against the JAX
package's learn."""

import os
import re

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.api import learn as jax_learn
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu_torch import SlimConfig, determine_head_tail, evaluate_topn
from slim_tpu_torch import get_topn, learn, read_model, write_model
from slim_tpu_torch.cli import slim_learn, slim_predict
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.solvers.cd import pick_impl
from slim_tpu_torch.types import CSR

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# tests/test_goldens.py
SYNTH_LOSS, SYNTH_NNZ, SYNTH_HR, SYNTH_ARHR = 4730.0005, 10613, 0.230833, 0.135996


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


def test_learn_meets_synth_goldens():
    trn = read_matrix(os.path.join(DATA, "synth-train.ijv"), "ijv") \
        .infer_ncols()
    tst = read_matrix(os.path.join(DATA, "synth-test.ijv"), "ijv") \
        .infer_ncols()
    model, stats = learn(trn, SlimConfig(l1r=1.0, l2r=1.0), device="cpu")
    np.testing.assert_allclose(stats["loss"], SYNTH_LOSS, rtol=1e-4)
    assert abs(stats["nnz"] - SYNTH_NNZ) <= SYNTH_NNZ * 0.01
    ids, _, counts = get_topn(model, trn, nrcmds=10, device="cpu")
    n = max(trn.ncols, tst.ncols, model.ncols)
    res = evaluate_topn(ids, counts, tst, determine_head_tail(trn, n))
    assert abs(res.hr - SYNTH_HR) < 0.015
    assert abs(res.arhr - SYNTH_ARHR) < 0.010


def test_cli_learn_then_predict_reproduces_goldens(tmp_path, capsys):
    mdl = str(tmp_path / "synth.model")
    assert slim_learn.main(["-ifmt=ijv", "-l1r=1.0", "-l2r=1.0",
                            "-device=cpu",
                            os.path.join(DATA, "synth-train.ijv"), mdl]) == 0
    out = capsys.readouterr().out
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)", out).groups()
    np.testing.assert_allclose(float(loss), SYNTH_LOSS, rtol=1e-4)
    assert abs(int(nnz) - SYNTH_NNZ) <= SYNTH_NNZ * 0.01
    assert slim_predict.main(["-ifmt=ijv", "-device=cpu", mdl,
                              os.path.join(DATA, "synth-train.ijv"),
                              os.path.join(DATA, "synth-test.ijv")]) == 0
    out = capsys.readouterr().out
    hr, arhr = re.search(r"hr: (\S+) hr_head: \S+ hr_tail: \S+ arhr: (\S+)",
                         out).groups()
    assert abs(float(hr) - SYNTH_HR) < 0.015
    assert abs(float(arhr) - SYNTH_ARHR) < 0.010


def test_cli_ordered_learns_as_slim(tmp_path, capsys):
    """--ordered with --nnbrs 0 is mtype oslim, which the reference learns
    as slim (it never reads the flag): the synth goldens; ofslim learns as
    fslim."""
    mdl = str(tmp_path / "o.model")
    assert slim_learn.main(["-ifmt=ijv", "--ordered", "-device=cpu",
                            os.path.join(DATA, "synth-train.ijv"), mdl]) == 0
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)",
                          capsys.readouterr().out).groups()
    np.testing.assert_allclose(float(loss), SYNTH_LOSS, rtol=1e-4)
    assert abs(int(nnz) - SYNTH_NNZ) <= SYNTH_NNZ * 0.01
    # with --nnbrs it is ofslim, which learns as fslim
    mat = _port(random_csr(np.random.default_rng(0), 20, 10))
    m_of, s_of = learn(mat, SlimConfig(nnbrs=5, ordered=1, shuffle=False),
                       device="cpu")
    m_f, s_f = learn(mat, SlimConfig(nnbrs=5, shuffle=False), device="cpu")
    assert m_of == m_f and s_of["loss"] == s_f["loss"]
    assert (m_of.to_dense() > 0).sum(axis=0).max() <= 5


def test_ordered_warm_start_matches_slim():
    """oslim warm-starts from imodel as slim does (the JAX package's
    cd.py:613): the same model from the same warm start."""
    rng = np.random.default_rng(4)
    mat = _port(random_csr(rng, 120, 60, density=0.15))
    base = dict(l1r=0.5, l2r=1.0, block_size=32, shuffle=False)
    m0, _ = learn(mat, SlimConfig(**base), device="cpu")
    warm = dict(base, l1r=0.8)
    m_s, s_s = learn(mat, SlimConfig(**warm), imodel=m0, device="cpu")
    m_o, s_o = learn(mat, SlimConfig(ordered=1, **warm), imodel=m0,
                     device="cpu")
    assert s_o["niters"] == s_s["niters"] and m_o == m_s


@pytest.mark.parametrize("frac,compact", [("1.0", True), ("0", False)])
def test_compact_frac_knob_is_read_at_call_time(monkeypatch, frac, compact):
    """SLIM_COMPACT_FRAC forces (1.0) or forbids (0) the compact blocks of
    a compact-path learn; both reach the full-width objective (rtol 1e-4)
    and nnz (±1%)."""
    import slim_tpu_torch.solvers.cd as C

    rng = np.random.default_rng(9)
    mat = _port(random_csr(rng, 300, 700, density=0.01, implicit=True))
    base = dict(l1r=0.0, l2r=1.0, block_size=64, shuffle=False)
    m_full, s_full = learn(mat, SlimConfig(**base), device="cpu")
    calls = []
    real = C.gather_compact
    monkeypatch.setattr(C, "gather_compact",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("SLIM_COMPACT_FRAC", frac)
    m_cmp, s_cmp = learn(mat, SlimConfig(compact_threshold=256, **base),
                         device="cpu")
    assert bool(calls) == compact
    np.testing.assert_allclose(s_cmp["loss"], s_full["loss"], rtol=1e-4)
    assert abs(m_cmp.nnz - m_full.nnz) <= 0.01 * m_full.nnz


def test_cli_rejects_unported_modes(tmp_path):
    # the distributed learns are CD only (tests/test_torch_dist.py drives
    # --dist); ADMM is refused before any process group starts
    trn = os.path.join(DATA, "synth-train.ijv")
    with pytest.raises(ValueError, match="CD"):
        slim_learn.main(["-ifmt=ijv", "-dist=replicated", "-algo=admm",
                         "-device=cpu", trn])


@pytest.mark.parametrize("implicit", [False, True])
def test_learn_matches_jax_learn(implicit):
    """Port vs JAX learn on one random matrix: loss rtol 1e-4, nnz ±1%
    (the visit orders differ: torch.Generator is not jax.random)."""
    rng = np.random.default_rng(5)
    mat = random_csr(rng, 200, 90, density=0.12, implicit=implicit)
    cfg = JaxConfig(l1r=0.5, l2r=1.0, block_size=32)
    _, sj = jax_learn(mat, cfg)
    _, st = learn(_port(mat), SlimConfig(l1r=0.5, l2r=1.0, block_size=32),
                  device="cpu")
    np.testing.assert_allclose(st["loss"], sj["loss"], rtol=1e-4)
    assert abs(st["nnz"] - sj["nnz"]) <= 0.01 * sj["nnz"]


@pytest.mark.parametrize("l1r", [1.0, 0.0])
def test_compact_path_matches_full_width(l1r):
    """Union-compacted blocks (narrow at l1r=1, snapped to full width at
    l1r=0) solve the same problem as the full-width path."""
    rng = np.random.default_rng(9)
    mat = _port(random_csr(rng, 300, 700, density=0.01, implicit=True))
    base = dict(l1r=l1r, l2r=1.0, block_size=64, shuffle=False)
    m_full, s_full = learn(mat, SlimConfig(**base), device="cpu")
    m_cmp, s_cmp = learn(mat, SlimConfig(compact_threshold=256, **base),
                         device="cpu")
    np.testing.assert_allclose(s_cmp["loss"], s_full["loss"], rtol=1e-4)
    assert abs(m_cmp.nnz - m_full.nnz) <= 0.01 * m_full.nnz
    np.testing.assert_allclose(m_cmp.to_dense(), m_full.to_dense(),
                               atol=2e-3)


def test_model_write_read_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    mat = _port(random_csr(rng, 60, 40, density=0.2))
    model, _ = learn(mat, SlimConfig(block_size=16), device="cpu")
    path = str(tmp_path / "m.bin")
    write_model(model, path)
    assert read_model(path) == model


def test_pick_impl_routes():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert pick_impl(28672, cpu, 4096) == "plain"
    assert pick_impl(384, gpu, 4096) == "sweep"
    assert pick_impl(4096, gpu, 4096) == "sweep"
    assert pick_impl(28672, gpu, 4096) == "sweep_large"
    assert pick_impl(768, gpu, 256) == "sweep"      # not a GROUP multiple
