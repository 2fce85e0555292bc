"""Model selection and the slim_mselect / slim_learn --ipmdlfile CLIs of the
port, held against the JAX package on the vendored synth set."""

import os
import re

import numpy as np
import pytest
import torch

from slim_tpu.cli import slim_learn as jax_learn_cli
from slim_tpu.cli import slim_mselect as jax_mselect_cli
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.io.readers import read_matrix as jax_read
from slim_tpu.mselect import mselect_pairs as jax_mselect_pairs
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.cli import slim_learn, slim_mselect
from slim_tpu_torch.io.readers import read_matrix
from slim_tpu_torch.mselect import mselect_grid, mselect_pairs
from slim_tpu_torch.predict import densify_model

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TRN = os.path.join(DATA, "synth-train.csr")
TST = os.path.join(DATA, "synth-test.csr")
PAIRS = [(0.1, 0.5), (5.0, 0.5)]         # tests/test_mselect.py:18


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mselect_pairs_matches_jax():
    """Per point nnz ±1%, HR ±0.015, ARHR ±0.010; the same best pairs; each
    point's retained pack densifies to its model."""
    checked = []

    def cb(rec, model):
        pack = rec["pack"]
        ref = densify_model(model, npad=pack.npad, device="cpu")
        checked.append(float((pack.densify() - ref).abs().max()))
        pack.free_dense()

    got = mselect_pairs(read_matrix(TRN), read_matrix(TST), SlimConfig(),
                        PAIRS, point_callback=cb, device="cpu")
    want = jax_mselect_pairs(jax_read(TRN), jax_read(TST), JaxConfig(), PAIRS)
    assert checked == [0.0, 0.0]
    for g, w in zip(got["results"], want["results"]):
        assert (g["l1r"], g["l2r"]) == (w["l1r"], w["l2r"])
        assert abs(g["nnz"] - w["nnz"]) <= 0.01 * w["nnz"]
        assert abs(g["hr"] - w["hr"]) <= 0.015
        assert abs(g["arhr"] - w["arhr"]) <= 0.010
        assert g["niters"] > 0 and g["loss"] > 0
    for key in ("bestl1HR", "bestl2HR", "bestl1AR", "bestl2AR"):
        assert got[key] == want[key]


def test_point_callback_takes_the_jax_arity():
    """The callback the JAX package calls, ``cb(rec, model)``, runs in the
    port; its record carries the retained pack, the returned records do
    not; --ordered (mtype oslim) walks as slim."""
    seen = []

    def cb(rec, model):
        seen.append((rec["l1r"], rec["nnz"] == model.nnz, rec["pack"]))

    trn, tst = read_matrix(TRN), read_matrix(TST)
    res = mselect_pairs(trn, tst, SlimConfig(ordered=1), PAIRS,
                        point_callback=cb, device="cpu")
    assert [s[0] for s in seen] == [p[0] for p in PAIRS]
    assert all(s[1] and s[2] is not None for s in seen)
    assert all("pack" not in r for r in res["results"])
    want = jax_mselect_pairs(jax_read(TRN), jax_read(TST), JaxConfig(),
                             PAIRS, point_callback=lambda rec, model: None)
    for g, w in zip(res["results"], want["results"]):
        assert abs(g["nnz"] - w["nnz"]) <= 0.01 * w["nnz"]


def test_mselect_grid_walks_l2_inner_and_rejects_unported_modes():
    trn, tst = read_matrix(TRN), read_matrix(TST)
    res = mselect_grid(trn, tst, SlimConfig(), [1.0, 4.0], [0.5, 2.0],
                       device="cpu")
    assert [(r["l1r"], r["l2r"]) for r in res["results"]] == \
        [(1.0, 0.5), (1.0, 2.0), (4.0, 0.5), (4.0, 2.0)]
    # heavier l1 => sparser model
    assert res["results"][2]["nnz"] < res["results"][0]["nnz"]
    # the packed grid walks the same points; it solves with CD only
    par = mselect_grid(trn, tst, SlimConfig(), [1.0, 4.0], [0.5, 2.0],
                       parallel=True, device="cpu")
    assert [(r["l1r"], r["l2r"]) for r in par["results"]] == \
        [(r["l1r"], r["l2r"]) for r in res["results"]]
    with pytest.raises(ValueError, match="CD"):
        mselect_grid(trn, tst, SlimConfig(algo="admm"), [1.0], [1.0],
                     parallel=True, device="cpu")
    # a mesh walk solves with CD only (tests/test_torch_dist.py runs it)
    with pytest.raises(ValueError, match="algo='cd'"):
        mselect_pairs(trn, tst, SlimConfig(algo="admm"), PAIRS, mesh=object())


def _selected(out):
    return re.search(r"selected hyperparameters are l1r: (\S+) l2r: (\S+)",
                     out).groups()


def test_mselect_cli_selects_the_jax_pair(tmp_path, capsys, monkeypatch):
    l12 = os.path.join(DATA, "l12file")
    monkeypatch.chdir(tmp_path)          # per-point models land in cwd
    assert jax_mselect_cli.main([TRN, TST, l12]) == 0
    want = _selected(capsys.readouterr().out)
    for f in tmp_path.iterdir():
        f.unlink()
    assert slim_mselect.main(["-device=cpu", TRN, TST, l12]) == 0
    assert _selected(capsys.readouterr().out) == want
    for line in open(l12).read().splitlines():
        l1, l2 = map(float, line.split())
        assert (tmp_path / f"{l1} {l2}.model").exists()


def _learned(out):
    nnz, loss = re.search(r"model nnz: (\d+)\s+loss: (\S+)", out).groups()
    return int(nnz), float(loss)


def test_learn_cli_warm_starts_from_a_model_file(tmp_path, capsys):
    """-ipmdlfile warm-starts from a written model: at the same (l1, l2) the
    warm learn lands on the cold optimum; at a new point it matches the JAX
    CLI's warm learn (loss rtol 1e-4, nnz ±1%)."""
    m1, m2, m3 = (str(tmp_path / f"m{i}.model") for i in (1, 2, 3))
    assert slim_learn.main(["-device=cpu", "-l1r=0.5", "-l2r=0.5", TRN,
                            m1]) == 0
    cold = _learned(capsys.readouterr().out)
    assert slim_learn.main(["-device=cpu", "-l1r=0.5", "-l2r=0.5",
                            f"-ipmdlfile={m1}", TRN, m2]) == 0
    warm = _learned(capsys.readouterr().out)
    np.testing.assert_allclose(warm[1], cold[1], rtol=1e-4)
    assert abs(warm[0] - cold[0]) <= 0.01 * cold[0]
    assert slim_learn.main(["-device=cpu", "-l1r=0.8", "-l2r=0.5",
                            f"-ipmdlfile={m1}", TRN, m3]) == 0
    got = _learned(capsys.readouterr().out)
    assert jax_learn_cli.main(["-l1r=0.8", "-l2r=0.5", f"-ipmdlfile={m1}",
                               TRN, str(tmp_path / "j.model")]) == 0
    want = _learned(capsys.readouterr().out)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert abs(got[0] - want[0]) <= 0.01 * want[0]
