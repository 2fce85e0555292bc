"""docs/userguide_torch.py, the port's walkthrough, at the guide's shape on
the CPU, against the JAX package's public API on JAX-CPU on the same
matrices (rebuilt here from the same ``default_rng(0)`` draws as
docs/userguide.py's).  Tolerances are the goldens': loss rtol 1e-4, nnz
±1%, HR ±0.015, ARHR ±0.010, the same best pairs, ranked ids with 0
mismatches by ``checks.ranked_mismatches``; the distributed section is
held to tests/test_torch_dist.py's (loss 1e-5 rel, W atol 5e-4) against
the port's single-device learn.  chip_smoke.py's recorded guide constants
are held to the JAX package here."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "docs"))

import chip_smoke  # noqa: E402
import userguide_torch as guide  # noqa: E402
from slim_tpu_torch import SlimConfig, learn, mselect_pairs  # noqa: E402
from slim_tpu_torch.checks import ranked_mismatches  # noqa: E402
from slim_tpu_torch.predict import predict_topn  # noqa: E402
from slim_tpu_torch.types import CSR  # noqa: E402

LOSS_RTOL, NNZ_RTOL, HR_TOL, ARHR_TOL = 1e-4, 0.01, 0.015, 0.010
DIST_LOSS_RTOL, DIST_W_ATOL = 1e-5, 5e-4
DEVICE_ROUTES = ("dense", "rows", "coo")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_data():
    """docs/userguide.py's matrices: the same draws in the same order."""
    rng = np.random.default_rng(0)
    nusers, nitems = 120, 60
    dense = (rng.random((nusers, nitems)) < 0.15) * \
        rng.integers(1, 6, (nusers, nitems))
    negitems = {u: rng.choice(nitems, size=8, replace=False).tolist()
                for u in range(nusers)}
    test_dense = (rng.random((nusers, nitems)) < 0.03) * 1.0
    return (sp.csr_matrix(dense.astype(np.float32)),
            sp.csr_matrix(test_dense.astype(np.float32)), negitems)


def _stacked(lists, n):
    return np.stack([np.asarray(lists[u]) for u in range(n)])


@pytest.fixture(scope="module")
def jax_guide():
    """docs/userguide.py's sections 2 and 5-7 through the JAX package,
    recorded as the port's walkthrough records them."""
    from slim_tpu import SLIM, SLIMatrix
    from slim_tpu import SlimConfig as JaxConfig
    from slim_tpu import (determine_head_tail, evaluate_topn, learn,
                          mselect_grid, predict_topn)
    from slim_tpu.types import CSR as JaxCSR

    train, test, negitems = _jax_data()
    m = SLIMatrix(train)
    model = SLIM()
    model.train({"l1r": 0.5, "l2r": 1.0, "optTol": 1e-7, "niters": 1000}, m)
    rec = {"train": dict(loss=model.stats["loss"], nnz=model.model.nnz)}
    res = model.mselect({"optTol": 1e-7}, m, SLIMatrix(test),
                        arrayl1=guide.L1S, arrayl2=guide.L2S, nrcmds=5)
    trn, tst = JaxCSR.from_scipy(train), JaxCSR.from_scipy(test)
    grid = mselect_grid(trn, tst, JaxConfig.from_dict({"optTol": 1e-7},
                                                      nrcmds=5),
                        guide.L1S, guide.L2S, parallel=True)
    rec["mselect"] = dict(points=res["results"], best=guide._best(res),
                          grid_points=grid["results"],
                          grid_best=guide._best(grid))
    for name, params in (("fslim", {"l1r": 0.5, "l2r": 1.0, "nnbrs": 10,
                                    "simtype": "cos"}),
                         ("admm", {"l1r": 1.0, "l2r": 1.0, "algo": "admm"})):
        s = SLIM()
        s.train(params, m)
        rec[name] = dict(loss=s.stats["loss"], nnz=s.model.nnz)
    mdl, stats = learn(trn, JaxConfig(l1r=0.5, l2r=1.0))
    ids, _, counts = predict_topn(mdl, trn, nrcmds=10)
    ev = evaluate_topn(ids, counts, tst, determine_head_tail(trn))
    rec["functional"] = dict(loss=stats["loss"], nnz=mdl.nnz, hr=ev.hr,
                             arhr=ev.arhr)
    # section 9's config on one device (the distributed learns match it)
    mdl, stats = learn(trn, JaxConfig(l1r=1.0, l2r=1.0))
    rec["dist"] = dict(loss=stats["loss"], nnz=mdl.nnz)
    return rec


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    return guide.main(device="cpu", shape="guide",
                      workdir=str(tmp_path_factory.mktemp("guide")))


def _fit(got, want):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert abs(got["nnz"] - want["nnz"]) <= NNZ_RTOL * want["nnz"]


def _points(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["l1r"], g["l2r"]) == (w["l1r"], w["l2r"])
        assert abs(g["nnz"] - w["nnz"]) <= NNZ_RTOL * w["nnz"]
        assert abs(g["hr"] - w["hr"]) <= HR_TOL
        assert abs(g["arhr"] - w["arhr"]) <= ARHR_TOL


def test_data_are_the_jax_guides():
    train, test, triplets, negitems = guide.guide_data("guide")
    jtrain, jtest, jneg = _jax_data()
    assert (train != jtrain).nnz == 0 and (test != jtest).nnz == 0
    assert negitems == jneg
    assert triplets.shape == (train.nnz, 3)


def test_ingestion_paths_give_one_matrix(walk):
    """Section 1: scipy, triplets, DataFrame (None without pandas) and CSR
    each give the train matrix, with users and items at their labels."""
    for name, r in walk["ingestion"].items():
        if r is None:
            assert name == "dataframe"
            continue
        assert r["same"] and r["nnz"] == walk["ingestion"]["scipy"]["nnz"]


SECTIONS = ["train", "predict", "predict_1vsk", "mselect", "grid", "fslim",
            "admm", "functional"]


@pytest.mark.parametrize("section", SECTIONS)
def test_section_matches_jax(walk, jax_guide, section):
    """Sections 2, 3, 5, 6 and 7 against the JAX package's on the same
    matrices."""
    if section in ("train", "fslim", "admm"):
        _fit(walk[section], jax_guide[section])
    elif section in ("predict", "predict_1vsk"):
        # the JAX class serving the walkthrough's section-2 model: the
        # two solves' models differ within optTol (their sweeps shuffle
        # differently), so each predict is held to the other on one model
        from slim_tpu import SLIM as JaxSLIM, SLIMatrix as JaxSLIMatrix
        from slim_tpu.types import CSR as JaxCSR

        train, _, negitems = _jax_data()
        mdl = walk["train"]["model"]
        jm = JaxSLIM()
        jm.model = JaxCSR.from_arrays(mdl.nrows, mdl.ncols, mdl.indptr,
                                      mdl.indices, mdl.data)
        jm.nItems, jm.id2item = train.shape[1], np.arange(train.shape[1])
        jm.item2id = {i: i for i in range(train.shape[1])}
        kw = dict(negitems=negitems, nnegs=8) if section == "predict_1vsk" \
            else {}
        ids, sc = jm.predict(JaxSLIMatrix(train), nrcmds=5,
                             returnscores=True, **kw)
        n = train.shape[0]
        sfx = "" if section == "predict" else "_1vsk"
        got = walk["predict"]
        np.testing.assert_allclose(got["scores" + sfx], _stacked(sc, n),
                                   rtol=1e-5, atol=1e-6)
        assert ranked_mismatches(got["ids" + sfx], got["scores" + sfx],
                                 _stacked(ids, n), _stacked(sc, n))[1] == 0
    elif section in ("mselect", "grid"):
        pre = "" if section == "mselect" else "grid_"
        _points(walk["mselect"][pre + "points"],
                jax_guide["mselect"][pre + "points"])
        assert walk["mselect"][pre + "best"] == \
            jax_guide["mselect"][pre + "best"]
    else:
        got, want = walk["functional"], jax_guide["functional"]
        _fit(got, want)
        assert abs(got["hr"] - want["hr"]) <= HR_TOL
        assert abs(got["arhr"] - want["arhr"]) <= ARHR_TOL


def test_save_load_round_trip_keeps_the_lists(walk):
    """Section 4: the loaded model predicts the lists of section 3."""
    got, want = walk["save_load"], walk["predict"]
    assert got["route"] in DEVICE_ROUTES      # conftest: native route off
    assert got["shape"] == (60, 60) and got["items"] == 60
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5)
    assert ranked_mismatches(got["ids"], got["scores"], want["ids"],
                             want["scores"])[1] == 0


def test_walk_and_packed_grid_pick_one_best_pair(walk):
    assert walk["mselect"]["best"] == walk["mselect"]["grid_best"]


def test_knobs_give_the_functional_fit(walk):
    """Section 8: the device Gram, the checkpointed learn and its resume
    from the files give section 7's fit; the profile writes a trace."""
    k, f = walk["knobs"], walk["functional"]
    for key in ("gram_device_loss", "checkpoint_loss", "resumed_loss"):
        assert abs(k[key] - f["loss"]) <= LOSS_RTOL * f["loss"], key
    assert k["resumed_loss"] == k["checkpoint_loss"]
    assert "restore" in k["resumed_phases"]
    assert k["traces"] == 1


@pytest.mark.parametrize("form", ["pack", "dense", "sparse_rows", "sparse",
                                  "native", "unpinned_few"])
def test_serving_forms_agree(walk, form):
    """Section 8's serving forms give section 7's lists (the native loop
    up to the order of equal scores); each device form on its route."""
    from slim_tpu_torch.checks import tie_order_mismatches

    s = walk["serving"]
    ref = s["dense"]
    ids, sc, cnt = s[form]
    n = ids.shape[0]
    np.testing.assert_array_equal(cnt, ref[2][:n])
    np.testing.assert_allclose(sc, ref[1][:n], rtol=1e-5, atol=1e-6)
    if form == "native":
        assert tie_order_mismatches(ids, ref[0], ref[1], ref[2])[1] == 0
    else:
        assert ranked_mismatches(ids, sc, ref[0][:n], ref[1][:n])[1] == 0
        want = {"pack": "dense", "dense": "dense", "sparse_rows": "rows",
                "sparse": "rows", "unpinned_few": "dense"}[form]
        assert s[form + "_route"] == want
    assert ranked_mismatches(ref[0], ref[1], walk["functional"]["ids"],
                             ref[1])[1] == 0


@pytest.fixture(scope="module")
def one_device():
    """The port's single-device learns of section 9's configs."""
    train, _, _, _ = guide.guide_data("guide")
    m = CSR.from_scipy(train)
    cfg = SlimConfig(l1r=1.0, l2r=1.0)
    return m, {name: learn(m, cfg.replace(block_size=bs), device="cpu")
               for name, bs in (("replicated", 512), ("blockwise", 128),
                                ("sharded_g", 64))}


@pytest.mark.parametrize("mode", ["replicated", "blockwise", "sharded_g"])
def test_distributed_learn_matches_one_device(walk, one_device, mode):
    """Section 9: each rank's model within the dist tests' tolerance of
    the single-device learn; every rank the same model."""
    _, ref = one_device
    model, stats = ref[mode]
    ranks = walk["distributed"]
    for r in ranks:
        got = r[mode]
        assert abs(got["loss"] - stats["loss"]) <= \
            DIST_LOSS_RTOL * stats["loss"]
        np.testing.assert_allclose(got["model"].to_dense(),
                                   model.to_dense(), atol=DIST_W_ATOL)
        assert got["model"] == ranks[0][mode]["model"]


def test_distributed_predict_and_mselect(walk, one_device):
    """Section 9: the sharded predict gives the single-device lists; the
    mesh walk scores on rank 0's device route (rank 1 scores nothing)
    and matches the single-device walk."""
    m, ref = one_device
    ranks = walk["distributed"]
    ids, sc, cnt = ranks[0]["predict"]
    rids, rsc, rcnt = predict_topn(ref["replicated"][0], m, nrcmds=10,
                                   device="cpu")
    np.testing.assert_array_equal(cnt, rcnt)
    assert ranked_mismatches(ids, sc, rids, rsc, rcnt)[1] == 0
    assert [r["mselect_route"] for r in ranks] == ["dense", None]
    _, test, _, _ = guide.guide_data("guide")
    want = mselect_pairs(m, CSR.from_scipy(test),
                         SlimConfig(optTol=1e-7, nrcmds=5),
                         [(0.5, 0.5), (1.0, 0.5)], device="cpu")
    for r in ranks:
        _points(r["mselect_points"], guide._points(want))
        assert r["mselect_points"] == ranks[0]["mselect_points"]
        assert tuple(r["mselect_best"]) == guide._best(want)


def test_chip_smoke_guide_constants_match_jax(jax_guide):
    """chip_smoke.py's recorded JAX values at the guide shape are the JAX
    package's (the card's walkthrough is held to them there)."""
    for key, (loss, nnz) in chip_smoke.GUIDE_FITS.items():
        want = jax_guide[key]
        assert abs(loss - want["loss"]) <= 1e-6 * abs(want["loss"]), key
        assert nnz == want["nnz"], key
    f = jax_guide["functional"]
    assert chip_smoke.GUIDE_EVAL == pytest.approx((f["hr"], f["arhr"]),
                                                  abs=1e-6)
    got = [(p["l1r"], p["l2r"], p["nnz"], p["hr"], p["arhr"])
           for p in jax_guide["mselect"]["points"]]
    assert np.allclose(chip_smoke.GUIDE_MSELECT, got, rtol=0, atol=1e-6)
    assert chip_smoke.GUIDE_BEST == jax_guide["mselect"]["best"] == \
        jax_guide["mselect"]["grid_best"]


def test_main_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        guide.main()
