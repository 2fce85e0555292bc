"""slim_tpu_torch user guide: an executable walkthrough of every public API
of the PyTorch / CUDA port, section by section as docs/userguide.py walks
the JAX package's: the four ingestion paths, train, predict and 1-vs-k
predict, save / load and the scipy export, model selection (walked and
packed), FSLIM, ADMM, the functional API with evaluation, the port's
knobs and serving patterns, and the distributed learns.

Run:
    python docs/userguide_torch.py --device cpu   # the guide's data, CPU
    python docs/userguide_torch.py --shape ml1m   # MovieLens-1M's shape,
                                                  # on the card

``main(device=None, shape="guide", workdir=None)`` returns a record of
every section's results (objectives, nnz, top-N arrays, model-selection
records and best pairs, HR / ARHR), and each section's wall seconds and
kernel launches under ``"sections"``.  With no device it runs on the card
and raises when there is none.  ``shape="guide"`` draws the JAX guide's
data (120 users x 60 items from ``default_rng(0)``, the same draws in the
same order); ``shape="ml1m"`` runs on ``datagen.synth_implicit(6040, 3706,
1000209, seed=0)`` with a held-out draw (seed 1) as the test set.  Model
files go to ``workdir`` (default: a fresh temporary directory).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

if __name__ == "__main__":     # run from a checkout: the package beside
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from slim_tpu_torch import (SLIM, CSR, SLIMatrix, SlimConfig,  # noqa: E402
                            determine_head_tail, evaluate_topn, learn,
                            mselect_grid, predict_topn)
from slim_tpu_torch.utils import resolve_device  # noqa: E402

ML1M_SHAPE = (6040, 3706, 1_000_209)
L1S, L2S = [0.1, 1.0], [0.5, 2.0]


def guide_data(shape: str = "guide"):
    """(train, test) scipy CSR matrices, the train matrix's (user, item,
    rating) triplets and the 1-vs-k candidates {user: 8 items}."""
    rng = np.random.default_rng(0)
    if shape == "guide":
        nusers, nitems = 120, 60
        dense = (rng.random((nusers, nitems)) < 0.15) * \
            rng.integers(1, 6, (nusers, nitems))
        train = sp.csr_matrix(dense.astype(np.float32))
    elif shape == "ml1m":
        from slim_tpu_torch.datagen import synth_implicit

        train = synth_implicit(*ML1M_SHAPE, seed=0).to_scipy()
        nusers, nitems = train.shape
    else:
        raise ValueError(f"unknown shape {shape!r}")
    coo = train.tocoo()
    triplets = np.stack([coo.row, coo.col, coo.data], axis=1).astype(np.int64)
    negitems = {u: rng.choice(nitems, size=8, replace=False).tolist()
                for u in range(nusers)}
    if shape == "guide":
        test = sp.csr_matrix(((rng.random((nusers, nitems)) < 0.03)
                              * 1.0).astype(np.float32))
    else:
        test = synth_implicit(nusers, nitems, nusers, seed=1).to_scipy()
    return train, test, triplets, negitems


@contextlib.contextmanager
def _section(rec: dict, name: str, dev):
    """Time a section to its end on the device and count the kernel
    launches it made (``ops.kernel_wrappers``' counters)."""
    from slim_tpu_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.setdefault("sections", {})[name] = dict(
        seconds=time.perf_counter() - t0,
        launches={k: w.launches - before[k] for k, w in wrappers.items()})
    print(f"section {name}: {rec['sections'][name]['seconds']:.2f}s",
          flush=True)


def _label_space(m: SLIMatrix, shape):
    """``m``'s matrix with its users and items back at their labels."""
    coo = m.mat.to_scipy().tocoo()
    return sp.csr_matrix(
        (coo.data, (np.asarray(m.id2user)[coo.row].astype(np.int64),
                    np.asarray(m.id2item)[coo.col].astype(np.int64))),
        shape=shape)


def _stacked(lists, nusers):
    """{user: array} of SLIM.predict as one (nusers, k) array."""
    return np.stack([np.asarray(lists[u]) for u in range(nusers)])


def _points(res):
    return [{k: r[k] for k in ("l1r", "l2r", "nnz", "loss", "hr", "arhr")}
            for r in res["results"]]


def _best(res):
    return (res["bestl1HR"], res["bestl2HR"], res["bestl1AR"],
            res["bestl2AR"])


def _world(train: CSR, test: CSR, device):
    """Section 9's rank function (module-level, so it pickles): every rank
    runs it on its own slice of the work and returns the same results."""
    from slim_tpu_torch import mselect_pairs, predict
    from slim_tpu_torch.ops import kernel_wrappers
    from slim_tpu_torch.parallel import (distributed_learn,
                                         distributed_learn_blockwise,
                                         distributed_learn_sharded_g,
                                         make_mesh, sharded_predict)
    from slim_tpu_torch.parallel.launch import plain

    mesh = make_mesh(device=device)
    # distributed_learn: the rating matrix row-sharded over the ranks, the
    # Gram all-reduced, the column blocks shared out; the model matches
    # the single-device solver's
    cfg = SlimConfig(l1r=1.0, l2r=1.0)
    dmodel, dstats = distributed_learn(train, cfg, mesh)
    # blockwise: G is never materialised -- for catalogues too large for
    # an (n, n) Gram
    bmodel, bstats = distributed_learn_blockwise(
        train, cfg.replace(block_size=128), mesh)
    # sharded G: computed once, column-sharded over the ranks
    gmodel, gstats = distributed_learn_sharded_g(
        train, cfg.replace(block_size=64), mesh)
    # users sharded over the ranks, the model replicated
    dids, dsc, dcnt = sharded_predict(dmodel, train, mesh, nrcmds=10)
    # distributed model selection: one all-reduced Gram for the sweep,
    # the solves shared out, warm starts kept; rank 0 scores each point
    # on its device and broadcasts the result
    predict.last_route = None
    sweep = mselect_pairs(train, test, SlimConfig(optTol=1e-7, nrcmds=5),
                          [(0.5, 0.5), (1.0, 0.5)], mesh=mesh)
    out = {name: dict(loss=st["loss"], nnz=st["nnz"], model=m)
           for name, (m, st) in (("replicated", (dmodel, dstats)),
                                 ("blockwise", (bmodel, bstats)),
                                 ("sharded_g", (gmodel, gstats)))}
    out.update(predict=(dids, dsc, dcnt), mselect_points=_points(sweep),
               mselect_best=_best(sweep), mselect_route=predict.last_route,
               launches={k: w.launches
                         for k, w in kernel_wrappers().items()})
    return plain(out)


def main(device=None, shape: str = "guide", workdir=None) -> dict:
    """Every section on ``device`` (default: the card) at ``shape``;
    returns the record (see the module docstring)."""
    dev = resolve_device(device)
    rec = {"shape": shape, "device": str(dev)}
    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="slim_guide_"))
        _walk(rec, dev, shape, tmp)
    return rec


def _walk(rec, dev, shape, tmp):
    train_sp, test_sp, triplets, negitems = guide_data(shape)
    nusers, nitems = train_sp.shape

    # ----------------------------------------------------------------- #
    # 1. Ingestion: four equivalent ways to build a SLIMatrix
    # ----------------------------------------------------------------- #
    with _section(rec, "1_ingestion", dev):
        m_scipy = SLIMatrix(train_sp)                 # (a) scipy CSR
        m_tri = SLIMatrix(triplets)                   # (b) triplets
        try:                                          # (c) DataFrame
            import pandas as pd

            m_df = SLIMatrix(pd.DataFrame(triplets, columns=["u", "i", "r"]))
        except ImportError:
            m_df = None
        m_csr = SLIMatrix(CSR.from_scipy(train_sp))   # (d) the port's CSR
        rec["ingestion"] = {
            name: None if m is None else dict(
                nnz=m.mat.nnz,
                same=(_label_space(m, train_sp.shape) != train_sp).nnz == 0)
            for name, m in (("scipy", m_scipy), ("triplets", m_tri),
                            ("dataframe", m_df), ("csr", m_csr))}
        print("ingestion:", rec["ingestion"])

    # ----------------------------------------------------------------- #
    # 2. Train (dict params use the reference's knob names)
    # ----------------------------------------------------------------- #
    with _section(rec, "2_train", dev):
        model = SLIM()
        model.train({"l1r": 0.5, "l2r": 1.0, "optTol": 1e-7, "niters": 1000},
                    m_scipy, device=dev)
        rec["train"] = dict(loss=model.stats["loss"], nnz=model.model.nnz,
                            model=model.model)
        print("train:", rec["train"])

    # ----------------------------------------------------------------- #
    # 3. Predict top-N (history items are never recommended)
    # ----------------------------------------------------------------- #
    with _section(rec, "3_predict", dev):
        topn, topsc = model.predict(m_scipy, nrcmds=5, returnscores=True,
                                    device=dev)
        print("user 0 recommendations:", topn[0])
        # 1-vs-k: score only a supplied candidate list per user
        top1vsk, sc1vsk = model.predict(m_scipy, nrcmds=5, negitems=negitems,
                                        nnegs=8, returnscores=True,
                                        device=dev)
        rec["predict"] = dict(ids=_stacked(topn, nusers),
                              scores=_stacked(topsc, nusers),
                              ids_1vsk=_stacked(top1vsk, nusers),
                              scores_1vsk=_stacked(sc1vsk, nusers))

    # ----------------------------------------------------------------- #
    # 4. Save / load round trip (+ the item-map sidecar), scipy export
    # ----------------------------------------------------------------- #
    with _section(rec, "4_save_load", dev):
        from slim_tpu_torch import predict as P

        mfile = os.path.join(tmp, "slim_demo.model")
        mapfile = os.path.join(tmp, "slim_demo.map")
        model.save_model(mfile, mapfile)
        m2 = SLIM()
        m2.load_model(mfile, mapfile)
        W, item_map = m2.to_csr(returnmap=True)
        print("model:", W.shape, "nnz", W.nnz)
        again, again_sc = m2.predict(m_scipy, nrcmds=5, returnscores=True,
                                     device=dev)
        rec["save_load"] = dict(nnz=W.nnz, shape=W.shape,
                                items=len(item_map),
                                ids=_stacked(again, nusers),
                                scores=_stacked(again_sc, nusers),
                                route=P.last_route)

    # ----------------------------------------------------------------- #
    # 5. Model selection: a warm-started walk sharing one Gram, then the
    #    packed grid (every point in one pass)
    # ----------------------------------------------------------------- #
    with _section(rec, "5_mselect", dev):
        m_test = SLIMatrix(test_sp)
        res = model.mselect({"optTol": 1e-7}, m_scipy, m_test,
                            arrayl1=L1S, arrayl2=L2S, nrcmds=5, device=dev)
        print("best HR point:", res["bestl1HR"], res["bestl2HR"],
              res["bestHRHR"])
        train_csr = CSR.from_scipy(train_sp)
        test_csr = CSR.from_scipy(test_sp)
        grid = mselect_grid(train_csr, test_csr,
                            SlimConfig.from_dict({"optTol": 1e-7}, nrcmds=5),
                            L1S, L2S, parallel=True, device=dev)
        rec["mselect"] = dict(points=_points(res), best=_best(res),
                              grid_points=_points(grid),
                              grid_best=_best(grid),
                              grid_time=grid["grid_time"])

    # ----------------------------------------------------------------- #
    # 6. FSLIM (neighbour-restricted) and ADMM variants
    # ----------------------------------------------------------------- #
    with _section(rec, "6_fslim_admm", dev):
        fslim = SLIM()
        fslim.train({"l1r": 0.5, "l2r": 1.0, "nnbrs": 10, "simtype": "cos"},
                    m_scipy, device=dev)
        admm = SLIM()
        admm.train({"l1r": 1.0, "l2r": 1.0, "algo": "admm"}, m_scipy,
                   device=dev)
        rec["fslim"] = dict(loss=fslim.stats["loss"], nnz=fslim.model.nnz)
        rec["admm"] = dict(loss=admm.stats["loss"], nnz=admm.model.nnz)
        print("fslim:", rec["fslim"], "admm:", rec["admm"])

    # ----------------------------------------------------------------- #
    # 7. Functional API + explicit evaluation
    # ----------------------------------------------------------------- #
    with _section(rec, "7_functional", dev):
        mdl, stats = learn(train_csr, SlimConfig(l1r=0.5, l2r=1.0),
                           device=dev)
        ids, scores, counts = predict_topn(mdl, train_csr, nrcmds=10,
                                           device=dev)
        fmarker = determine_head_tail(train_csr)
        ev = evaluate_topn(ids, counts, test_csr, fmarker)
        print(ev)
        print("objective:", stats["loss"])
        rec["functional"] = dict(loss=stats["loss"], nnz=mdl.nnz, hr=ev.hr,
                                 arhr=ev.arhr, ids=ids)

    # ----------------------------------------------------------------- #
    # 8. The port's knobs (all optional) and serving
    # ----------------------------------------------------------------- #
    with _section(rec, "8_knobs_serving", dev):
        _knobs_and_serving(rec, dev, train_csr, tmp)

    # ----------------------------------------------------------------- #
    # 9. Distributed: one process per device (torch.distributed)
    # ----------------------------------------------------------------- #
    with _section(rec, "9_distributed", dev):
        from slim_tpu_torch.parallel.launch import plain, run_world

        # A 2-rank gloo world on this device (gloo lets two ranks share
        # one card; NCCL between cards, one rank each, is the default
        # there).  On several hosts, or under
        #   torchrun --nproc-per-node N your_script.py
        # each process calls slim_tpu_torch.parallel.init_distributed()
        # (or make_mesh(), which calls it) and then the same functions.
        ranks = run_world(_world, 2, args=(plain(train_csr),
                                           plain(test_csr), str(dev)),
                          device=dev, backend="gloo")
        rec["distributed"] = ranks
        print("distributed:", {k: ranks[0][k]["loss"] for k in
                               ("replicated", "blockwise", "sharded_g")})


def _knobs_and_serving(rec, dev, train_csr, tmp):
    from slim_tpu_torch import native
    from slim_tpu_torch import predict as P
    from slim_tpu_torch.predict import densify_model, sparsify_model_device

    # gram:               "auto" (on the device when the solve runs there)
    #                     | "device" (densify kernel + contraction) | "host"
    # block_size:         item columns solved per device batch
    # compact_threshold:  width up to which a block solves on the card's
    #                     whole-array sweep; a wider catalogue solves each
    #                     block in its union's compacted space, on the
    #                     wide-block sweep where the union is wider too
    # checkpoint_dir:     per-block solve files, resumed from by a later
    #                     learn of the same matrix and config
    # profile_dir:        a torch.profiler Chrome trace of the learn
    # kernel= is accepted and ignored (a JAX-package config round-trips).
    cfg = SlimConfig(l1r=0.5, l2r=1.0)
    mdl2, st2 = learn(train_csr, cfg.replace(gram="device"),
                      keep_device_model=True, device=dev)
    ck = os.path.join(tmp, "ckpt")
    knob = cfg.replace(block_size=256, compact_threshold=4096,
                       checkpoint_dir=ck)
    _, first = learn(train_csr, knob, device=dev)
    _, resumed = learn(train_csr, knob, device=dev)      # from the files
    prof = os.path.join(tmp, "prof")
    learn(train_csr, cfg.replace(profile_dir=prof), device=dev)
    rec["knobs"] = dict(gram_device_loss=st2["loss"], nnz=mdl2.nnz,
                        checkpoint_loss=first["loss"],
                        resumed_loss=resumed["loss"],
                        resumed_phases=sorted(resumed["phases"]),
                        traces=len(glob.glob(os.path.join(prof, "*.json"))))

    # Serving (one model, many request batches): keep the model on the
    # device and pass it back as W_dev.  Three forms: the learn's device
    # pack (keep_device_model=True), a dense W (densify_model), and the
    # padded sparse rows (sparsify_model_device, which routes sparse).
    # At "high" or "default" (a catalogue above npad 8,192 by default) a
    # dense W, or a pack's, keeps its bfloat16 halves on the device while
    # it lives unchanged (as much memory again as W at "high"), so later
    # calls do not split it again; dropping W (or pack.free_dense())
    # frees them.  A write to W that bypasses its version counter (.data,
    # DLPack) is not seen.
    serve = {}
    for name, W in (("pack", st2["W_dev"]),
                    ("dense", densify_model(mdl2, device=dev)),
                    ("sparse_rows", sparsify_model_device(mdl2,
                                                          device=dev))):
        serve[name] = predict_topn(mdl2, train_csr, nrcmds=10, W_dev=W)
        serve[name + "_route"] = P.last_route
    # Large catalogues (npad > 36,864) score sparse by themselves; pin
    # either route with sparse=True / False.
    serve["sparse"] = predict_topn(mdl2, train_csr, nrcmds=10, sparse=True,
                                   device=dev)
    serve["sparse_route"] = P.last_route

    # The native host route (small catalogues; the same scores).  An
    # unpinned predict_topn (no W_dev / sparse / scan) whose work the host
    # loop does faster than one device call takes it by itself
    # (SLIM_PREDICT_NATIVE_NPAD=0 turns it off); predict.last_route says
    # which route served.
    if native.available():
        serve["native"] = native.predict_topn(mdl2, train_csr, nrcmds=10)
    few = CSR.from_scipy(train_csr.to_scipy()[:16])
    serve["unpinned_few"] = predict_topn(mdl2, few, nrcmds=10, device=dev)
    serve["unpinned_few_route"] = P.last_route
    print("unpinned call on 16 users served by the", P.last_route, "route")
    rec["serving"] = serve


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the card)")
    ap.add_argument("--shape", choices=["guide", "ml1m"], default="guide")
    args = ap.parse_args()
    out = main(device=args.device, shape=args.shape)
    print(json.dumps(out["sections"]))
