"""Model selection: warm-started sweeps over (l1r, l2r) (port of
slim_tpu/mselect.py, single device).

* :func:`mselect_pairs` walks an explicit pair list, the CLI behaviour
  (src/programs/slim_mselect.c:99-203);
* :func:`mselect_grid` walks the nl1 x nl2 cross product, l2 inner, the
  Python package's behaviour (pyapi.c:214-412).

The Gram is computed once and shared by every point.  Each point's learn
warm-starts from the previous point's model; the solver keeps that model
on the device as a pack, which serves the point's evaluation and then the
next point's warm start (only its dense form is dropped in between).
"""

from __future__ import annotations

import logging
import time

from .config import SlimConfig
from .eval import determine_head_tail, evaluate_topn
from .ops.gram import compute_gram
from .predict import SPARSE_PREDICT_THRESHOLD, predict_topn
from .solvers.cd import bucket_npad, estimate_model_cd
from .types import CSR
from .utils import resolve_device

logger = logging.getLogger("slim_tpu_torch")


def _best():
    return {"bestl1HR": 0.0, "bestl2HR": 0.0, "bestHRHR": 0.0, "bestARHR": 0.0,
            "bestl1AR": 0.0, "bestl2AR": 0.0, "bestHRAR": 0.0, "bestARAR": 0.0,
            "best_model_hr": None, "best_model_ar": None}


def mselect_core(train: CSR, test: CSR, cfg: SlimConfig, points,
                 keep_models: bool = False, point_callback=None, mesh=None,
                 device=None):
    """Walk ``points`` = [(l1, l2), ...] with warm starts on ``device``;
    returns the per-point records plus the best-by-HR / best-by-ARHR
    summaries.  Each record carries the JAX package's keys and the
    solver's ``loss``, ``niters`` and ``sweeps``.
    ``point_callback(rec, model)`` runs after each evaluation, as in the
    JAX package; its ``rec`` is a copy of the point's record with
    ``rec["pack"]``, the retained
    :class:`~slim_tpu_torch.predict.DeviceModelPack` or None."""
    if mesh is not None:
        raise NotImplementedError("mesh-distributed mselect is not ported "
                                  "yet (ROADMAP Queue 1: parallel/)")
    if cfg.algo != "cd":
        raise NotImplementedError(f"mselect with algo {cfg.algo!r} is not "
                                  "ported yet")
    dev = resolve_device(device)
    train = train.infer_ncols()
    test = test.infer_ncols()
    # align column spaces (slim_mselect.c:52-54, pyapi.c:256-258)
    ncols = max(train.ncols, test.ncols)
    train = train.with_ncols(ncols)
    test = test.with_ncols(ncols)
    fmarker = determine_head_tail(train, ncols)
    npad = bucket_npad(ncols)
    gram = compute_gram(train, cfg.gram, pad_to=npad, device=dev)
    # the retained pack serves the dense predict route only, so the model
    # stays on the device whenever that route takes the catalogue
    keep_dev = npad <= SPARSE_PREDICT_THRESHOLD

    results = []
    best = _best()
    model = pack = None
    for (l1, l2) in points:
        pcfg = cfg.replace(l1r=float(l1), l2r=float(l2))
        t0 = time.perf_counter()
        model, stats = estimate_model_cd(train, pcfg, imodel=model,
                                         gram=gram,
                                         keep_device_model=keep_dev,
                                         warm_pack=pack, device=dev)
        t_learn = time.perf_counter() - t0
        pack = stats.pop("W_dev", None)
        t0 = time.perf_counter()
        ids, _, counts = predict_topn(model, train, nrcmds=cfg.nrcmds,
                                      W_dev=pack, device=dev)
        t_pred = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = evaluate_topn(ids, counts, test, fmarker,
                           require_test_items=True)
        t_metric = time.perf_counter() - t0
        if pack is not None:
            pack.free_dense()
        rec = {"l1r": float(l1), "l2r": float(l2), "nnz": model.nnz,
               "hr": ev.hr, "hr_head": ev.hr_head, "hr_tail": ev.hr_tail,
               "arhr": ev.arhr, "time": t_learn, "time_kind": "per_point",
               "time_predict": t_pred, "time_metric": t_metric,
               "nvalid": ev.nvalid, "nvalid_head": ev.nvalid_head,
               "nvalid_tail": ev.nvalid_tail, "loss": stats["loss"],
               "niters": stats["niters"], "sweeps": stats["sweeps"]}
        if keep_models:
            rec["model"] = model
        results.append(rec)
        logger.info(
            "l1r: %.2e l2r: %.2e nnz: %7d hr: %.4f hr_head: %.4f "
            "hr_tail: %.4f arhr: %.4f time: %.2f (learn %.2f + predict "
            "%.2f + metrics %.2f)",
            l1, l2, model.nnz, ev.hr, ev.hr_head, ev.hr_tail, ev.arhr,
            t_learn + t_pred + t_metric, t_learn, t_pred, t_metric)
        if point_callback is not None:
            point_callback(dict(rec, pack=pack), model)
        if ev.hr > best["bestHRHR"]:
            best.update(bestHRHR=ev.hr, bestARHR=ev.arhr,
                        bestl1HR=float(l1), bestl2HR=float(l2),
                        best_model_hr=model)
        if ev.arhr > best["bestARAR"]:
            best.update(bestHRAR=ev.hr, bestARAR=ev.arhr,
                        bestl1AR=float(l1), bestl2AR=float(l2),
                        best_model_ar=model)
    best["results"] = results
    return best


def mselect_pairs(train: CSR, test: CSR, cfg: SlimConfig, pairs,
                  point_callback=None, mesh=None, device=None):
    """CLI-style sweep over an explicit pair list (slim_mselect.c:99-203)."""
    return mselect_core(train, test, cfg, pairs,
                        point_callback=point_callback, mesh=mesh,
                        device=device)


def mselect_grid(train: CSR, test: CSR, cfg: SlimConfig, arrayl1, arrayl2,
                 parallel: bool = False, mesh=None, device=None):
    """Python-package-style cross product (pyapi.c:286-399): the inner
    loop walks l2 for each l1, warm-starting from the previous model."""
    if parallel:
        raise NotImplementedError("mselect_grid(parallel=True) needs the "
                                  "packed grid solve, not ported yet "
                                  "(ROADMAP Queue 1: grid CD)")
    points = [(l1, l2) for l1 in arrayl1 for l2 in arrayl2]
    return mselect_core(train, test, cfg, points, mesh=mesh, device=device)
