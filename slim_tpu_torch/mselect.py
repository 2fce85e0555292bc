"""Model selection: sweeps over (l1r, l2r) (port of slim_tpu/mselect.py,
single device).

* :func:`mselect_pairs` walks an explicit pair list, the CLI behaviour
  (src/programs/slim_mselect.c:99-203);
* :func:`mselect_grid` walks the nl1 x nl2 cross product, l2 inner, the
  Python package's behaviour (pyapi.c:214-412), or with ``parallel=True``
  solves every point in one packed pass (``estimate_grid_cd``).

The Gram is computed once and shared by every point.  With CD each
point's learn warm-starts from the previous point's model; the solver
keeps that model on the device as a pack, which serves the point's
evaluation and then the next point's warm start (only its dense form is
dropped in between).  ADMM points solve cold on the shared Gram.

With ``mesh`` (a :func:`slim_tpu_torch.parallel.make_mesh` mesh, every
rank calling) the Gram is all-reduced once from the ranks' row shards and
each point's columns are solved across the ranks
(``parallel.dist.distributed_learn``; the packed grid:
``distributed_grid``), CD only; every rank gets every model, rank 0
evaluates each point on its device (the dense route, or the sparse one
above SPARSE_PREDICT_THRESHOLD; never the native host route) and
broadcasts the result, as the JAX package evaluates once on its
controller, and no model stays on the device as a pack.
"""

from __future__ import annotations

import logging
import time

from .config import SlimConfig
from .eval import determine_head_tail, evaluate_topn
from .ops.gram import compute_gram
from .predict import SPARSE_PREDICT_THRESHOLD, predict_topn
from .solvers.admm import estimate_model_admm
from .solvers.cd import bucket_npad, estimate_grid_cd, estimate_model_cd
from .types import CSR
from .utils import resolve_device

logger = logging.getLogger("slim_tpu_torch")


def _best():
    return {"bestl1HR": 0.0, "bestl2HR": 0.0, "bestHRHR": 0.0, "bestARHR": 0.0,
            "bestl1AR": 0.0, "bestl2AR": 0.0, "bestHRAR": 0.0, "bestARAR": 0.0,
            "best_model_hr": None, "best_model_ar": None}


def _aligned(train: CSR, test: CSR):
    """train and test over one column space (slim_mselect.c:52-54,
    pyapi.c:256-258), and the head/tail marker of its items."""
    train = train.infer_ncols()
    test = test.infer_ncols()
    ncols = max(train.ncols, test.ncols)
    train = train.with_ncols(ncols)
    return train, test.with_ncols(ncols), determine_head_tail(train, ncols)


def _evaluate(model, train, test, fmarker, nrcmds, W_dev, dev, mesh=None):
    """(eval record, predict s, metric s) of one point's model.  With
    ``mesh``, rank 0's on its device route, broadcast to every rank."""
    sparse = None
    if mesh is not None:
        import torch.distributed as dist

        from .parallel import comm

        if dist.get_rank() != 0:
            return comm.broadcast_object(None, dev)
        sparse = bucket_npad(train.ncols) > SPARSE_PREDICT_THRESHOLD
    t0 = time.perf_counter()
    ids, _, counts = predict_topn(model, train, nrcmds=nrcmds, W_dev=W_dev,
                                  sparse=sparse, device=dev)
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = evaluate_topn(ids, counts, test, fmarker, require_test_items=True)
    out = ev, t_pred, time.perf_counter() - t0
    return out if mesh is None else comm.broadcast_object(out, dev)


def _record(l1, l2, model, ev, stats, **times):
    rec = {"l1r": float(l1), "l2r": float(l2), "nnz": model.nnz,
           "hr": ev.hr, "hr_head": ev.hr_head, "hr_tail": ev.hr_tail,
           "arhr": ev.arhr, **times,
           "nvalid": ev.nvalid, "nvalid_head": ev.nvalid_head,
           "nvalid_tail": ev.nvalid_tail}
    rec.update({k: stats[k] for k in ("loss", "niters", "sweeps")
                if k in stats})
    return rec


def _track(best, l1, l2, ev, model):
    """Best-by-HR and best-by-ARHR, the first point winning ties."""
    if ev.hr > best["bestHRHR"]:
        best.update(bestHRHR=ev.hr, bestARHR=ev.arhr, bestl1HR=float(l1),
                    bestl2HR=float(l2), best_model_hr=model)
    if ev.arhr > best["bestARAR"]:
        best.update(bestHRAR=ev.hr, bestARAR=ev.arhr, bestl1AR=float(l1),
                    bestl2AR=float(l2), best_model_ar=model)


def mselect_core(train: CSR, test: CSR, cfg: SlimConfig, points,
                 keep_models: bool = False, point_callback=None, mesh=None,
                 device=None):
    """Walk ``points`` = [(l1, l2), ...] on ``device`` (CD with warm
    starts, or ADMM); returns the per-point records plus the best-by-HR /
    best-by-ARHR summaries.  Each record carries the JAX package's keys and
    the solver's ``loss`` (and for CD ``niters`` and ``sweeps``).
    ``point_callback(rec, model)`` runs after each evaluation, as in the
    JAX package; its ``rec`` is a copy of the point's record with
    ``rec["pack"]``, the retained
    :class:`~slim_tpu_torch.predict.DeviceModelPack` or None.  ``mesh``
    solves each point across its ranks (the module docstring); the
    rank's own card is ``device``."""
    train, test, fmarker = _aligned(train, test)
    npad = bucket_npad(train.ncols)
    admm = cfg.algo == "admm"
    if mesh is not None:
        from .parallel.dist import distributed_learn, sharded_gram_sparse
        from .parallel.mesh import mesh_device

        if admm:
            raise ValueError("mesh-distributed mselect supports algo='cd'")
        dev = mesh_device(mesh)
        gram = sharded_gram_sparse(train, mesh, pad_to=npad)
    else:
        dev = resolve_device(device)
        gram = compute_gram(train, cfg.gram, pad_to=npad, device=dev)
    # the retained pack serves the dense predict route only, so the model
    # stays on the device whenever that route takes the catalogue
    keep_dev = mesh is None and not admm \
        and npad <= SPARSE_PREDICT_THRESHOLD

    results = []
    best = _best()
    model = pack = None
    for (l1, l2) in points:
        pcfg = cfg.replace(l1r=float(l1), l2r=float(l2))
        t0 = time.perf_counter()
        if admm:
            model, stats = estimate_model_admm(train, pcfg, gram=gram,
                                               device=dev)
        elif mesh is not None:
            model, stats = distributed_learn(train, pcfg, mesh, imodel=model,
                                             gram=gram)
        else:
            model, stats = estimate_model_cd(train, pcfg, imodel=model,
                                             gram=gram,
                                             keep_device_model=keep_dev,
                                             warm_pack=pack, device=dev)
        t_learn = time.perf_counter() - t0
        pack = stats.pop("W_dev", None)
        ev, t_pred, t_metric = _evaluate(model, train, test, fmarker,
                                         cfg.nrcmds, pack, dev, mesh)
        if pack is not None:
            pack.free_dense()
        rec = _record(l1, l2, model, ev, stats, time=t_learn,
                      time_kind="per_point", time_predict=t_pred,
                      time_metric=t_metric)
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
        _track(best, l1, l2, ev, model)
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
    loop walks l2 for each l1, warm-starting from the previous model.

    ``parallel=True`` solves the whole grid with CD in one packed pass
    (each block's columns carry their point's regularisation; no warm
    starts) and evaluates each point as the walk does.  One solve serves
    every point, so each record's ``time`` is the grid average
    (``time_kind="grid_average"``) and the result has ``grid_time``.
    With ``mesh`` the walk's points, or the packed grid's blocks, are
    solved across the ranks (the module docstring)."""
    points = [(l1, l2) for l1 in arrayl1 for l2 in arrayl2]
    if not parallel:
        return mselect_core(train, test, cfg, points, mesh=mesh,
                            device=device)
    if cfg.algo != "cd":
        raise ValueError("mselect_grid(parallel=True) solves with CD; "
                         f"algo {cfg.algo!r} walks with parallel=False")
    train, test, fmarker = _aligned(train, test)
    t0 = time.perf_counter()
    if mesh is not None:
        from .parallel.dist import distributed_grid
        from .parallel.mesh import mesh_device

        dev = mesh_device(mesh)
        solved = distributed_grid(train, cfg, points, mesh)
    else:
        dev = resolve_device(device)
        solved = estimate_grid_cd(train, cfg, points, device=dev)
    t_solve = time.perf_counter() - t0

    results = []
    best = _best()
    for (l1, l2), (model, stats) in zip(points, solved):
        ev, t_pred, t_metric = _evaluate(model, train, test, fmarker,
                                         cfg.nrcmds, None, dev, mesh)
        results.append(_record(l1, l2, model, ev, stats,
                               time=t_solve / max(len(points), 1),
                               time_kind="grid_average",
                               time_predict=t_pred, time_metric=t_metric))
        _track(best, l1, l2, ev, model)
    best["results"] = results
    best["grid_time"] = t_solve
    return best
