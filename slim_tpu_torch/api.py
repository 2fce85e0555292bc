"""User-facing API (port of slim_tpu/api.py): the functional ``learn`` =
SLIM_Learn, ``get_topn`` = SLIM_GetTopN, ``write_model`` / ``read_model`` =
SLIM_WriteModel / SLIM_ReadModel (include/slim.h:79-167), and the
``SLIM`` / ``SLIMatrix`` classes of the reference Python package
(python-package/SLIM/core.py:245-681).  Every entry point takes
``device=None``, resolved by :func:`~slim_tpu_torch.utils.resolve_device`
(the card; a CPU run passes ``device="cpu"``)."""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from .config import SlimConfig, SLIM_DBG_TIME, dbg
from .io.readers import read_binrow, read_csr, write_binrow, write_csr
from .mselect import mselect_grid
from .predict import (SPARSE_PREDICT_THRESHOLD, densify_model,
                      native_predict_applicable, predict_topn,
                      predict_topn_1vsk)
from .solvers.admm import estimate_model_admm
from .solvers.cd import bucket_npad, estimate_model_cd
from .types import CSR
from .utils import resolve_device, span

logger = logging.getLogger("slim_tpu_torch")

__all__ = ["learn", "get_topn", "write_model", "read_model", "SLIM",
           "SLIMatrix", "setup_training_matrix"]


def setup_training_matrix(train: CSR) -> CSR:
    """Training-matrix setup (CreateTrainingMatrix, setup.c:109-135):
    ncols from the largest column index when that is wider."""
    return train.infer_ncols()


def _profiled(run, profile_dir: str, dev):
    """``run()`` under torch.profiler (CPU, plus CUDA on a card), its
    Chrome trace exported to ``profile_dir/trace_<pid>_<ns>.json``: the
    counterpart of ``jax.profiler.trace``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = run()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    return out


def learn(train: CSR, cfg: Optional[SlimConfig] = None,
          imodel: Optional[CSR] = None, gram=None,
          keep_device_model: bool = False, device=None):
    """Estimate a SLIM model with CD or ADMM (``cfg.algo``) on ``device``
    (default: the card; with none it raises, a CPU run passes
    ``device="cpu"``).  Returns (model CSR, stats dict); stats adds
    setup_s, learn_s and total_s to the solver's.  Every mtype learns:
    oslim as slim and ofslim as fslim, since the reference never reads
    ``ordered``.

    ``imodel`` warm-starts a CD solve (ADMM ignores it, as the reference
    does); ``gram`` is a precomputed Gram in item space on ``device``;
    ``keep_device_model=True`` (CD) returns the model also as
    ``stats["W_dev"]``, a device pack that ``get_topn(..., W_dev=...)``
    densifies in place (no model upload).  ``cfg.profile_dir`` runs the
    solve under torch.profiler and writes a Chrome trace there.  The call
    is a ``slim.learn`` span under a profiler started outside it."""
    if isinstance(cfg, dict):
        cfg = SlimConfig.from_dict(cfg)
    cfg = cfg or SlimConfig()
    dev = resolve_device(device)

    def run():
        if cfg.algo == "admm":
            return estimate_model_admm(tmat, cfg, imodel=imodel, gram=gram,
                                       device=dev)
        return estimate_model_cd(tmat, cfg, imodel=imodel, gram=gram,
                                 keep_device_model=keep_device_model,
                                 device=dev)

    with span("slim.learn"):
        t_total = time.perf_counter()
        tmat = setup_training_matrix(train)
        t_setup = time.perf_counter() - t_total
        t_learn = time.perf_counter()
        model, stats = _profiled(run, cfg.profile_dir, dev) \
            if cfg.profile_dir else run()
        t_learn = time.perf_counter() - t_learn
        t_total = time.perf_counter() - t_total
    stats = dict(stats, setup_s=t_setup, learn_s=t_learn, total_s=t_total)
    if dbg(cfg, SLIM_DBG_TIME):
        logger.info("Timing: total %.3fs setup %.3fs learn %.3fs",
                    t_total, t_setup, t_learn)
    return model, stats


def get_topn(model: CSR, hist: CSR, nrcmds: int = 10, W_dev=None,
             sparse=None, device=None):
    """Top-N for every user row of ``hist`` (SLIM_GetTopN batched);
    ``sparse`` pins the dense (False) or sparse (True) scoring route."""
    return predict_topn(model, hist, nrcmds=nrcmds, W_dev=W_dev,
                        sparse=sparse, device=device)


def write_model(model: CSR, path: str) -> None:
    """SLIM_WriteModel (binary row format, api.c:174-177)."""
    write_binrow(model, path)


def read_model(path: str) -> CSR:
    """SLIM_ReadModel (api.c:187-194)."""
    return read_binrow(path)


# --------------------------------------------------------------------- #
# class-based interface (python-package parity)
# --------------------------------------------------------------------- #
def _first_seen(labels):
    """(distinct labels in order of first appearance, each entry's index
    into them)."""
    uniq, first, inv = np.unique(labels, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    return uniq[order], rank[inv.reshape(-1)]


def _lookup(table: dict, labels):
    """Each label's id in ``table``, -1 where it has none (one dict lookup
    per distinct label)."""
    uniq, inv = np.unique(labels, return_inverse=True)
    ids = np.array([table.get(u, -1) for u in uniq.tolist()], np.int64)
    return ids[inv.reshape(-1)]


def _params(params) -> SlimConfig:
    return params if isinstance(params, SlimConfig) else \
        SlimConfig.from_dict(params)


class SLIMatrix:
    """User-item matrix with id maps (core.py:245-385).

    Accepts a scipy sparse matrix, a slim_tpu_torch CSR, a 2-D array or
    list of (user, item, rating) triplets, or a pandas DataFrame of those
    columns.  Triplet labels are numbered in order of first appearance;
    ``oldmat`` (a SLIMatrix or a trained SLIM) fixes the item map (and,
    for a SLIMatrix, the user map), and events outside it are dropped with
    a warning (core.py:289-351)."""

    def __init__(self, data, oldmat=None):
        import scipy.sparse as sp

        if isinstance(data, CSR):
            self._identity(data)
        elif sp.issparse(data):
            self._identity(CSR.from_scipy(data))
            if oldmat is not None:
                n_old = oldmat.nItems if isinstance(oldmat, SLIMatrix) \
                    else len(oldmat.id2item)
                if self.nItems != n_old:
                    raise TypeError("The size of the input matrix does not "
                                    "match the size of oldmat.")
        else:
            if type(data).__name__ == "DataFrame":
                data = data.values    # pandas, without importing it
            if not isinstance(data, (list, np.ndarray)):
                raise TypeError(f"Input data type {type(data).__name__} is "
                                "not supported.")
            self._triplets(np.asarray(data), oldmat)

    def _identity(self, mat: CSR):
        self.mat = mat
        self.nUsers, self.nItems = mat.shape
        self.id2item = np.arange(self.nItems)
        self.item2id = {i: i for i in range(self.nItems)}
        self.id2user = np.arange(self.nUsers)
        self.user2id = {u: u for u in range(self.nUsers)}

    def _triplets(self, data, oldmat):
        users, items = data[:, 0], data[:, 1]
        if oldmat is None:
            self.id2user, u = _first_seen(users)
            self.id2item, i = _first_seen(items)
        elif isinstance(oldmat, (SLIMatrix, SLIM)):
            self.id2item = np.array(oldmat.id2item).copy()
            i = _lookup(dict(oldmat.item2id), items)
            if isinstance(oldmat, SLIMatrix):
                self.id2user = np.array(oldmat.id2user).copy()
                u = _lookup(dict(oldmat.user2id), users)
            else:
                self.id2user, u = _first_seen(users)
        else:
            raise TypeError("oldmat must be a SLIMatrix or SLIM model")
        self.item2id = {k: j for j, k in enumerate(self.id2item.tolist())}
        self.user2id = {k: j for j, k in enumerate(self.id2user.tolist())}
        ok = (u >= 0) & (i >= 0)
        if not ok.all():
            logger.warning("%d of the events fall out of the range of "
                           "oldmat. Partial entries collected.",
                           int((~ok).sum()))
        self.nUsers, self.nItems = len(self.id2user), len(self.id2item)
        self.mat = CSR.from_ijv(u[ok], i[ok],
                                data[ok, 2].astype(np.float32),
                                nrows=self.nUsers, ncols=self.nItems)


class SLIM:
    """A trained SLIM model with train / mselect / predict / save / load
    (core.py:388-681).  Prediction runs through ``predict_topn`` /
    ``predict_topn_1vsk``; a top-N call with no resident device model that
    ``native_predict_applicable`` accepts builds none and is served on the
    host by the native route."""

    def __init__(self):
        self.model: Optional[CSR] = None
        self.stats = None
        self.nItems = 0
        self.id2item = None
        self.item2id = None
        self._W_dev = None     # the model kept on a device for predict

    def _keep(self, data: SLIMatrix):
        self.nItems = data.nItems
        self.id2item = np.array(data.id2item).copy()
        self.item2id = dict(data.item2id)

    def train(self, params, data: SLIMatrix, device=None):
        """Learn on ``data`` with ``params`` (a SlimConfig or a dict of the
        reference package's keys).  A CD model whose catalogue predicts on
        the dense route stays on the device for :meth:`predict`."""
        if not isinstance(data, SLIMatrix):
            raise TypeError("trndata must be a SLIMatrix object.")
        cfg = _params(params)
        start = time.time()
        mat = data.mat.with_ncols(max(data.mat.ncols, data.nItems))
        keep = cfg.algo == "cd" and \
            bucket_npad(mat.ncols) <= SPARSE_PREDICT_THRESHOLD
        self.model, self.stats = learn(mat, cfg, keep_device_model=keep,
                                       device=device)
        self._W_dev = self.stats.pop("W_dev", None)
        self._keep(data)
        logger.info("Learning takes %.3f secs.", time.time() - start)

    def mselect(self, params, trndata: SLIMatrix, tstdata: SLIMatrix,
                arrayl1, arrayl2, nrcmds: int = 10, parallel: bool = False,
                device=None):
        """Grid search over the sorted l1 x l2 cross product
        (Py_SLIM_Mselect, pyapi.c:214-412) through ``mselect_grid``;
        keeps the best-HR model and returns the result dict.
        ``parallel=True`` solves every point in one packed pass."""
        cfg = _params(params).replace(nrcmds=nrcmds)
        res = mselect_grid(trndata.mat, tstdata.mat, cfg, sorted(arrayl1),
                           sorted(arrayl2), parallel=parallel, device=device)
        self.model = res["best_model_hr"]
        self.stats = None
        self._W_dev = None
        self._keep(trndata)
        logger.info("The best HR is achieved by, l1: %.4f, l2:%.4f, "
                    "HR:%.4f, AR:%.4f.", res["bestl1HR"], res["bestl2HR"],
                    res["bestHRHR"], res["bestARHR"])
        logger.info("The best AR is achieved by, l1: %.4f, l2:%.4f, "
                    "HR:%.4f, AR:%.4f.", res["bestl1AR"], res["bestl2AR"],
                    res["bestHRAR"], res["bestARAR"])
        return res

    def _device_model(self, n: int, device):
        """The model for predict on ``device``: the pack kept by train or a
        dense W made once (dense catalogues), else None (the sparse routes
        upload the rows once per device themselves)."""
        dev = resolve_device(device)
        if self._W_dev is not None and self._W_dev.device.type == dev.type:
            return self._W_dev
        npad = bucket_npad(n)
        self._W_dev = densify_model(self.model, npad=npad, device=dev) \
            if npad <= SPARSE_PREDICT_THRESHOLD else None
        return self._W_dev

    def predict(self, data: SLIMatrix, nrcmds: int = 10, outfile=None,
                negitems=None, nnegs: int = 0, returnscores: bool = False,
                device=None):
        """Top-``nrcmds`` item labels per user label of ``data``; with
        ``negitems`` (user label -> ``nnegs`` item labels) the top of each
        user's candidates (1-vs-k).  Returns {user: labels} (and {user:
        scores} with ``returnscores``); ``outfile`` gets one line per
        user."""
        if self.model is None:
            raise TypeError("Model not found. Please train a model.")
        if self.nItems != data.nItems:
            raise AssertionError(
                "The shape of the input matrix should match the model.")
        n = max(self.model.nrows, self.model.ncols, data.mat.ncols)
        # as the JAX package's SLIM.predict: no dense device model for a
        # call predict_topn would serve on the native host route
        W = None if (self._W_dev is None and negitems is None
                     and native_predict_applicable(n, self.model, data.mat)) \
            else self._device_model(n, device)
        if negitems is not None:
            if nnegs < nrcmds:
                raise AssertionError(
                    "The number of negative items must be larger than the "
                    "number of items to be recommended.")
            neg = np.full((data.nUsers, nnegs), -1, dtype=np.int32)
            newitems = 0
            for key, value in negitems.items():
                if len(value) != nnegs:
                    raise AssertionError(
                        "The number of negative items should match nnegs.")
                ids = _lookup(self.item2id, np.asarray(value))
                newitems += int((ids < 0).sum())
                neg[data.user2id[key]] = ids
            if newitems:
                logger.warning("%d negative items not in the training set.",
                               newitems)
            ids, scores, _ = predict_topn_1vsk(
                self.model, data.mat, neg, nrcmds=nrcmds, W_dev=W,
                device=device)
        else:
            ids, scores, _ = predict_topn(self.model, data.mat,
                                          nrcmds=nrcmds, W_dev=W,
                                          device=device)

        # internal ids back to item labels (-1 slots keep -1)
        id2item = np.asarray(self.id2item)
        res = np.where(ids >= 0, id2item[np.clip(ids, 0, len(id2item) - 1)],
                       -1)
        out = {k: res[v] for k, v in data.user2id.items()}
        outscores = {k: scores[v] for k, v in data.user2id.items()}
        if outfile:
            def line(key, a):
                return f"{key}: {np.array2string(a, max_line_width=np.inf)}\n"

            with open(outfile, "w") as fh:
                for key, value in out.items():
                    fh.write(line(key, value))
                    if returnscores:
                        fh.write(line(key, outscores[key]))
        return (out, outscores) if returnscores else out

    def save_model(self, modelfname: str, mapfname: str):
        """The model as a 0-based csr file with values, the item labels one
        per line."""
        if self.model is None:
            raise RuntimeError("Not exist a model to save.")
        write_csr(self.model, modelfname, writevals=True, numbering=0)
        np.savetxt(mapfname, np.asarray(self.id2item), fmt="%s")

    def load_model(self, modelfname: str, mapfname: str):
        if not (os.path.isfile(modelfname) and os.path.isfile(mapfname)):
            raise RuntimeError("File does not exist or invalid filename.")
        m = read_csr(modelfname, readvals=True, numbering=0)
        n = max(m.nrows, m.ncols)             # the model is square over items
        self.model = CSR.from_arrays(m.nrows, n, m.indptr, m.indices, m.data)
        labels = np.loadtxt(mapfname, dtype=str, comments=None, ndmin=1)
        for dt in (np.int64, np.float64):     # as written, else as text
            try:
                labels = labels.astype(dt)
                break
            except ValueError:
                pass
        self.id2item = labels
        self.item2id = {k: j for j, k in enumerate(self.id2item.tolist())}
        self.nItems = len(self.id2item)
        self.stats = None
        self._W_dev = None

    def to_csr(self, returnmap: bool = False):
        """The model as a scipy csr_matrix (and the item labels) that the
        caller owns: writable copies of the model's arrays, which stay
        read-only (``CSR``), so in-place scipy methods (``eliminate_zeros``,
        ``data *= 2``) work on it as on the JAX package's.  The copy is
        O(nnz): about 0.3 GB at an ML-20M model's 34.5M entries."""
        if self.model is None:
            raise RuntimeError("Not exist a model to export.")
        csr = self.model.to_scipy()
        return (csr, np.asarray(self.id2item).copy()) if returnmap else csr
