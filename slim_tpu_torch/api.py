"""Functional API (port of slim_tpu/api.py): ``learn`` = SLIM_Learn,
``get_topn`` = SLIM_GetTopN, ``write_model`` / ``read_model`` =
SLIM_WriteModel / SLIM_ReadModel (include/slim.h:79-167).  The
``SLIM``/``SLIMatrix`` classes are not ported yet."""

from __future__ import annotations

import logging
import time
from typing import Optional

from .config import SlimConfig, SLIM_DBG_TIME, dbg
from .io.readers import read_binrow, write_binrow
from .predict import predict_topn
from .solvers.cd import estimate_model_cd
from .types import CSR

logger = logging.getLogger("slim_tpu_torch")

__all__ = ["learn", "get_topn", "write_model", "read_model"]


def learn(train: CSR, cfg: Optional[SlimConfig] = None,
          imodel: Optional[CSR] = None, gram=None,
          keep_device_model: bool = False, device=None):
    """Estimate a SLIM model with CD on ``device`` (default: the card; with
    none it raises, a CPU run passes ``device="cpu"``).  Returns (model CSR, stats dict); stats adds setup_s,
    learn_s and total_s to the solver's.  Every mtype learns: oslim as
    slim and ofslim as fslim, since the reference never reads ``ordered``.

    ``imodel`` warm-starts the solve; ``gram`` is a precomputed Gram in
    item space on ``device``; ``keep_device_model=True`` returns the model
    also as ``stats["W_dev"]``, a device pack that ``get_topn(...,
    W_dev=...)`` densifies in place (no model upload)."""
    if isinstance(cfg, dict):
        cfg = SlimConfig.from_dict(cfg)
    cfg = cfg or SlimConfig()
    if cfg.algo != "cd":
        raise NotImplementedError(f"algo {cfg.algo!r} is not ported yet")
    t_total = time.perf_counter()
    tmat = train.infer_ncols()     # CreateTrainingMatrix, setup.c:109-135
    t_setup = time.perf_counter() - t_total
    t_learn = time.perf_counter()
    model, stats = estimate_model_cd(tmat, cfg, imodel=imodel, gram=gram,
                                     keep_device_model=keep_device_model,
                                     device=device)
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
