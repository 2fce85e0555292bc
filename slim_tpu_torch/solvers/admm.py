"""ADMM model estimation (port of slim_tpu/solvers/admm.py, single device).

Dense all-columns-at-once solver of src/libslim/estimate.c:38-304, with the
reference's constants (optTol and maxniters are ignored, as there):

    rho = 10000, MAXITERS = 30
    T = RᵀR                                  (estimate.c:124-125)
    P = inv(T + (l2r+rho) I)   (Cholesky)    (estimate.c:140-164)
    A = P T                                  (estimate.c:167-168)
    iterate 30x:
        T := P (rho W - C) + A               (estimate.c:171-183)
        gamma_i = T_ii / P_ii ; B = T - P diag(gamma)   (estimate.c:185-196)
        W = max(soft_threshold(B + C/rho, l1r/rho), 0)  (estimate.c:199-204)
        C += rho (B - W)                     (estimate.c:207-213)
    model = sparsify(W > 0)                  (estimate.c:216-269)

The dual is kept scaled, Cs = C/rho, as in the JAX package.  The products
are plain float32 ``torch.matmul`` with TF32 off (``pin_f32``): with rho
= 1e4 a 10-bit mantissa would turn the iteration into noise.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import SlimConfig, SLIM_DBG_INFO, SLIM_DBG_TIME, dbg
from ..ops.gram import compute_gram, pin_f32
from ..types import CSR
from ..utils import PhaseTimer, resolve_device

logger = logging.getLogger("slim_tpu_torch")

RHO = 10000.0
MAXITERS = 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def admm_factor(T, l2r):
    """(P, A): P = (T + (l2r + rho) I)^-1 from its Cholesky factor,
    symmetrised (estimate.c:152-164), and A = P T.  Raises when the
    factorisation fails."""
    M = T + (float(l2r) + RHO) * torch.eye(T.shape[0], dtype=T.dtype,
                                          device=T.device)
    L, info = torch.linalg.cholesky_ex(M)
    if int(info) != 0:
        raise RuntimeError(f"ADMM: Cholesky of T + (l2r + rho) I failed "
                           f"(info {int(info)})")
    P = torch.cholesky_inverse(L)
    P = 0.5 * (P + P.T)
    return P, P @ T


def admm_iterate(P, A, l1r):
    """The MAXITERS iterations from W = Cs = 0; returns W, or raises when
    it is not finite."""
    Pdiag = torch.diagonal(P)
    kappa = float(l1r) / RHO
    W = torch.zeros_like(P)
    Cs = torch.zeros_like(P)
    for _ in range(MAXITERS):
        Tm = torch.addmm(A, P, W - Cs, alpha=RHO)          # P(rho W - C) + A
        Bm = Tm - P * (torch.diagonal(Tm) / Pdiag)[None, :]
        # max(soft_threshold(alpha, kappa), 0) = max(alpha - kappa, 0)
        W = torch.clamp(Bm + Cs - kappa, min=0.0)
        Cs = Cs + (Bm - W)
    if not bool(torch.isfinite(W).all()):
        raise RuntimeError("ADMM: the iteration left non-finite entries")
    return W


def admm_stats(T, W, l1r, l2r):
    """(err, obj) as Python floats from the Gram identity
    ||R - RW||² = tr(G) - 2 tr(GW) + tr(WᵀGW): one product in the solve's
    precision, the three traces reduced in float64 (they cancel heavily
    when the users are many)."""
    GW = (T @ W).double()
    Td, Wd = T.double(), W.double()
    err = 0.5 * (torch.trace(Td) - 2.0 * (Td * Wd.T).sum()
                 + (Wd * GW).sum())
    obj = err + 0.5 * float(l2r) * (Wd * Wd).sum() \
        + float(l1r) * Wd.abs().sum()
    return float(err), float(obj)


def admm_solve(T, l1r, l2r):
    """ADMM on a padded (npad, npad) float32 Gram ``T`` on its device
    (zeros outside the leading n x n block).  Returns (W, err, obj)."""
    if T.dtype != torch.float32:
        raise ValueError("admm_solve takes a float32 Gram")
    pin_f32()
    P, A = admm_factor(T, l2r)
    W = admm_iterate(P, A, l1r)
    return (W, *admm_stats(T, W, l1r, l2r))


def admm_solve_f64(T, l1r, l2r):
    """The plain float64 version of :func:`admm_solve` on ``T``'s device:
    the same steps in double precision, as the reference's MKL pipeline
    runs them.  Returns W (float64)."""
    P, A = admm_factor(T.to(torch.float64), l2r)
    return admm_iterate(P, A, l1r)


def estimate_model_admm(train: CSR, cfg: SlimConfig, imodel: CSR | None = None,
                        gram=None, device=None):
    """Estimate a SLIM model with ADMM on ``device`` (default: the card;
    raises without one).  ``imodel`` is accepted and ignored, as the
    reference does (estimate.c:38); ``gram`` is a precomputed padded Gram
    on ``device`` (model selection shares one).  Returns (model, stats):
    loss, fit, ffrac, nnz, density and ``phases`` (seconds of gram,
    factor, iterate, sparsify)."""
    dev = resolve_device(device)
    pin_f32()
    n = train.ncols
    npad = _round_up(n + 1, 128)
    if train.nnz == 0:
        model = CSR.from_ijv(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), nrows=n, ncols=n,
                             no_duplicates=True)
        return model, {"loss": 0.0, "fit": 0.0, "ffrac": 0.0, "nnz": 0,
                       "density": 0.0, "phases": {}}
    clock = PhaseTimer(dev, "slim.admm")
    with clock.phase("gram"):
        T = gram if gram is not None else \
            compute_gram(train, cfg.gram, pad_to=npad, device=dev)
    with clock.phase("factor"):
        P, A = admm_factor(T, cfg.l2r)
    with clock.phase("iterate"):
        W = admm_iterate(P, A, cfg.l1r)
        del P, A
        err, obj = admm_stats(T, W, cfg.l1r, cfg.l2r)

    # sparsify W > 0 (strict, estimate.c:241) into the model CSR
    with clock.phase("sparsify"):
        Wn = W[:n, :n]
        rows, cols = torch.nonzero(Wn > 0.0, as_tuple=True)
        vals = Wn[rows, cols].cpu().numpy()
        model = CSR.from_ijv(rows.cpu().numpy().astype(np.int32),
                             cols.cpu().numpy().astype(np.int32), vals,
                             nrows=n, ncols=n, no_duplicates=True)
    stats = {"loss": obj, "fit": err, "ffrac": err / obj if obj else 0.0,
             "nnz": model.nnz, "density": model.nnz / max(n * n, 1),
             "phases": dict(clock.phases)}
    if dbg(cfg, SLIM_DBG_TIME):
        logger.info("admm phases: %s", "  ".join(
            f"{k} {v:.2f}s" for k, v in clock.phases.items()))
    if dbg(cfg, SLIM_DBG_INFO):
        logger.info("ADMM done: loss %.5e fit %.5e nnz %d density %.4f",
                    obj, err, model.nnz, stats["density"])
    return model, stats
