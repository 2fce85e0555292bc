"""Deterministic synthetic workload generation at reference benchmark
shapes.

The build brief's north-star workloads (BASELINE.json configs[2-4]) are
MovieLens-20M and Amazon-books scale; neither dataset can be vendored, so
benchmarks synthesize matrices with matching shape statistics: zipf-ish
item popularity (head items rated by ~half the users, like ML-20M's top
movies), uniform user activity, implicit 0/1 feedback.
"""

from __future__ import annotations

import math

import numpy as np

from .types import CSR

# MovieLens-20M shape (BASELINE.json configs[2])
ML20M_NROWS = 138_493
ML20M_NCOLS = 27_278
ML20M_NNZ = 20_000_000


def synth_implicit(nrows: int, ncols: int, nnz: int, seed: int = 0,
                   pop_exp: float = 0.6) -> CSR:
    """Implicit-feedback matrix with rank^-pop_exp item popularity.

    ``nnz`` is the number of raw events drawn; duplicates (user, item)
    collapse on CSR assembly, so the resulting matrix carries slightly
    fewer nonzeros (like real interaction logs).  pop_exp=0.6 at ML-20M
    shape puts the top item in ~60% of user histories, matching the real
    dataset's head.
    """
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, ncols + 1, dtype=np.float64) ** pop_exp
    p /= p.sum()
    # draw in slabs to bound the searchsorted temp memory
    items = np.empty(nnz, dtype=np.int32)
    cdf = np.cumsum(p)
    for s in range(0, nnz, 5_000_000):
        e = min(s + 5_000_000, nnz)
        items[s:e] = np.searchsorted(cdf, rng.random(e - s)).astype(np.int32)
    users = rng.integers(0, nrows, nnz, dtype=np.int32)
    mat = CSR.from_ijv(users, items, np.ones(nnz, np.float32),
                       nrows=nrows, ncols=ncols).binarize()
    return mat


def synth_ml20m(seed: int = 0, scale: float = 1.0) -> CSR:
    """ML-20M-shaped workload; ``scale`` shrinks all three dims for smoke
    tests (scale=1 is the benchmark shape)."""
    return synth_implicit(max(int(ML20M_NROWS * scale), 16),
                          max(int(ML20M_NCOLS * scale), 16),
                          max(int(ML20M_NNZ * scale * scale), 64),
                          seed=seed)


def zipf(rng, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 draws it, whatever numpy runs:
    later versions changed the rejection sampler's uniform, so the same
    seed gives other large draws (numpy 2.3: 1,313 for 1,316).  Each try
    takes two doubles U, V of ``rng.random()``; X = floor((1 - U)^(-1 /
    (a - 1))) is kept when V X (T - 1) / (b - 1) <= T / b, T = (1 +
    1/X)^(a - 1), b = 2^(a - 1).  Draws of 2^40 and above are recomputed
    with the C library's pow, whose last bit numpy's vector pow does not
    always give."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out, got = [], 0
    while got < size:
        need = size - got
        d = rng.random(2 * (need + need // 2 + 64)).reshape(-1, 2)
        U, V = 1.0 - d[:, 0], d[:, 1]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            X = np.floor(np.power(U, -1.0 / am1))
            T = np.power(1.0 + 1.0 / X, am1)
        for i in np.nonzero(X >= 2.0 ** 40)[0]:
            try:
                X[i] = math.floor(math.pow(U[i], -1.0 / am1))
            except OverflowError:          # beyond a double: rejected
                X[i] = math.inf
            T[i] = math.pow(1.0 + 1.0 / X[i], am1)
        ok = (X <= float(np.iinfo(np.int64).max)) & (X >= 1.0)
        with np.errstate(invalid="ignore"):
            ok &= V * X * (T - 1.0) / (b - 1.0) <= T / b
        out.append(X[ok].astype(np.int64))
        got += out[-1].size
    return np.concatenate(out)[:size]


def synth_longtail(nrows: int = 50_000, ncols: int = 2_000_000,
                   nnz: int = 400_000, nhot: int = 2000,
                   seed: int = 0) -> CSR:
    """The 2M-item long-tail workload of scripts/amazon2m_dryrun.py (its
    defaults): ``nnz`` implicit events, users uniform, items zipf(1.2)
    (:func:`zipf`, numpy 2.0's draws) over ``nhot`` hot items spread
    across the whole id space (item = hot * 997 mod ncols), so most of the
    catalogue is never rated."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, nrows, nnz)
    hot = (zipf(rng, 1.2, nnz * 2) % nhot)[:nnz]
    items = hot * 997 % ncols
    return CSR.from_ijv(users, items, np.ones(nnz, np.float32), nrows,
                        ncols).binarize()
