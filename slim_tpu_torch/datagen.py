"""Deterministic synthetic workload generation at reference benchmark
shapes.

The build brief's north-star workloads (BASELINE.json configs[2-4]) are
MovieLens-20M and Amazon-books scale; neither dataset can be vendored, so
benchmarks synthesize matrices with matching shape statistics: zipf-ish
item popularity (head items rated by ~half the users, like ML-20M's top
movies), uniform user activity, implicit 0/1 feedback.
"""

from __future__ import annotations

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
