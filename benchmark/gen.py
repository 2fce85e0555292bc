"""Inputs made from ``--seed``: the ratings matrix, the served model and the
order of the requests.

The ratings matrix is drawn as the port's ``datagen.synth_implicit`` draws
it (a copy of that arithmetic, not an import): events with rank^-pop_exp
item popularity and uniform users, repeated (user, item) pairs collapsed,
implicit feedback; the draws go on until the matrix holds the
configuration's count of ratings.  The served model is drawn on the
device with a ``torch.Generator``.  Sizes that set the amount of work
(row counts of the model, request sizes) come from the configuration and
the traffic mix alone, so every seed does the same work in another order.
"""

from __future__ import annotations

import numpy as np
import torch

# the seed of every configuration's ratings matrix; a run's seed relabels it
MATRIX_SEED = 0
# one stream per purpose, all from the run's seed
STREAM_MODEL = 1
STREAM_REQUESTS = 2
STREAM_SAMPLE = 3
STREAM_RELABEL = 4


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def implicit_matrix(nrows: int, ncols: int, nnz: int, seed: int,
                    pop_exp: float = 0.6, distinct: int | None = None):
    """(indptr int64, indices int32) of the implicit matrix that
    ``datagen.synth_implicit(nrows, ncols, nnz, seed, pop_exp)`` draws:
    the same draws in the same order, repeats collapsed, ids sorted in
    each row.  With ``distinct``, events are drawn on from the same stream
    until the matrix holds ``distinct`` (>= ``nnz``) (user, item) pairs:
    the first ``distinct`` pairs in the order of their draws."""
    rng = np.random.default_rng(seed)
    p = popularity(ncols, pop_exp)
    find = bucket_search(np.cumsum(p / p.sum()))
    key = _events(rng, find, nrows, ncols, nnz)
    key.sort()
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    while distinct is not None and len(key) < distinct:
        need = distinct - len(key)
        more = _events(rng, find, nrows, ncols, need + need // 4 + 64)
        pos = np.minimum(np.searchsorted(key, more), len(key) - 1)
        more = more[key[pos] != more]
        order = np.argsort(more, kind="stable")
        ranked = more[order]
        new = np.concatenate([[True], ranked[1:] != ranked[:-1]])
        add = np.sort(more[np.sort(order[new])[:need]])
        key = np.insert(key, np.searchsorted(key, add), add)
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // ncols, minlength=nrows), out=indptr[1:])
    return indptr, (key % ncols).astype(np.int32)


def _events(rng, find, nrows: int, ncols: int, n: int) -> np.ndarray:
    """The keys user * ncols + item of ``n`` drawn events: every item
    first, then every user, as ``synth_implicit`` draws them."""
    items = np.empty(n, dtype=np.int32)
    for s in range(0, n, 5_000_000):
        e = min(s + 5_000_000, n)
        items[s:e] = find(rng.random(e - s))
    np.minimum(items, ncols - 1, out=items)
    users = rng.integers(0, nrows, n, dtype=np.int32)
    return users.astype(np.int64) * ncols + items


def ratings_matrix(cfg: dict):
    """(indptr, indices) of the configuration's ratings matrix: drawn from
    ``MATRIX_SEED``, ``cfg["ratings"]`` events and on until it holds that
    many distinct (user, item) pairs."""
    return implicit_matrix(cfg["users"], cfg["items"], cfg["ratings"],
                           MATRIX_SEED, cfg["pop_exp"],
                           distinct=cfg["ratings"])


def relabel_maps(nrows: int, ncols: int, seed: int):
    """(new row of each row, new id of each item), permutations drawn from
    ``seed``."""
    rng = np.random.default_rng(derived_seed(seed, STREAM_RELABEL))
    return rng.permutation(nrows), rng.permutation(ncols)


def relabel(indptr, indices, new_row, new_col):
    """(indptr, indices) of the same matrix with row r moved to
    ``new_row[r]`` and item i renamed ``new_col[i]``, ids sorted in each
    row."""
    nrows, ncols = len(new_row), len(new_col)
    rows = np.repeat(new_row, np.diff(indptr)).astype(np.int64)
    key = rows * ncols + new_col[indices]
    key.sort()
    out = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // ncols, minlength=nrows), out=out[1:])
    return out, (key % ncols).astype(np.int32)


def bucket_search(cdf, bits: int = 20):
    """``np.searchsorted(cdf, r)`` for r in [0, 1) as a table lookup: with
    no two points of the ascending ``cdf`` closer than 2^-bits, each
    bucket [k, k + 1) / 2^bits holds at most one point, so the answer is
    the bucket's first point at or above its start, or the next.  Falls
    back to the binary search otherwise."""
    m = 1 << bits
    if len(cdf) < 2 or np.diff(cdf).min() <= 1.0 / m:
        return lambda r: np.searchsorted(cdf, r)
    first = np.searchsorted(cdf, np.arange(m + 1) / m)
    last = len(cdf) - 1

    def find(r):
        i = first[(r * m).astype(np.int64)]
        return i + (r > cdf[np.minimum(i, last)])

    return find


def row_counts(weights, total: int, cap: int) -> np.ndarray:
    """Integer counts proportional to ``weights``, none above ``cap``,
    summing to ``total`` (water-filling, then the remainder to the rows
    with the largest fractions)."""
    w = np.asarray(weights, dtype=np.float64)
    if total > cap * w.size:
        raise ValueError(f"{total} entries do not fit {w.size} rows of "
                         f"{cap}")
    lo, hi = 0.0, total / w.min()
    for _ in range(200):
        c = 0.5 * (lo + hi)
        if np.minimum(cap, c * w).sum() < total:
            lo = c
        else:
            hi = c
    x = np.minimum(cap, hi * w)
    k = np.floor(x).astype(np.int64)
    rest = total - int(k.sum())
    frac = np.where(k < cap, x - k, -1.0)
    k[np.argsort(-frac, kind="stable")[:rest]] += 1
    return k


def popularity(n: int, pop_exp: float) -> np.ndarray:
    """Item i's popularity (i + 1)^-pop_exp, as the matrix draws items."""
    return 1.0 / np.arange(1, n + 1, dtype=np.float64) ** pop_exp


def serve_model(n: int, nnz: int, pop, seed: int, dev,
                rows_per_call: int = 1024):
    """(indptr int64, indices int32, data float32) of an n x n model with
    ``nnz`` entries: nonnegative, no diagonal; row i (a rated item) holds
    a share of the entries that follows its popularity ``pop[i]`` (at most
    n - 1), its targets drawn without replacement weighted by their
    popularity (Efraimidis-Spirakis keys), its weights log-uniform in
    [1e-3, 1].  Drawn on ``dev`` a block of rows per call."""
    k = row_counts(pop, nnz, n - 1)
    g = torch.Generator(device=dev)
    g.manual_seed(derived_seed(seed, STREAM_MODEL))
    w = torch.from_numpy(pop).to(device=dev, dtype=torch.float32)
    k_dev = torch.from_numpy(k).to(dev)
    cols = torch.arange(n, device=dev)
    idx, val = [], []
    for r0 in range(0, n, rows_per_call):
        r1 = min(r0 + rows_per_call, n)
        u = torch.rand((r1 - r0, n), generator=g, device=dev)
        key = torch.log(u.clamp_min_(1e-30)) / w
        rows = torch.arange(r0, r1, device=dev)
        key[rows - r0, rows] = float("-inf")
        order = torch.argsort(key, dim=1, descending=True)
        keep = cols[None, :] < k_dev[r0:r1, None]
        mask = torch.zeros_like(keep).scatter_(1, order, keep)
        idx.append(mask.nonzero()[:, 1].to(torch.int32).cpu())
        val.append(torch.pow(10.0, -3.0 * torch.rand(
            idx[-1].numel(), generator=g, device=dev)).cpu())
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(k, out=indptr[1:])
    return (indptr, torch.cat(idx).numpy(),
            torch.cat(val).numpy().astype(np.float32))


def request_sizes(spec: dict) -> np.ndarray:
    """The multiset of request sizes (users) of one cycle of a mix:
    ``{"fixed": m}`` or ``{"log_uniform": [lo, hi], "cycle": c}`` (c sizes
    at the midpoints of c equal steps of log size, the same for every
    seed)."""
    if "fixed" in spec:
        return np.array([int(spec["fixed"])], dtype=np.int64)
    lo, hi = spec["log_uniform"]
    c = int(spec["cycle"])
    t = (np.arange(c) + 0.5) / c
    return np.rint(np.exp(np.log(lo) + t * (np.log(hi) - np.log(lo)))) \
        .astype(np.int64)


def request_plan(nusers: int, spec: dict, seed: int):
    """One cycle of requests, each an array of user ids: the sizes of
    :func:`request_sizes` in a seeded order (a fixed size: enough requests
    to cover every user once, the last wrapping), users taken in turn from
    a seeded permutation of all users, wrapping."""
    rng = np.random.default_rng(derived_seed(seed, STREAM_REQUESTS))
    sizes = request_sizes(spec)
    if "fixed" in spec:
        sizes = np.repeat(sizes, -(-nusers // int(sizes[0])))
    else:
        sizes = rng.permutation(sizes)
    perm = rng.permutation(nusers)
    ends = np.cumsum(sizes)
    take = np.arange(ends[-1]) % nusers
    return [perm[take[e - s:e]] for s, e in zip(sizes, ends)]


def sub_rows(indptr, indices, rows):
    """(indptr, indices) of the given rows of a CSR, in that order."""
    lens = indptr[rows + 1] - indptr[rows]
    out_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=out_ptr[1:])
    starts = np.repeat(indptr[rows] - out_ptr[:-1], lens)
    pos = np.arange(out_ptr[-1], dtype=np.int64) + starts
    return out_ptr, indices[pos]
