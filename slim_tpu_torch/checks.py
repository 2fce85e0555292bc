"""Checks of ranked top-N output, shared by the tests and ``chip_smoke.py``.
No prediction path calls them: :func:`topn_oracle_mismatches` scores on
the host with scipy, as an oracle only."""

from __future__ import annotations

import numpy as np


def ranked_mismatches(ids, sc, ids_ref, sc_ref, counts_ref=None, rtol=1e-5):
    """(ids that differ from the reference's, those of them not forgiven)
    for two ranked lists of the same users.

    float32 sums in another order (another route, atomic adds on the card)
    may swap two items whose scores differ by under ``rtol`` rel, so a
    differing id is forgiven where a neighbouring reference score is within
    ``rtol`` rel of its own, or at the list's last counted slot
    (``counts_ref``, default the full width) where the two lists' scores
    are within ``rtol`` rel (the item one past the reference's list
    near-ties it) and differ, or are equal with the lower id in ``ids``
    (the reference puts the lowest id first among exact ties, so its
    higher id won a near tie there).  Exact ties are never forgiven: every
    route orders them by the lowest id (or position)."""
    ids, sc = np.asarray(ids), np.asarray(sc)
    ids_ref, sc_ref = np.asarray(ids_ref), np.asarray(sc_ref)
    mism = ids != ids_ref
    lo, hi = sc_ref[:, 1:], sc_ref[:, :-1]
    close = np.isclose(lo, hi, rtol=rtol, atol=0) & (lo != hi)
    near = np.zeros_like(mism)
    near[:, 1:] |= close
    near[:, :-1] |= close
    k = sc_ref.shape[1]
    cnt = np.full(sc_ref.shape[0], k) if counts_ref is None \
        else np.asarray(counts_ref)
    last = np.arange(k)[None, :] == (cnt[:, None] - 1)
    near |= last & np.isclose(sc, sc_ref, rtol=rtol, atol=0) \
        & ((sc != sc_ref) | (ids < ids_ref))
    return int(mism.sum()), int((mism & ~near).sum())


def tie_order_mismatches(ids, ids_ref, sc_ref, counts_ref=None, rtol=1e-5):
    """(ids that differ from the reference's, those of them not forgiven)
    for two ranked lists of the same users whose routes order equal
    scores differently: the native host route keeps the first-touched id
    first, the device routes the lowest id.

    The reference's slots split into runs of scores equal within ``rtol``
    rel (neighbour to neighbour).  A differing id is forgiven where both
    lists hold the same ids in every run, in any order within it; the run
    that ends a full list (``counts_ref``, default the full width) may
    hold other ids, since an item past the list may tie it.  The scores
    themselves are compared by the caller."""
    ids = np.asarray(ids)
    ids_ref, sc_ref = np.asarray(ids_ref), np.asarray(sc_ref)
    mism = ids != ids_ref
    nu, k = sc_ref.shape
    if k == 0:
        return 0, 0
    brk = ~np.isclose(sc_ref[:, 1:], sc_ref[:, :-1], rtol=rtol, atol=0)
    run = np.concatenate([np.zeros((nu, 1), np.int64),
                          np.cumsum(brk, axis=1)], axis=1)
    cnt = np.full(nu, k) if counts_ref is None else np.asarray(counts_ref)
    last = run[np.arange(nu), np.maximum(cnt, 1) - 1]
    open_end = (cnt == k)[:, None] & (run == last[:, None])
    span = int(max(ids.max(initial=0), ids_ref.max(initial=0))) + 2
    key = run * span + ids + 1
    key_ref = run * span + ids_ref + 1
    key[open_end] = key_ref[open_end] = -1
    ok = (np.sort(key, axis=1) == np.sort(key_ref, axis=1)).all(axis=1)
    return int(mism.sum()), int(mism[~ok].sum())


def topn_oracle_mismatches(model, hist, got, rtol=1e-5):
    """Users whose top-N ``got`` (ids, scores, counts) differs from a scipy
    oracle of a square model (CSR, rows = rated item) and histories: the
    count must be min(N, #(score > 0)) with the history excluded, the
    scores the oracle's top scores in order, and each id's oracle score
    its own."""
    import scipy.sparse as sp

    n = model.ncols
    W = sp.csr_matrix((model.values(), model.indices, model.indptr),
                      shape=(n, n))
    H = sp.csr_matrix((hist.values(), hist.indices, hist.indptr),
                      shape=(hist.nrows, n))
    S = (H @ W).tocsr()
    ids, scores, counts = got
    k = ids.shape[1]
    bad = 0
    for u in range(hist.nrows):
        s = np.zeros(n)
        s[S.indices[S.indptr[u]:S.indptr[u + 1]]] = \
            S.data[S.indptr[u]:S.indptr[u + 1]]
        s[hist.indices[hist.indptr[u]:hist.indptr[u + 1]]] = -np.inf
        c = int(counts[u])
        bad += not (c == min(k, int((s > 0).sum()))
                    and np.allclose(scores[u, :c], np.sort(s)[::-1][:c],
                                    rtol=rtol, atol=1e-6)
                    and np.allclose(s[ids[u, :c]], scores[u, :c], rtol=rtol))
    return bad
