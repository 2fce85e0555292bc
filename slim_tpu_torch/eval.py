"""Top-N evaluation: HR, head-HR, tail-HR, ARHR.

Single source of truth for the metric logic the reference duplicates three
times (src/programs/slim_predict.c:180-235, src/programs/slim_mselect.c:
122-203, src/libslim/pyapi.c:308-399).  Semantics are bit-matched to those
loops:

* a user is *valid* if prediction succeeded (and, in the mselect variant,
  has >=1 test item); metrics are averaged over valid users;
* per-user HR = (#test items present in the top-N list) / (#test items);
* head/tail HR only average over users that have >=1 head (resp. tail)
  test item; per-user head-HR = head hits / head true count (0 when no
  head hits -- the reference's ``nhits>0 ? nhits/ntrue : 0`` guard);
* per-user ARHR = sum over hits of 1/(1+rank) normalised by the ideal
  baseline sum_{k=0}^{ntest-1} 1/(1+k) (slim_predict.c:195,228).

Head/tail split: items sorted by training frequency descending; the most
frequent items covering 50% of the ratings form the head (marker 0), the
rest the tail (marker 1) (SLIM_DetermineHeadAndTail, api.c:215-245).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import CSR

__all__ = ["determine_head_tail", "evaluate_topn", "EvalResult"]


def determine_head_tail(train: CSR, ncols: int | None = None) -> np.ndarray:
    """Return int32 marker array: 0 = head item, 1 = tail item.

    Mirrors SLIM_DetermineHeadAndTail (api.c:215-245): sort items by
    frequency desc, mark head while the remaining budget (floor(nnz/2)) is
    positive.  The item that crosses the 50% boundary is still head.
    """
    n = int(ncols if ncols is not None else train.ncols)
    counts = np.bincount(train.indices, minlength=n).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    sorted_counts = counts[order]
    budget = train.nnz // 2
    remaining_before = budget - np.concatenate(
        ([0], np.cumsum(sorted_counts[:-1]))) if n else np.zeros(0, np.int64)
    is_head_sorted = remaining_before > 0
    marker = np.ones(n, dtype=np.int32)
    marker[order[is_head_sorted]] = 0
    return marker


@dataclasses.dataclass
class EvalResult:
    hr: float
    hr_head: float
    hr_tail: float
    arhr: float
    nvalid: int
    nvalid_head: int
    nvalid_tail: int

    def __repr__(self):
        return (f"EvalResult(hr={self.hr:.4f} hr_head={self.hr_head:.4f} "
                f"hr_tail={self.hr_tail:.4f} arhr={self.arhr:.4f} "
                f"nvalid={self.nvalid})")


def evaluate_topn(topn_ids: np.ndarray, topn_counts: np.ndarray, test: CSR,
                  fmarker: np.ndarray,
                  require_test_items: bool = False) -> EvalResult:
    """Evaluate per-user top-N lists against a test matrix (vectorised).

    Parameters
    ----------
    topn_ids : (nusers, N) int32, item ids per rank, -1 = empty slot.
    topn_counts : (nusers,) number of filled slots per user; a negative
        value marks a failed prediction (reference SLIM_ERROR).
    test : test CSR (one row per user, aligned with topn rows).
    fmarker : head/tail marker from :func:`determine_head_tail`.
    require_test_items : the mselect programs skip users with no test items
        (slim_mselect.c:129, pyapi.c:315) while slim_predict counts every
        user as valid; this toggles between the two conventions.
    """
    nusers, N = topn_ids.shape
    assert test.nrows == nusers, "test rows must align with prediction rows"

    ncols = max(int(test.ncols), len(fmarker),
                int(topn_ids.max()) + 1 if topn_ids.size else 1)
    counts = np.asarray(topn_counts)
    ntest = test.row_nnz().astype(np.int64)

    considered = (~(require_test_items & (ntest < 1))) & (counts >= 0)
    nvalid = int(np.sum(considered))
    scored = considered & (ntest >= 1)

    # per-user head/tail true counts over test items
    tmark = fmarker[test.indices] if test.nnz else np.zeros(0, np.int32)
    urow = np.repeat(np.arange(nusers, dtype=np.int64),
                     ntest) if test.nnz else np.zeros(0, np.int64)
    ntrue_head = np.bincount(urow[tmark == 0], minlength=nusers)
    ntrue_tail = np.bincount(urow[tmark == 1], minlength=nusers)
    nvalid_head = int(np.sum(scored & (ntrue_head > 0)))
    nvalid_tail = int(np.sum(scored & (ntrue_tail > 0)))

    # hit detection via keyed membership: key = user * ncols + item
    slot_ok = (np.arange(N)[None, :] < np.maximum(counts, 0)[:, None]) \
        & (topn_ids >= 0) & scored[:, None]
    rec_keys = np.arange(nusers, dtype=np.int64)[:, None] * ncols \
        + np.clip(topn_ids, 0, ncols - 1)
    test_keys = urow * ncols + test.indices
    hit = slot_ok & np.isin(rec_keys, test_keys)

    rmark = fmarker[np.clip(topn_ids, 0, len(fmarker) - 1)]
    nh_head = np.sum(hit & (rmark == 0), axis=1)
    nh_tail = np.sum(hit & (rmark == 1), axis=1)
    nh = np.sum(hit, axis=1)

    inv_rank = 1.0 / (1.0 + np.arange(N, dtype=np.float64))
    larhr = np.sum(hit * inv_rank[None, :], axis=1)
    harm = np.concatenate(([0.0], np.cumsum(1.0 / (1.0 + np.arange(
        int(ntest.max()) if nusers else 0, dtype=np.float64)))))
    baseline = harm[ntest]

    with np.errstate(divide="ignore", invalid="ignore"):
        hr_all = float(np.sum(np.where(scored, nh / np.maximum(ntest, 1), 0.0)))
        hr_head = float(np.sum(np.where(
            scored & (nh_head > 0), nh_head / np.maximum(ntrue_head, 1), 0.0)))
        hr_tail = float(np.sum(np.where(
            scored & (nh_tail > 0), nh_tail / np.maximum(ntrue_tail, 1), 0.0)))
        arhr = float(np.sum(np.where(scored,
                                     larhr / np.maximum(baseline, 1e-300),
                                     0.0)))

    return EvalResult(
        hr=hr_all / nvalid if nvalid else 0.0,
        hr_head=hr_head / nvalid_head if nvalid_head else 0.0,
        hr_tail=hr_tail / nvalid_tail if nvalid_tail else 0.0,
        arhr=arhr / nvalid if nvalid else 0.0,
        nvalid=nvalid,
        nvalid_head=nvalid_head,
        nvalid_tail=nvalid_tail,
    )
