"""Plain reference for top-N serving: every item's score for a user,

    score(k) = sum over the user's history items i of W[i, k],

in float64, history items excluded and only scores above zero candidates
(a user may get fewer than N).  The model and the histories are densified
here from their CSR arrays.  NumPy and PyTorch only.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_model(indptr, indices, data, n: int, dev, dtype=torch.float64):
    """The n x n model W (rows: rated item, columns: target) on ``dev``."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    W = torch.zeros((n, n), dtype=dtype, device=dev)
    W.index_put_((torch.from_numpy(rows).to(dev),
                  torch.from_numpy(indices.astype(np.int64)).to(dev)),
                 torch.from_numpy(data).to(dev, dtype), accumulate=True)
    return W


def dense_history(indptr, indices, n: int, dev, dtype=torch.float64):
    """The (users, n) 0/1 history matrix of an implicit CSR."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    H = torch.zeros((len(indptr) - 1, n), dtype=dtype, device=dev)
    H[torch.from_numpy(rows).to(dev),
      torch.from_numpy(indices.astype(np.int64)).to(dev)] = 1.0
    return H


def scores(H, W) -> torch.Tensor:
    """Every item's score (float64), history items at -inf."""
    S = H.double() @ W.double() if H.dtype != W.dtype else H @ W
    return S.double().masked_fill_(H > 0, float("-inf"))


def topn(S, nrcmds: int):
    """(ids, scores, counts) of the top ``nrcmds`` of score rows ``S`` as
    the port returns them: ids -1 and scores 0 past the count of scores
    above zero."""
    top, ids = torch.topk(S, nrcmds, dim=1)
    cnt = (S > 0).sum(dim=1).clamp(max=nrcmds)
    ok = torch.arange(nrcmds, device=S.device)[None, :] < cnt[:, None]
    return (torch.where(ok, ids, -1).cpu().numpy(),
            torch.where(ok, top, 0.0).cpu().numpy(), cnt.cpu().numpy())


def judge(S, ids, got_scores, counts):
    """Served lists against the reference scores ``S`` (float64, history
    at -inf) of the same users.

    Returns (score_err, rank_gap, invalid): the largest gap between a
    served score and the reference score of its id; the largest gap by
    which the reference score of the id served at rank r lies below the
    reference's r-th best score (a history or missing id counts as
    scoring 0, one past the end as missing); both as shares of the user's
    best reference score; and the number of users whose list is malformed
    (a repeated id, a history id, an id out of range, a count other
    than the reference's, or an id where the count says none)."""
    dev = S.device
    U, N = ids.shape
    ref_top, _ = torch.topk(S, N, dim=1)
    ref_cnt = (S > 0).sum(dim=1).clamp(max=N)
    ref_top = torch.where(torch.arange(N, device=dev)[None, :]
                          < ref_cnt[:, None], ref_top, 0.0)
    best = ref_top[:, :1].clamp_min(1e-300)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    cnt_t = torch.from_numpy(np.asarray(counts, np.int64)).to(dev)
    served = torch.arange(N, device=dev)[None, :] < cnt_t[:, None]
    in_range = (ids_t >= 0) & (ids_t < S.shape[1])
    val = S.gather(1, ids_t.clamp(0, S.shape[1] - 1))
    history = served & in_range & torch.isinf(val)
    val = torch.where(served & in_range & ~history, val, 0.0)
    gap = ((ref_top - val) / best).max().item()
    sc = torch.from_numpy(np.asarray(got_scores, np.float64)).to(dev)
    err = torch.where(served, (sc - val).abs() / best, 0.0).max().item()
    srt = torch.sort(torch.where(served, ids_t, -1 - torch.arange(
        N, device=dev)[None, :]), dim=1).values
    bad = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    bad |= (served & ~in_range).any(dim=1) | history.any(dim=1)
    bad |= (~served & (ids_t != -1)).any(dim=1)
    bad |= cnt_t != ref_cnt
    return err, gap, int(bad.sum().item())
