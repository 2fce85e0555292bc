"""Top-N prediction, dense path (port of slim_tpu/predict.py).

score(k) = Σ_{i in history} rating_i · W[i, k] (predict.c:40-58); history
items are excluded and only items with score > 0 are candidates, so a user
can get fewer than N recommendations (predict.c:62).

The model is densified on the device through the densify kernel (model
rows as runs), each user block's histories likewise; the scores are one
float32 ``torch.matmul`` (TF32 off), then the history mask and the top-N
with ties broken by the lowest id (:func:`topk_lowest_id`, the order
``lax.top_k`` gives).  Ids come back directly (no packed transfer).  Catalogues
above SPARSE_PREDICT_THRESHOLD need the padded-sparse path, which is not
ported yet.  A model the solver kept on the device
(:class:`DeviceModelPack`) densifies there, with no upload.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.densify import densify_runs
from .ops.gram import pin_f32
from .solvers.cd import bucket_npad
from .types import CSR
from .utils import resolve_device

# above this many items a dense (npad, npad) W stops fitting next to the
# score blocks; the JAX package switches to padded-sparse scoring there
SPARSE_PREDICT_THRESHOLD = 36864
SCORE_BLOCK_BYTES = 1 << 30   # bytes of one (users, npad) score block


def densify_model(model: CSR, npad: int | None = None, device=None):
    """Dense (npad, npad) float32 model W on ``device``: the CSR rows are
    densified as runs into the transposed block (M[c, r] = W[r, c]), one
    transpose at the end.  Duplicate (row, col) entries accumulate."""
    dev = resolve_device(device)
    n = max(model.nrows, model.ncols)
    npad = npad if npad is not None else bucket_npad(n)
    M = torch.zeros((npad, npad), dtype=torch.float32, device=dev)
    if model.nnz:
        nr = min(model.nrows, npad)
        rs = np.zeros(npad, np.int64)
        rl = np.zeros(npad, np.int64)
        rs[:nr] = model.indptr[:nr]
        rl[:nr] = np.diff(model.indptr)[:nr]
        idx = model.dev_put("idx32", lambda: model.indices.astype(np.int32),
                            dev)
        val = model.dev_put("val32", lambda: model.values().astype(
            np.float32), dev)
        densify_runs(idx, val, rs, rl, npad, npad, M)
    return M.T.contiguous()


class DeviceModelPack:
    """A model kept on the device as the solver's flat harvest packs
    (``keep_device_model``): ``vals`` / ``idx`` (device) in target-rank
    run order, coordinate ids in RANK space (the solver's frequency
    permutation), with the run table ``run_starts`` / ``run_lens`` and the
    maps ``p_pad`` (rank -> item) and ``posmap_pad`` (item -> rank) on the
    host.  Rank space lets the next warm-started learn over the same
    matrix densify x0 straight from the pack.  :meth:`densify` builds the
    dense (npad, npad) item-space W on the device, equal to
    :func:`densify_model` of the assembled model."""

    def __init__(self, vals, idx, run_starts, run_lens, p_pad, posmap_pad,
                 n, npad):
        self.vals, self.idx = vals, idx
        self.run_starts, self.run_lens = run_starts, run_lens
        self.p_pad, self.posmap_pad = p_pad, posmap_pad
        self.n, self.npad = n, npad
        self._W = None

    @property
    def device(self):
        return self.vals.device

    def densify(self):
        """Dense W (cached until :meth:`free_dense`): the flat rank ids map
        to items once, the runs (one per target rank) densify through the
        densify kernel into M[item, rank] with rank-padding coordinates
        (>= n) dropped, and one column gather by ``posmap_pad`` puts the
        targets in item order."""
        if self._W is None:
            dev = self.device
            p_pad = torch.from_numpy(self.p_pad).to(dev)
            idx_item = p_pad[self.idx.long()].to(torch.int32)
            M = torch.zeros((self.npad, self.npad), dtype=torch.float32,
                            device=dev)
            densify_runs(idx_item, self.vals, self.run_starts, self.run_lens,
                         self.npad, self.n, M)
            del idx_item
            self._W = M.index_select(
                1, torch.from_numpy(self.posmap_pad).to(dev))
        return self._W

    def free_dense(self):
        """Drop the cached dense W and keep the flat pack (model selection
        does this after each evaluation)."""
        self._W = None


def topk_lowest_id(sc, k: int):
    """``torch.topk(sc, k, dim=1)`` with equal scores ordered by the lowest
    index first, as ``lax.top_k`` orders them (torch.topk leaves that order
    unspecified, on the CPU and on the card).  The entries above the k-th
    value are the top-k's own, ordered by (score desc, index asc); the
    remaining slots take the lowest indices whose score equals the k-th."""
    top_sc, top_id = torch.topk(sc, k, dim=1)
    o = torch.argsort(top_id, dim=1)
    top_sc, top_id = top_sc.gather(1, o), top_id.gather(1, o)
    o = torch.sort(top_sc, dim=1, descending=True, stable=True).indices
    top_sc, top_id = top_sc.gather(1, o), top_id.gather(1, o)
    kth = top_sc[:, -1:]
    n = sc.shape[1]
    iota = torch.arange(n, dtype=torch.int32, device=sc.device)
    low = torch.topk(torch.where(sc == kth, iota, n), k, dim=1,
                     largest=False).values          # ascending
    n_gt = (top_sc > kth).sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=sc.device)[None, :]
    tie = low.gather(1, (slot - n_gt).clamp(min=0)).to(top_id.dtype)
    return top_sc, torch.where(slot < n_gt, top_id, tie)


def _user_block(npad: int, user_block: int) -> int:
    """Users per scored block: up to 4x ``user_block``, bounded so one
    score block stays within SCORE_BLOCK_BYTES."""
    fit = max(8, SCORE_BLOCK_BYTES // (npad * 4))
    return max(user_block, min(4 * user_block, 1 << (fit.bit_length() - 1)))


def predict_topn(model: CSR, hist: CSR, nrcmds: int = 10,
                 user_block: int = 1024, W_dev=None, device=None):
    """Top-N for every user row of ``hist``.

    Returns (ids (nusers, nrcmds) int32 with -1 padding, scores (nusers,
    nrcmds) float32, counts (nusers,) int32).  ``W_dev``: a dense device
    model from :func:`densify_model` to reuse across calls, or a
    :class:`DeviceModelPack`."""
    if isinstance(W_dev, DeviceModelPack):
        W_dev = W_dev.densify()
    dev = W_dev.device if W_dev is not None else resolve_device(device)
    pin_f32()
    n = max(model.nrows, model.ncols, hist.ncols)
    npad = bucket_npad(n)
    if npad > SPARSE_PREDICT_THRESHOLD:
        raise NotImplementedError(
            f"npad {npad} > {SPARSE_PREDICT_THRESHOLD}: the padded-sparse "
            "predict path is not ported yet")
    W = W_dev if W_dev is not None else densify_model(model, npad, dev)
    nusers = hist.nrows
    ids = np.full((nusers, nrcmds), -1, np.int32)
    scores = np.zeros((nusers, nrcmds), np.float32)
    counts = np.zeros(nusers, np.int32)
    if nusers == 0:
        return ids, scores, counts

    # users in history-length order so each block's entry width is tight
    row_nnz = hist.row_nnz().astype(np.int64)
    order = np.argsort(-row_nnz, kind="stable")
    ones = hist.data is None
    idx = hist.dev_put("idx32", lambda: hist.indices.astype(np.int32), dev)
    val = None if ones else hist.dev_put(
        "val32", lambda: hist.values().astype(np.float32), dev)
    ub = _user_block(npad, user_block)
    slot = torch.arange(nrcmds, device=dev)
    for u0 in range(0, nusers, ub):
        users = order[u0:u0 + ub]
        rs = hist.indptr[users]
        rl = row_nnz[users]
        hdT = densify_runs(idx, val, rs, rl, npad, n, torch.zeros(
            (npad, len(users)), dtype=torch.float32, device=dev))
        if ones:
            maskT = hdT > 0
        else:
            maskT = densify_runs(idx, None, rs, rl, npad, n, torch.zeros(
                (npad, len(users)), dtype=torch.int8, device=dev)) > 0
        sc = hdT.T @ W                                     # (users, npad)
        sc.masked_fill_(maskT.T, float("-inf"))
        ncand = (sc > 0).sum(dim=1)
        top_sc, top_id = topk_lowest_id(sc, nrcmds)
        cnt = torch.clamp(ncand, max=nrcmds)
        ok = slot[None, :] < cnt[:, None]
        ids[users] = torch.where(ok, top_id, -1).to(torch.int32).cpu().numpy()
        scores[users] = torch.where(ok, top_sc, 0.0).cpu().numpy()
        counts[users] = cnt.to(torch.int32).cpu().numpy()
    return ids, scores, counts
