"""Plain reference for a learned FSLIM model: each column on its own
neighbours, and optimal there.

FSLIM (Ning & Karypis, SLIM, ICDM 2011; upstream ``slim_learn -nnbrs=k
-simtype=cos``, ``src/libslim/neighbors.c``) solves column j's elastic
net only over the ``nnbrs`` items most similar to item j; every other
coefficient of the column stays zero.  With the Gram G = A^T A of the
implicit matrix (float64, exact: the caller works it out again from the
inputs, with ``reference.learn.gram``):

* candidates of j: the items i != j with G_ij > 0;
* ``cos`` similarity: G_ij / sqrt(G_ii G_jj);
* t_j: the ``nnbrs``-th largest similarity among the candidates;
  ``allowed_j`` = {i : sim >= t_j (1 - TIE)}, ``sure_j`` =
  {i : sim > t_j (1 + TIE)}; where j has ``nnbrs`` candidates or fewer,
  every candidate is both;
* a sound model keeps column j inside ``allowed_j`` with at most
  ``nnbrs`` entries, and no coordinate of ``sure_j`` or of the column's
  support moves under the exact CD update
  w_i <- max(0, w_i - g_i / (G_ii + l2)), g = G w - G[:, j] + l2 w + l1
  (``reference.learn``'s step, taken over those coordinates only).

Departures from upstream:

* Ties.  Upstream keeps the first k of ``gk_dfkvkselect``'s order, the
  port the lowest positions in its rank space, which a run's seed
  relabels; the reference names no set and accepts any that ties allow:
  every item above t_j must be in, any item at t_j may be.
* Rounding.  The port ranks by float32 G_ij / sqrt(G_ii) (upstream: the
  dot product over the other item's 2-norm, in float): the same order,
  since sqrt(G_jj) is the same for the whole column, up to rounding; TIE
  (1e-6, some eight float32 roundings) lets a similarity that close to
  t_j fall either way.
* Scale.  Upstream builds each column's similarities from the sparse
  rows; here they come from the dense Gram, a block of columns at a time.

NumPy and PyTorch only: nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

TIE = 1e-6            # relative width of a similarity tie at t_j
COLS_PER_BLOCK = 4096


class Neighbours:
    """Each column's cosine neighbour threshold over the float64 Gram
    ``G`` (on its device), for ``nnbrs`` neighbours."""

    def __init__(self, G: torch.Tensor, nnbrs: int):
        self.G, self.nnbrs, self.n = G, int(nnbrs), G.shape[0]
        self.norms = torch.sqrt(torch.diagonal(G))
        t = torch.empty(self.n, dtype=torch.float64, device=G.device)
        k = min(self.nnbrs, self.n)
        for c0 in range(0, self.n, COLS_PER_BLOCK):
            c1 = min(c0 + COLS_PER_BLOCK, self.n)
            sim = self.similarity(c0, c1)
            kth = torch.topk(sim, k, dim=0).values[-1]
            many = torch.isfinite(sim).sum(dim=0) > self.nnbrs
            t[c0:c1] = torch.where(many, kth, float("-inf"))
        self.t = t

    def similarity(self, c0: int, c1: int) -> torch.Tensor:
        """(n, c1 - c0): sim(i, j) of the candidates i of columns j in
        [c0, c1), -inf elsewhere."""
        g = self.G[:, c0:c1]
        sim = g / (self.norms[:, None] * self.norms[None, c0:c1])
        cand = g > 0
        j = torch.arange(c1 - c0, device=g.device)
        cand[c0 + j, j] = False
        return torch.where(cand, sim, float("-inf"))

    def sets(self, c0: int, c1: int):
        """(allowed, sure), (n, c1 - c0) bool, of columns [c0, c1)."""
        sim = self.similarity(c0, c1)
        t = self.t[c0:c1][None, :]
        cand = torch.isfinite(sim)
        return cand & (sim >= t * (1 - TIE)), cand & (sim > t * (1 + TIE))


def _dense_cols(entries, c0: int, c1: int, n: int, dev):
    """Columns [c0, c1) of the model as a dense (n, c1 - c0) float64
    block."""
    r, c, v = entries
    sel = (c >= c0) & (c < c1)
    W = torch.zeros((n, c1 - c0), dtype=torch.float64, device=dev)
    W.index_put_((r[sel], c[sel] - c0), v[sel], accumulate=True)
    return W


def bad_entries(nb: Neighbours, entries) -> int:
    """Entries outside their column's ``allowed`` set, and columns with
    more than ``nnbrs`` entries (each counted once).  Entries outside
    n x n are left to ``reference.learn.bad_entries``."""
    r, c, _ = entries
    inside = (r >= 0) & (r < nb.n) & (c >= 0) & (c < nb.n)
    r, c = r[inside], c[inside]
    bad = 0
    for c0 in range(0, nb.n, COLS_PER_BLOCK):
        c1 = min(c0 + COLS_PER_BLOCK, nb.n)
        sel = (c >= c0) & (c < c1)
        allowed, _ = nb.sets(c0, c1)
        bad += int((~allowed[r[sel], c[sel] - c0]).sum())
    per_col = torch.bincount(c, minlength=nb.n)
    return bad + int((per_col > nb.nnbrs).sum())


def _steps(nb: Neighbours, entries, l1: float, l2: float, product=None):
    """Per block of columns [c0, c0 + k): (c0, W, the stepped W), the
    exact CD update taken once from W of the coordinates FSLIM solves
    (``sure`` or the support), the others left as they are.
    ``product(W)``, when given, is G W in another precision; else
    float64."""
    G, n = nb.G, nb.n
    d = torch.diagonal(G)
    for c0 in range(0, n, COLS_PER_BLOCK):
        c1 = min(c0 + COLS_PER_BLOCK, n)
        W = _dense_cols(entries, c0, c1, n, G.device)
        gw = G @ W if product is None else product(W)
        g = gw - G[:, c0:c1] + l2 * W + l1
        new = (W - g / (d + l2)[:, None]).clamp_min_(0.0)
        _, sure = nb.sets(c0, c1)
        yield c0, W, torch.where(sure | (W != 0), new, W)


def step_norms(nb: Neighbours, entries, l1: float, l2: float) -> np.ndarray:
    """Each column's CD step length over its ``sure`` set and its support,
    ||w_new - w||_2 (float64)."""
    out = np.empty(nb.n)
    for c0, W, new in _steps(nb, entries, l1, l2):
        out[c0:c0 + W.shape[1]] = torch.linalg.vector_norm(
            new - W, dim=0).cpu().numpy()
    return out


def stepped_model(nb: Neighbours, entries, l1: float, l2: float, product):
    """The model after one exact CD update of each column's ``sure`` and
    support coordinates with G W from ``product`` (the control's lower
    precision): (indptr, indices, data), rows = rated item."""
    n = nb.n
    keys, vals = [], []
    for c0, _, new in _steps(nb, entries, l1, l2, product):
        r, c = new.nonzero(as_tuple=True)
        keys.append(r * n + c + c0)
        vals.append(new[r, c].float())
    key, o = torch.sort(torch.cat(keys))
    v = torch.cat(vals)[o].cpu().numpy()
    r = (key // n).cpu().numpy()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return indptr, (key % n).to(torch.int32).cpu().numpy(), v
