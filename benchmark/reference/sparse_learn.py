"""Plain reference for a learned SLIM model whose dense Gram the reference
cannot hold: the optimality of every column, from the sparse ratings
matrix, a block of columns at a time.

The check is ``reference/learn.py``'s: column j of a SLIM model solves the
elastic-net nonnegative least squares with gradient g = G w - G[:, j] +
l2 w + l1, G = A^T A, and the exact coordinate-descent update of each
coordinate is w_i <- max(0, w_i - g_i / (G_ii + l2)); the length of that
step over a column measures how far the column is from its solution.
That module holds G dense in float64, n^2 x 8 bytes (67 GB at 91,599
items), and multiplies it by each dense model block.  Here no n x n array
is made: for each block J of model columns

    G[:, J]   = A^T (A[:, J])       (once per block, for every model)
    (G W)[:, J] = A^T (A W[:, J])

in float64 from A as sparse CSR tensors (A and A^T), and G_ii is the
column's count of ratings.  Every column of every model is stepped; none
is sampled.  NumPy and PyTorch only.
"""

from __future__ import annotations

import numpy as np
import torch

COLS_PER_BLOCK = 4096


def _csr(indptr, indices, shape, dev):
    """A float64 sparse CSR tensor of ones on ``dev``."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(indptr, np.int64)),
        torch.from_numpy(np.asarray(indices, np.int64)),
        torch.ones(len(indices), dtype=torch.float64), size=shape,
        check_invariants=False).to(dev)


class Ratings:
    """The implicit (0/1) ratings matrix A (users x items) of ``indptr`` /
    ``indices`` on ``dev``: A and A^T as float64 sparse CSR tensors, and
    G's diagonal (each item's count of ratings)."""

    def __init__(self, indptr, indices, ncols: int, dev):
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        nrows = len(indptr) - 1
        self.n, self.dev = ncols, torch.device(dev)
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        self.A = _csr(indptr, indices, (nrows, ncols), dev)
        order = np.argsort(indices, kind="stable")
        counts = np.bincount(indices, minlength=ncols)
        tptr = np.zeros(ncols + 1, np.int64)
        np.cumsum(counts, out=tptr[1:])
        self.At = _csr(tptr, rows[order], (ncols, nrows), dev)
        self.tptr, self.trows = tptr, rows[order]
        self.diag = torch.from_numpy(counts.astype(np.float64)).to(dev)

    def columns(self, c0: int, c1: int) -> torch.Tensor:
        """G[:, c0:c1] = A^T A[:, c0:c1], float64 (n, c1 - c0)."""
        a, b = int(self.tptr[c0]), int(self.tptr[c1])
        cols = np.repeat(np.arange(c1 - c0), np.diff(self.tptr[c0:c1 + 1]))
        AJ = torch.zeros((self.A.shape[0], c1 - c0), dtype=torch.float64,
                         device=self.dev)
        AJ[torch.from_numpy(self.trows[a:b]).to(self.dev),
           torch.from_numpy(cols).to(self.dev)] = 1.0
        return self.At @ AJ

    def times(self, X: torch.Tensor) -> torch.Tensor:
        """G X = A^T (A X) for a dense float64 (n, k) X."""
        return self.At @ (self.A @ X)


def model_entries(indptr, indices, data, dev):
    """(row, column, value) of a CSR model on ``dev`` (int64, int64,
    float64), sorted by column."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    o = np.argsort(indices, kind="stable")
    return (torch.from_numpy(rows[o]).to(dev),
            torch.from_numpy(np.asarray(indices)[o].astype(np.int64)).to(dev),
            torch.from_numpy(np.asarray(data)[o].astype(np.float64)).to(dev))


def dense_cols(entries, c0: int, c1: int, n: int, dtype=torch.float64):
    """Columns [c0, c1) of the model (entries sorted by column) as a dense
    (n, c1 - c0) block."""
    r, c, v = entries
    lo, hi = torch.searchsorted(c, torch.tensor([c0, c1], device=c.device))
    lo, hi = int(lo), int(hi)
    W = torch.zeros((n, c1 - c0), dtype=dtype, device=c.device)
    W.index_put_((r[lo:hi], c[lo:hi] - c0), v[lo:hi].to(dtype),
                 accumulate=True)
    return W


def coordinate_steps(GJ, GW, diag, W, c0: int, l1: float, l2: float):
    """The exact CD update of every coordinate of the model columns [c0,
    c0 + k), all from W (n, k): (new W, the step); GJ = G[:, c0:c0 + k]
    and GW = (G W)[:, c0:c0 + k]."""
    k = W.shape[1]
    g = GW - GJ + l2 * W + l1
    new = (W - g / (diag + l2)[:, None]).clamp_min_(0.0)
    j = torch.arange(k, device=W.device)
    new[c0 + j, j] = 0.0
    return new, new - W


def blocks(n: int, cols: int = COLS_PER_BLOCK):
    return [(c0, min(c0 + cols, n)) for c0 in range(0, n, cols)]


def step_norms(R: Ratings, models, l1: float, l2: float,
               cols: int = COLS_PER_BLOCK) -> list:
    """Each model's CD step length ||w_new - w||_2 of every column
    (float64 arrays), ``models`` as :func:`model_entries`."""
    n = R.n
    out = [np.empty(n) for _ in models]
    for c0, c1 in blocks(n, cols):
        GJ = R.columns(c0, c1)
        for ent, o in zip(models, out):
            W = dense_cols(ent, c0, c1, n)
            _, step = coordinate_steps(GJ, R.times(W), R.diag, W, c0, l1, l2)
            o[c0:c1] = torch.linalg.vector_norm(step, dim=0).cpu().numpy()
    return out


def dense_gram_f32(R: Ratings) -> torch.Tensor:
    """G as one (n, n) float32 tensor on R's device, a block of columns at
    a time (exact: the counts are integers below 2^24)."""
    G = torch.empty((R.n, R.n), dtype=torch.float32, device=R.dev)
    for c0, c1 in blocks(R.n):
        G[:, c0:c1] = R.columns(c0, c1)
    return G


def round_tf32_(x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """A contiguous float32 ``x`` rounded to TF32 (10 mantissa bits, to
    nearest even) in place, as the tensor cores read a TF32 operand; a
    block of rows at a time, so no temporary as large as x is made."""
    b = x.view(torch.int32)
    for r0 in range(0, x.shape[0], rows):
        blk = b[r0:r0 + rows]
        blk.copy_((blk + 0x0FFF + ((blk >> 13) & 1)) & ~0x1FFF)
    return x


def tf32_step_model(R: Ratings, Gt, entries, l1: float, l2: float):
    """The control: the exact CD update of every coordinate taken once
    from the model ``entries`` with G W computed from TF32 operands (Gt,
    G rounded to TF32 by :func:`round_tf32_`, and W rounded likewise)
    with float32 sums, as a solver whose products ran in TF32 would leave
    it; G[:, J] and the diagonal exact.  Returns the stepped model as
    host (indptr, indices, data)."""
    n = R.n
    keys, vals = [], []
    for c0, c1 in blocks(n):
        W = dense_cols(entries, c0, c1, n)
        Wt = round_tf32_(W.float().contiguous())
        new, _ = coordinate_steps(R.columns(c0, c1), (Gt @ Wt).double(),
                                  R.diag, W, c0, l1, l2)
        r, c = new.nonzero(as_tuple=True)
        keys.append(r * n + c + c0)
        vals.append(new[r, c].float())
    key, o = torch.sort(torch.cat(keys))
    v = torch.cat(vals)[o].cpu().numpy()
    r = (key // n).cpu().numpy()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return indptr, (key % n).to(torch.int32).cpu().numpy(), v
