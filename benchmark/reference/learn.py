"""Plain reference for a learned SLIM model: the optimality of every column.

Column j of a SLIM model solves the elastic-net nonnegative least squares

    min_w  1/2 ||a_j - A w||^2 + l2/2 ||w||^2 + l1 sum(w),  w >= 0, w_j = 0,

whose gradient is g = G w - G[:, j] + l2 w + l1 with the Gram G = A^T A.
The exact coordinate-descent update of coordinate i is
w_i <- max(0, w_i - g_i / (G_ii + l2)).  At the optimum no coordinate
moves, so the length of that step over a column measures how far the
column is from its solution, in the units of the solver's own stopping
rule (a sweep's sum of squared changes below optTol).

Everything here is worked out again from the ratings matrix: the Gram in
float64 from the matrix's rows, each model column densified from the
model's entries.  NumPy and PyTorch only.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS_PER_BLOCK = 8192
COLS_PER_BLOCK = 4096


def gram(indptr, indices, ncols: int, dev) -> torch.Tensor:
    """G = A^T A (float64, on ``dev``) of the implicit (0/1) matrix whose
    rows are ``indptr`` / ``indices``, a block of rows at a time.  On the
    card a block's product takes bfloat16 operands with float32 sums,
    which is exact here: every product is 0 or 1 and every sum an integer
    no larger than the block's rows (< 2^24); elsewhere float64."""
    nrows = len(indptr) - 1
    cuda = torch.device(dev).type == "cuda"
    dt = torch.bfloat16 if cuda else torch.float64
    G = torch.zeros((ncols, ncols), dtype=torch.float64, device=dev)
    for r0 in range(0, nrows, ROWS_PER_BLOCK):
        r1 = min(r0 + ROWS_PER_BLOCK, nrows)
        a, b = int(indptr[r0]), int(indptr[r1])
        rows = np.repeat(np.arange(r1 - r0), np.diff(indptr[r0:r1 + 1]))
        blk = torch.zeros((r1 - r0, ncols), dtype=dt, device=dev)
        blk[torch.from_numpy(rows).to(dev),
            torch.from_numpy(indices[a:b].astype(np.int64)).to(dev)] = 1.0
        G += torch.mm(blk.T, blk, out_dtype=torch.float32) if cuda \
            else blk.T @ blk
    return G


def model_entries(indptr, indices, data, dev):
    """(row, column, value) of a CSR model on ``dev`` (int64, int64,
    float64)."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return (torch.from_numpy(rows).to(dev),
            torch.from_numpy(indices.astype(np.int64)).to(dev),
            torch.from_numpy(data.astype(np.float64)).to(dev))


def bad_entries(indptr, indices, data, n: int) -> int:
    """Entries that no SLIM model holds: outside n x n, on the diagonal,
    not above zero or not finite, or a repeated (row, column)."""
    if len(indptr) != n + 1:
        return max(int(indptr[-1]), 1)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    bad = (indices < 0) | (indices >= n) | (indices == rows) \
        | ~np.isfinite(data) | ~(data > 0)
    key = rows.astype(np.int64) * n + indices
    if not (key[1:] > key[:-1]).all():     # ids not ascending: sort first
        key = np.sort(key)
    repeats = int((key[1:] == key[:-1]).sum())
    return int(bad.sum()) + repeats


def _dense_cols(entries, c0: int, c1: int, n: int, dev):
    """Columns [c0, c1) of the model as a dense (n, c1 - c0) float64
    block."""
    r, c, v = entries
    sel = (c >= c0) & (c < c1)
    W = torch.zeros((n, c1 - c0), dtype=torch.float64, device=dev)
    W.index_put_((r[sel], c[sel] - c0), v[sel], accumulate=True)
    return W


def coordinate_steps(G, W, c0: int, l1: float, l2: float, gw=None):
    """The exact CD update of every coordinate of columns [c0, c0 + k) of
    W (n, k), all from W: (new W, the step).  ``gw``, when given, is G W
    (another precision's); else it is taken in float64."""
    n, k = W.shape
    d = torch.diagonal(G)
    g = (G @ W if gw is None else gw) - G[:, c0:c0 + k] + l2 * W + l1
    new = (W - g / (d + l2)[:, None]).clamp_min_(0.0)
    j = torch.arange(k, device=W.device)
    new[c0 + j, j] = 0.0
    return new, new - W


def step_norms(G, entries, n: int, l1: float, l2: float) -> np.ndarray:
    """Each model column's CD step length ||w_new - w||_2 (float64)."""
    out = np.empty(n)
    dev = G.device
    for c0 in range(0, n, COLS_PER_BLOCK):
        c1 = min(c0 + COLS_PER_BLOCK, n)
        W = _dense_cols(entries, c0, c1, n, dev)
        _, step = coordinate_steps(G, W, c0, l1, l2)
        out[c0:c1] = torch.linalg.vector_norm(step, dim=0).cpu().numpy()
    return out


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even),
    as the tensor cores read a TF32 operand."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def tf32_step_model(G, entries, n: int, l1: float, l2: float):
    """The control: the exact CD update of every coordinate taken once
    from the given model with G W computed in TF32 (operands rounded to
    TF32, float32 sums), as a solver whose products ran in TF32 would
    leave it.  Returns the stepped model as (indptr, indices, data)."""
    dev = G.device
    Gt = to_tf32(G)
    keys, vals = [], []
    for c0 in range(0, n, COLS_PER_BLOCK):
        c1 = min(c0 + COLS_PER_BLOCK, n)
        W = _dense_cols(entries, c0, c1, n, dev)
        gw = (Gt @ to_tf32(W)).double()
        new, _ = coordinate_steps(G, W, c0, l1, l2, gw=gw)
        r, c = new.nonzero(as_tuple=True)
        keys.append(r * n + c + c0)
        vals.append(new[r, c].float())
    key, o = torch.sort(torch.cat(keys))
    v = torch.cat(vals)[o].cpu().numpy()
    r = (key // n).cpu().numpy()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return indptr, (key % n).to(torch.int32).cpu().numpy(), v
