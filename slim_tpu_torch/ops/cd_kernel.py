"""Batched coordinate-descent block solve (port of slim_tpu/ops/cd_kernel.py).

A block of B item columns is solved together against the shared Gram
G = AᵀA: ``aTy -> G[:, j]``, ``aᵢᵀ yhat -> q[i] - G[i,i]·x[i]`` with
``q = G x`` kept incrementally, and the nonnegative soft-threshold
``x_i = max(num - l1r, 0) / (G[i,i] + l2r)`` of cd.c:125-128.  Per column,
Σ(Δx)² < optTol stops the sweeps (cd.c:135-138), capped at
min(50·nnz_j, maxniters) sweeps (estimate.c:448-449).

:func:`_cd_core` is the plain-PyTorch solve: the CPU path of the solver and
the oracle the sweep kernels (ops/cd_sweep.py) are held against.  The
screen helpers build the union active sets of the compact path;
:func:`fslim_active_mask` replaces the screen for FSLIM.
"""

from __future__ import annotations

import torch

from ..utils import span, topk_lowest_id
from .gather import gather
from .gram import panel_rows
from .pack import pack_plain as pack_flat  # noqa: F401  (the pack contract)

CHUNK = 128  # coordinates per Gauss-Seidel chunk


def per_col(v, B, device):
    """Scalar or (B,) regularisation -> (B,) float32 tensor."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return t.expand(B) if t.numel() == 1 else t


def screen(gj, j_ids, l1v, col_ids=None):
    """Active set of the screening path (estimate.c:412-421): G[i,j] > l1r,
    i != j.  ``col_ids`` maps positions to coordinates in compact space."""
    B, width = gj.shape
    ids = col_ids if col_ids is not None else \
        torch.arange(width, device=gj.device, dtype=j_ids.dtype)
    return (gj > l1v[:, None]) & (ids[None, :] != j_ids[:, None])


def fslim_active_mask(gj, diag, self_ids, n_valid, nnbrs, simtype,
                      col_ids=None, self_norms=None):
    """FSLIM neighbour selection from Gram columns (neighbors.c:16-125):
    candidates are co-rated with the target (gj > 0), not the target
    itself and below ``n_valid``; similarity ``dotp`` = aᵀb, ``cos`` =
    aᵀb/‖b‖ (the target's own norm is constant per column), ``jac`` =
    aᵀb/(‖b‖+‖a‖-aᵀb) with 2-norms.  The top ``nnbrs`` finite similarities
    form the active set, equal values taken at the lowest position first
    (``lax.top_k``'s order; binary data ties often at the k-th slot).

    ``col_ids`` (width,) maps positions to coordinates in a compact space
    whose ids ascend with the position, so the lowest position is the
    lowest id there too; ``self_norms`` (B,) gives ‖a_j‖ when ``diag`` is
    compacted (jac only)."""
    B, width = gj.shape
    cnorms = torch.sqrt(diag)
    ids = col_ids if col_ids is not None else \
        torch.arange(width, device=gj.device, dtype=self_ids.dtype)
    cand = (gj > 0) & (ids[None, :] != self_ids[:, None]) \
        & (ids[None, :] < n_valid)
    if simtype == "dotp":
        sim = gj
    elif simtype == "cos":
        sim = gj / torch.clamp(cnorms, min=1e-30)[None, :]
    elif simtype == "jac":
        selfn = self_norms if self_norms is not None else \
            cnorms[self_ids.long().clamp(0, width - 1)]
        denom = cnorms[None, :] + selfn[:, None] - gj
        sim = gj / torch.where(denom.abs() > 1e-30, denom, 1e-30)
    else:
        raise ValueError(f"unknown simtype {simtype!r}")
    sim = torch.where(cand, sim, float("-inf"))
    vals, top = topk_lowest_id(sim, max(1, min(int(nnbrs), width)))
    return torch.zeros((B, width), dtype=torch.bool, device=gj.device) \
        .scatter_(1, top, torch.isfinite(vals))


def count_over(x, eps):
    """Per-column model nnz: count of entries > eps (slim.h:61)."""
    return (x > eps).sum(dim=1, dtype=torch.int32)


def block_union_flags(G, nblocks, B, l1r):
    """u (nblocks, npad) bool: coordinate i is active for some column of
    block b (columns [b*B, (b+1)*B), self excluded), G's rows taken a
    horizontal panel (``ops.gram.panel_rows``) at a time: a panel's
    (rows, nblocks x B) mask G > l1r, its diagonal cleared, reduced by
    ``any`` over each block's columns.  No mask as large as G is made (at
    npad 94,208 the whole one is 8.7 GB, and a sum over it in int64
    64.7 GiB)."""
    npad = G.shape[0]
    total = nblocks * B
    width = min(total, npad)
    step = panel_rows(npad)
    u = torch.empty((npad, nblocks), dtype=torch.bool, device=G.device)
    for r0 in range(0, npad, step):
        r1 = min(r0 + step, npad)
        over = torch.zeros((r1 - r0, total), dtype=torch.bool,
                           device=G.device)
        torch.gt(G[r0:r1, :width], l1r, out=over[:, :width])
        d = torch.arange(r0, max(r0, min(r1, width)), device=G.device)
        over[d - r0, d] = False                       # self excluded
        torch.any(over.view(r1 - r0, nblocks, B), dim=2, out=u[r0:r1])
    return u.T


def compact_union_ids(u):
    """(ids (nblocks, npad) int32, counts (nblocks,) int32): block b's
    flagged coordinates ascending, padded with npad-1 (the zero row/col)."""
    npad = u.shape[1]
    iota = torch.arange(npad, dtype=torch.int32, device=u.device)
    keys = torch.where(u, iota[None, :], torch.tensor(1 << 30, dtype=torch.int32,
                                                      device=u.device))
    ids = torch.minimum(torch.sort(keys, dim=1).values,
                        torch.tensor(npad - 1, dtype=torch.int32,
                                     device=u.device))
    return ids, u.sum(dim=1, dtype=torch.int32)


def block_union_mask(G, j_ids, l1r, K, fslim_nnbrs=0, simtype="cos"):
    """Union active set of one block: (S (K,) ascending ids padded with
    npad-1, true union count, the block's active entries summed over its
    columns: its FSLIM neighbours).  With ``fslim_nnbrs`` > 0 the union of
    the columns' FSLIM neighbour sets: restricting each column's top-k to
    it is exact, since every column's own top-k lies inside.  The host
    waits for the two counts, fetched in one copy (a ``slim.wait.select``
    span, or ``slim.wait.screen`` for the screen's union)."""
    npad = G.shape[0]
    gj = G[:, j_ids.long()].T.contiguous()
    B = gj.shape[0]
    if fslim_nnbrs > 0:
        active = fslim_active_mask(gj, torch.diagonal(G), j_ids, npad,
                                   fslim_nnbrs, simtype)
    else:
        active = screen(gj, j_ids, per_col(l1r, B, G.device))
    u = active.any(dim=0)
    wait = "slim.wait.select" if fslim_nnbrs > 0 else "slim.wait.screen"
    with span(wait):
        count, nbrs = torch.stack([u.sum(), active.sum()]).tolist()
    cols = torch.arange(npad, device=G.device, dtype=j_ids.dtype)
    key = torch.where(u, cols, cols + npad)
    order = torch.argsort(key)[:K]
    pos = torch.arange(K, device=G.device)
    S = torch.where(pos < count, order.to(j_ids.dtype), npad - 1)
    return S, count, nbrs


def _solve(impl, G, gj, diag, active, x0, caps, yty, l1v, l2v, optTol, gen,
           shuffle, x0_zero, variant):
    """``impl`` "sweep_large" runs the wide-block sweep ``variant`` ("v4",
    "v3" or "eager", see cd_sweep.pick_large_variant)."""
    if impl == "plain":
        return _cd_core(G, gj, diag, active, x0, caps, yty, l1v, l2v,
                        optTol, gen, shuffle)
    from .cd_sweep import solve_core, solve_large_core, solve_panel_core

    args = (G, gj, diag, active, x0, caps, yty, l1v, l2v, optTol, gen,
            shuffle)
    if impl == "sweep":
        return solve_core(*args)
    if impl == "sweep_large" and variant == "v4":
        return solve_large_core(*args, x0_zero=x0_zero)
    if impl == "sweep_large":
        return solve_panel_core(*args, x0_zero=x0_zero, variant=variant)
    raise ValueError(f"unknown block-solve impl {impl!r}")


def cd_solve_block_ids(G, j_ids, caps, x0, l1r, l2r, optTol, gen,
                       shuffle=True, impl="plain", x0_zero=False,
                       variant="v4", n_valid=None, fslim_nnbrs=0,
                       simtype="cos"):
    """Solve the B columns ``j_ids`` over the full coordinate space
    (padded entries point at the zero column npad-1 with cap 0).  With
    ``fslim_nnbrs`` > 0 the active sets are the columns' FSLIM neighbours
    among the first ``n_valid`` coordinates (default: all)."""
    B = j_ids.shape[0]
    diag = torch.diagonal(G)
    gj = G[:, j_ids.long()].T.contiguous()                  # (B, npad)
    l1v, l2v = per_col(l1r, B, G.device), per_col(l2r, B, G.device)
    if fslim_nnbrs > 0:
        active = fslim_active_mask(
            gj, diag, j_ids, G.shape[0] if n_valid is None else n_valid,
            fslim_nnbrs, simtype)
    else:
        active = screen(gj, j_ids, l1v)
    yty = diag[j_ids.long()]
    return _solve(impl, G, gj, diag, active, x0, caps, yty, l1v, l2v,
                  optTol, gen, shuffle, x0_zero, variant)


def gather_compact(G, S, j_ids):
    """A compact block's pieces from the full G, each in one pass
    (ops/gather.py, no (K, npad) intermediate), as :func:`cd_solve_compact`
    takes them: Gs = G[S, S] (K, K), the targets' rows gjs (B, K), read as
    G[S, j] (the solver's column j), and yty = G[j, j] (B,).  The block is
    exact in the compact space S: coordinates outside S are inactive for
    every column of the block (for FSLIM, S is the union of the columns'
    neighbour sets)."""
    S32, J32 = S.to(torch.int32), j_ids.to(torch.int32)
    return (gather(G, S32, S32), gather(G, J32, S32, trans=True),
            torch.diagonal(G)[j_ids.long()])


def cd_solve_compact(Gs, S, npad, j_ids, gjs, yty, caps, x0s, l1r, l2r,
                     optTol, gen, shuffle=True, impl="plain", x0_zero=False,
                     variant="v4", fslim_nnbrs=0, simtype="cos"):
    """The compact solve from its pieces: Gs = G[S, S] (K, K), the
    targets' rows gjs = G[j, S] (B, K) and yty = G[j, j] (B,).  S holds
    coordinate ids below ``npad``, ascending, padded with npad - 1 (never
    active).  The distributed learns build the pieces from sharded data."""
    B = j_ids.shape[0]
    l1v, l2v = per_col(l1r, B, Gs.device), per_col(l2r, B, Gs.device)
    diag_s = torch.diagonal(Gs)
    if fslim_nnbrs > 0:
        active = fslim_active_mask(gjs, diag_s, j_ids, npad, fslim_nnbrs,
                                   simtype, col_ids=S,
                                   self_norms=torch.sqrt(yty))
    else:
        active = screen(gjs, j_ids, l1v, col_ids=S)
    active &= (S != npad - 1)[None, :]
    return _solve(impl, Gs, gjs, diag_s, active, x0s, caps, yty, l1v, l2v,
                  optTol, gen, shuffle, x0_zero, variant)


def block_stats(x, q, gj, yty, l1v, l2v):
    """½||y - Ax||² = ½(yᵀy - 2xᵀ(Aᵀy) + xᵀGx) and the full objective
    per column (estimate.c:477-489), from q = Gx."""
    rnorm = 0.5 * (yty - 2.0 * (x * gj).sum(1) + (x * q).sum(1))
    obj = rnorm + 0.5 * l2v * (x * x).sum(1) + l1v * x.abs().sum(1)
    return rnorm, obj


def _cd_core(G, gj, diag, active, x0, col_maxniters, yty, l1r, l2r, optTol,
             gen, shuffle=True):
    """Solve B columns against shared G (plain PyTorch).

    G (n, n), gj (B, n), diag (n,), active (B, n) bool, x0 (B, n),
    col_maxniters (B,) int, yty (B,); l1r/l2r scalar or (B,); ``gen`` a
    torch.Generator for the visit order: a shuffled chunk order and a
    shuffled order within chunks per sweep (cd.c:115 shuffles the active
    list; any decorrelated order reaches the same optimum).

    Returns (x, niters, converged, rnorm, obj) per column.
    """
    B, n = gj.shape
    dev = gj.device
    assert n % CHUNK == 0, "pad the coordinate dimension to a CHUNK multiple"
    l1v, l2v = per_col(l1r, B, dev), per_col(l2r, B, dev)
    caps = col_maxniters.to(dev)
    x = torch.where(active, x0, 0.0)
    any_act = active.any(dim=1)
    tmax = int(torch.where(any_act, caps, 0).max()) if B else 0
    nchunks = n // CHUNK
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    niters = torch.zeros(B, dtype=torch.int32, device=dev)
    t = 0
    while t < tmax:
        live = (~converged) & (t < caps)
        if not bool(live.any()):
            break
        q = x @ G                                  # exact q at sweep start
        if shuffle:
            chunk_perm = torch.randperm(nchunks, generator=gen).tolist()
            inner = torch.randperm(CHUNK, generator=gen).tolist()
        else:
            chunk_perm, inner = range(nchunks), range(CHUNK)
        dltx = torch.zeros(B, dtype=torch.float32, device=dev)
        for cc in chunk_perm:
            sl = slice(cc * CHUNK, (cc + 1) * CHUNK)
            a_loc = active[:, sl]
            if not bool((a_loc & live[:, None]).any()):
                continue
            Gloc = G[sl]
            Gcc = Gloc[:, sl]
            gj_loc, d_loc = gj[:, sl], diag[sl]
            x_old = x[:, sl].clone()
            x_loc, q_loc = x_old.clone(), q[:, sl].clone()
            for i in inner:
                xi = x_loc[:, i]
                num = gj_loc[:, i] - q_loc[:, i] + d_loc[i] * xi
                cand = torch.where(num > l1v, (num - l1v) / (d_loc[i] + l2v),
                                   0.0)
                newx = torch.where(a_loc[:, i] & live, cand, xi)
                q_loc += (newx - xi)[:, None] * Gcc[i][None, :]
                x_loc[:, i] = newx
            dx = x_loc - x_old
            q = q + dx @ Gloc
            x[:, sl] = x_loc
            dltx += (dx * dx).sum(dim=1)
        converged |= live & (dltx < optTol)
        niters += live.to(torch.int32)
        t += 1
    q = x @ G
    rnorm, obj = block_stats(x, q, gj, yty, l1v, l2v)
    return x, niters, converged, rnorm, obj
