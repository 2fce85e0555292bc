"""Distributed learning and prediction over a (dp, mp) device mesh (port of
slim_tpu/parallel/dist.py), one process per device.

* The rating matrix is row(user)-sharded: rank r takes the r-th range of
  rows in units of ``row_block`` rows and computes a partial Gram with the
  port's densify kernel and contraction (``ops.gram.gram_partial``:
  int8 -> int32 for binary data, so the sum is exact); one all-reduce
  gives G on every rank.
* Item columns are sharded over the flattened grid: rank r solves its own
  columns with the port's block solves (on the card, the sweep kernels),
  harvests them through the pack kernel, and the entries and column stats
  are all-gathered, so every rank assembles and returns the same model.

Three learn modes, as in the JAX package:

* :func:`distributed_learn` -- G replicated; the single-device driver
  (``solvers.cd.estimate_model_cd``) solves the column blocks b with
  b % world == rank;
* :func:`distributed_learn_blockwise` -- G never exists: per superblock of
  world * block_size columns a memory-bounded screen (column chunks of one
  (npad, chunk) buffer) gives the union S, and the compact Gram G[S, S] is
  all-reduced from every rank's rows densified through S;
* :func:`distributed_learn_sharded_g` -- G column-sharded and resident;
  each superblock's flags and G[S, S] are gathered from it.

:func:`sharded_predict` serves users sharded over the ranks.  Collectives
go through :mod:`.comm` (NCCL on the card, host-staged gloo otherwise);
every rank runs the same loop, so they are issued in the same order
everywhere.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cd_kernel import cd_solve_block_ids, cd_solve_compact
from ..ops.cd_kernel import fslim_active_mask
from ..ops.cd_sweep import pick_large_variant
from ..ops.densify import densify_runs
from ..ops.gram import _is_binary, gram_partial, pin_f32
from ..predict import _steps
from ..solvers.cd import (_Block, _Checkpoint, _Held, _assemble, _harvest,
                          bucket_npad, estimate_grid_cd, estimate_model_cd,
                          pick_impl)
from ..types import CSR
from . import comm
from .mesh import mesh_device

logger = logging.getLogger("slim_tpu_torch")

# floats of one screen step's (entries, chunk) gather (256 MB)
SCREEN_STEP_FLOATS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _screen_bytes() -> int:
    """SLIM_SCREEN_BYTES, read at call time: the byte budget of the
    screen's (npad, chunk) buffer (default 2 GiB)."""
    return int(os.environ.get("SLIM_SCREEN_BYTES", 1 << 31))


def _where(mesh):
    """(device, world size, rank, dp index, mp index) of this rank."""
    dpi, mpi = mesh.get_coordinate()
    return (mesh_device(mesh), dist.get_world_size(), dist.get_rank(),
            int(dpi), int(mpi))


def _row_shard(train: CSR, ndev: int, rank: int, row_block: int,
               posmap=None) -> CSR:
    """Rank ``rank``'s rows: the r-th of ``ndev`` equal ranges, each a
    whole number of ``row_block`` rows (``_rank_triplets`` of the JAX
    package), with the column ids mapped through ``posmap`` when given."""
    nrows = train.nrows
    per = _round_up(max(-(-nrows // ndev), 1), row_block)
    r0, r1 = min(rank * per, nrows), min((rank + 1) * per, nrows)
    s, e = int(train.indptr[r0]), int(train.indptr[r1])
    idx = train.indices[s:e]
    return CSR.from_arrays(
        r1 - r0, train.ncols, train.indptr[r0:r1 + 1] - s,
        idx if posmap is None else posmap[idx],
        None if train.data is None else train.data[s:e])


def _reduced_gram(part: CSR, n: int, dev, binary: bool, **kw):
    """The rank's partial Gram (``gram_partial`` with ``kw``) in the
    world's accumulator type (int32 when the whole matrix is binary: a
    rank's rows may look binary when the matrix is not), all-reduced."""
    acc = gram_partial(part, n, dev, **kw)
    acc = acc.to(torch.int32 if binary else torch.float32)
    return comm.all_reduce(acc).to(torch.float32)


# --------------------------------------------------------------------- #
# sharded Gram
# --------------------------------------------------------------------- #
def sharded_gram_sparse(train: CSR, mesh, pad_to: int,
                        row_block: int = 4096):
    """G padded to ``pad_to`` (rounded up to 128), replicated on every
    rank: each rank's partial Gram of its row shard, all-reduced over the
    whole grid."""
    pin_f32()
    dev, ndev, rank, _, _ = _where(mesh)
    part = _row_shard(train, ndev, rank, row_block)
    return _reduced_gram(part, _round_up(max(pad_to, 1), 128), dev,
                         _is_binary(train.values()))


# --------------------------------------------------------------------- #
# one fused learn step (the multichip dry run's graph)
# --------------------------------------------------------------------- #
def sharded_learn_step(mesh, l1r=1.0, l2r=1.0, optTol=1e-7, shuffle=True):
    """A single SPMD training step: a partial dense Gram per dp row shard,
    all-reduced over the ``dp`` group, then the column-block CD solve.

    Returns ``step(a, j_ids, caps, seed)``: every rank passes the whole
    dense (rows, npad) ``a`` (rows split over dp), the S target columns
    and their sweep caps (split over the flattened grid) and a seed.  It
    returns (x_all (S, npad) float32, summed fit, summed objective) on
    the host, the same on every rank."""

    def step(a, j_ids, caps, seed):
        pin_f32()
        dev, ndev, rank, dpi, mpi = _where(mesh)
        dp = mesh.shape[0]
        a = torch.as_tensor(np.asarray(a, np.float32))
        rows = a.shape[0] // dp
        a_blk = a[dpi * rows:(dpi + 1) * rows].to(dev)
        g = comm.all_reduce(a_blk.T @ a_blk, mesh.get_group("dp"))
        n = g.shape[0]
        B = len(j_ids) // ndev
        j = torch.as_tensor(np.asarray(j_ids[rank * B:(rank + 1) * B],
                                       np.int32)).to(dev)
        c = torch.as_tensor(np.asarray(caps[rank * B:(rank + 1) * B],
                                       np.int32)).to(dev)
        gen = torch.Generator().manual_seed(
            int(seed) + dpi * 131071 + mpi * 8191)
        x, _, _, rnorm, obj = cd_solve_block_ids(
            g, j, c, torch.zeros((B, n), device=dev), l1r, l2r, optTol, gen,
            shuffle=shuffle, impl=pick_impl(n, dev, 4096),
            variant=pick_large_variant(B, n))
        x_all = comm.all_gather(x.contiguous())
        sums = torch.stack([rnorm.sum(), obj.sum()]).double()
        sums = comm.all_reduce(sums.to(comm.wire(None, dev)))
        return x_all.cpu().numpy(), float(sums[0]), float(sums[1])

    return step


# --------------------------------------------------------------------- #
# replicated-G learn
# --------------------------------------------------------------------- #
def distributed_learn(train: CSR, cfg, mesh, imodel: CSR | None = None,
                      gram=None):
    """Learn a model across every rank of ``mesh`` with G replicated.

    The rating matrix is row-sharded, the partial Grams all-reduce into G
    on every rank (``gram``, such a G computed beforehand, is shared
    instead, as model selection does), and the single-device driver
    solves the column blocks b with b % world == rank: union compaction,
    the sweep kernels and packed harvests on each rank's own card.  It
    gathers the entries before assembling them, so every rank returns the
    same model.
    ``imodel`` warm-starts the solves (estimate.c:453-471)."""
    train = train.infer_ncols()
    dev, ndev, rank, _, _ = _where(mesh)
    g = gram if gram is not None else \
        sharded_gram_sparse(train, mesh, pad_to=bucket_npad(train.ncols))
    model, stats = estimate_model_cd(train, cfg, imodel=imodel, gram=g,
                                     device=dev, shard=(rank, ndev))
    stats.update(mode="replicated", ndevices=ndev)
    return model, stats


def distributed_grid(train: CSR, cfg, points, mesh, gram=None):
    """The packed grid (``solvers.cd.estimate_grid_cd``) with its blocks
    round-robin over the ranks and G all-reduced (or ``gram``); each
    point's entries gathered, so every rank returns the same models."""
    train = train.infer_ncols()
    dev, ndev, rank, _, _ = _where(mesh)
    g = gram if gram is not None else \
        sharded_gram_sparse(train, mesh, pad_to=bucket_npad(train.ncols))
    solved = estimate_grid_cd(train, cfg, points, device=dev, gram=g,
                              shard=(rank, ndev))
    for _, st in solved:
        st["ndevices"] = ndev
    return solved


# --------------------------------------------------------------------- #
# superblock driver shared by the blockwise and sharded-G modes
# --------------------------------------------------------------------- #
class _Ranked:
    """One learn's frequency relabel and this rank's share of the rows in
    rank space (rank r = the r-th most-rated item, as the single-device
    driver): p (rank -> item), posmap (item -> rank), each rank's sweep
    cap, the nonzero columns ``n_eff``, the row shard ``part`` with rank
    ids, and diag(G) in rank space, all-reduced."""

    def __init__(self, train: CSR, cfg, mesh, row_block: int):
        self.train = train = train.infer_ncols()
        self.n = n = train.ncols
        self.npad = npad = bucket_npad(n)
        self.dev, self.ndev, self.rank, self.dpi, self.mpi = _where(mesh)
        self.Bsup = self.ndev * int(cfg.block_size)
        self.binary = _is_binary(train.values())
        nnz_col = train.col_nnz()
        col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
        self.p = np.argsort(-nnz_col, kind="stable").astype(np.int32)
        self.posmap = np.empty(n, dtype=np.int32)
        self.posmap[self.p] = np.arange(n, dtype=np.int32)
        self.caps_p = col_caps[self.p]
        self.n_eff = int((nnz_col > 0).sum())
        self.part = part = _row_shard(train, self.ndev, self.rank, row_block,
                                      self.posmap)
        dev = self.dev
        self.cols = torch.from_numpy(part.indices.astype(np.int64)).to(dev)
        self.vals = torch.from_numpy(part.values().astype(np.float32)).to(dev)
        self.diag = comm.all_reduce(torch.zeros(npad, device=dev).index_add_(
            0, self.cols, self.vals * self.vals))


def _screen_chunk(width: int, Bsup: int) -> int:
    """Target columns per screen step: the (width, chunk) float32 buffer
    within SLIM_SCREEN_BYTES, a multiple of 128, at least 128."""
    return max(128, min(Bsup, (_screen_bytes() // (width * 4)) // 128 * 128))


def _chunked_flags(R: _Ranked, jarr, nJ: int, chunk: int, flags_of):
    """Union flags (npad,) of the targets jarr[:nJ], ``chunk`` columns at
    a time: ``flags_of(jc)`` gives one chunk's flags on the device."""
    flags = np.zeros(R.npad, bool)
    for c0 in range(0, nJ, chunk):
        m = min(chunk, nJ - c0)
        jc = np.full(chunk, R.npad - 1, np.int64)
        jc[:m] = jarr[c0:c0 + m]
        flags |= flags_of(torch.from_numpy(jc).to(R.dev)).cpu().numpy()
    return flags


def _superblocks_solve(R: _Ranked, cfg, flags_cb, gs_cb, imodel,
                       fslim_nnbrs: int):
    """Shared superblock driver of the G-free and sharded-G modes: per
    superblock of Bsup target ranks, the screen (``flags_cb``), the
    union S with the targets, the compact Gram (``gs_cb``), the warm
    start, this rank's block_size columns solved in S's space, harvested
    as the single-device driver harvests a block (one fetch, the pack
    kernel and the maps to item ids on the device) and all-gathered, held
    (``solvers.cd._Held``) and assembled by ``solvers.cd._assemble``.
    Exact single-device semantics (the same screening and caps per
    column).

    One-superblock lookahead: superblock k+1 is dispatched before k is
    harvested.  With ``cfg.checkpoint_dir`` each superblock is saved by
    rank 0 and a later learn loads it, when every rank finds it (the skip
    is agreed by an all-reduce, so every rank makes the same decisions;
    the directory must be one every rank reads)."""
    n, npad, Bsup, p, dev = R.n, R.npad, R.Bsup, R.p, R.dev
    bs = int(cfg.block_size)
    lo, hi = R.rank * bs, (R.rank + 1) * bs
    use_warm = imodel is not None and cfg.mtype in ("slim", "oslim")
    csc = imodel.with_ncols(max(imodel.ncols, n)).transpose() \
        if use_warm else None
    ckpt = _Checkpoint(cfg, R.train, n, Bsup, imodel if use_warm else None,
                       extra=f"dist:{Bsup}".encode()) \
        if cfg.checkpoint_dir else None
    held = _Held(dev)
    p32 = torch.from_numpy(np.concatenate(
        [p, np.arange(n, npad)]).astype(np.int32)).to(dev)
    nsup = -(-R.n_eff // Bsup)

    def dispatch(s0, blk):
        t0 = time.perf_counter()
        nJ = min(Bsup, R.n_eff - s0)
        jarr = np.full(Bsup, npad - 1, dtype=np.int64)
        jarr[:nJ] = np.arange(s0, s0 + nJ)
        ids = np.union1d(np.nonzero(flags_cb(jarr, nJ))[0], jarr[:nJ])
        K = min(bucket_npad(max(ids.size, 1)), npad)
        S = np.full(K, npad - 1, dtype=np.int64)
        S[:min(ids.size, K)] = ids[:K]
        S_dev = torch.from_numpy(S).to(dev)
        Gs = gs_cb(S_dev, K)
        jl = jarr[lo:hi]
        mine = max(0, min(bs, nJ - lo))
        caps = np.zeros(bs, np.int32)
        caps[:mine] = R.caps_p[s0 + lo:s0 + lo + mine]
        x0 = np.zeros((bs, K), np.float32)
        if use_warm:
            pos_of = np.full(npad, -1, np.int64)
            pos_of[S] = np.arange(K)
            for b in range(mine):
                j = p[s0 + lo + b]
                a, e = int(csc.indptr[j]), int(csc.indptr[j + 1])
                pos = pos_of[R.posmap[csc.indices[a:e]]]
                ok = pos >= 0
                x0[b, pos[ok]] = csc.values()[a:e][ok]
        # targets are members of S: their Gram rows are columns of G[S, S]
        posj = np.minimum(np.searchsorted(S, jl), K - 1)
        gjs = Gs[:, torch.from_numpy(posj).to(dev)].T.contiguous()
        jl_d = torch.from_numpy(jl.astype(np.int32)).to(dev)
        gen = torch.Generator().manual_seed(
            int(cfg.seed) + blk + R.dpi * 131071 + R.mpi * 8191)
        out = cd_solve_compact(
            Gs, S_dev.to(torch.int32), npad, jl_d, gjs, R.diag[jl_d.long()],
            torch.from_numpy(caps).to(dev), torch.from_numpy(x0).to(dev),
            float(cfg.l1r), float(cfg.l2r), float(cfg.optTol), gen,
            shuffle=cfg.shuffle, impl=pick_impl(K, dev, cfg.compact_threshold),
            x0_zero=not use_warm, variant=pick_large_variant(bs, K),
            fslim_nnbrs=fslim_nnbrs, simtype=cfg.simtype)
        logger.info("superblock %d/%d: K=%d dispatched in %.2fs", blk + 1,
                    nsup, K, time.perf_counter() - t0)
        return blk, S_dev, jl_d, mine, out

    def harvest(rec):
        blk, S_dev, jl_d, mine, out = rec
        _, (niters, _, rnorm, obj), fv, _, coord, target = _harvest(
            out, mine, jl_d, p32, n, S=S_dev)
        st = comm.all_gather_host(np.asarray(
            [rnorm.sum(), obj.sum(), niters.sum(),
             niters.max() if mine else 0]), dev)
        rec = _Block(*comm.all_gather_triplets(coord, target, fv, dev),
                     float(st[:, 0].sum()), float(st[:, 1].sum()),
                     int(st[:, 2].sum()), int(st[:, 3].max()))
        held.add(rec)
        if ckpt is not None and R.rank == 0:
            ckpt.save(blk, rec)

    def all_have(hit) -> bool:
        flag = torch.tensor([int(hit is not None)], dtype=torch.int32,
                            device=comm.wire(None, dev))
        return bool(comm.all_reduce(flag, op=dist.ReduceOp.MIN).item())

    pending = None
    for s0 in range(0, R.n_eff, Bsup):
        blk = s0 // Bsup
        if ckpt is not None:
            hit = ckpt.load(blk)
            if all_have(hit):
                if pending is not None:
                    harvest(pending)
                    pending = None
                held.add(hit)
                logger.info("superblock %d: resumed from checkpoint", blk + 1)
                continue
        rec = dispatch(s0, blk)
        if pending is not None:
            harvest(pending)
        pending = rec
    if pending is not None:
        harvest(pending)

    parts, (fit, loss, niters, sweeps) = held.of()
    model = _assemble(*parts, n)
    stats = {"loss": loss, "fit": fit, "ffrac": fit / loss if loss else 0.0,
             "nnz": model.nnz, "niters": niters, "sweeps": sweeps,
             "ndevices": R.ndev, "superblocks": nsup}
    return model, stats


# --------------------------------------------------------------------- #
# blockwise learn: G never materialized
# --------------------------------------------------------------------- #
def _screen_flags(R: _Ranked, jc, chunk: int, l1r: float, fslim_nnbrs: int,
                  simtype: str):
    """Union flags (npad,) of one chunk of targets ``jc`` (chunk,) (rank
    ids, padded with npad-1): ATY = AᵀA[:, jc] accumulated from the rank's
    rows into one (npad, chunk) buffer -- each row block's target columns
    densified by the densify kernel, each entry's row of them added at
    its column -- then reduce-scattered over item rows and thresholded
    locally (gathering the flags) when the world size divides npad, else
    all-reduced.  FSLIM all-reduces and takes each target's neighbour set
    (``fslim_active_mask``)."""
    npad, dev, part = R.npad, R.dev, R.part
    jl = torch.full((npad,), chunk, dtype=torch.int32, device=dev)
    jl[jc] = torch.arange(chunk, dtype=torch.int32, device=dev)
    ids = part.dev_put("idx32", lambda: part.indices.astype(np.int32), dev)
    ids = jl[ids.long()]
    vals = None if part.data is None else R.vals
    aty = torch.zeros((npad, chunk), dtype=torch.float32, device=dev)
    row_nnz = np.diff(part.indptr)
    for r0, r1 in _steps(row_nnz, max(SCREEN_STEP_FLOATS // chunk, 1)):
        y = densify_runs(ids, vals, part.indptr[r0:r1], row_nnz[r0:r1],
                         chunk, chunk, torch.empty((r1 - r0, chunk),
                                                   device=dev),
                         row_major=True)
        s, e = int(part.indptr[r0]), int(part.indptr[r1])
        loc = torch.from_numpy(np.repeat(np.arange(r1 - r0),
                                         row_nnz[r0:r1])).to(dev)
        aty.index_add_(0, R.cols[s:e], R.vals[s:e, None] * y[loc])
    if fslim_nnbrs > 0:
        comm.all_reduce(aty)
        return fslim_active_mask(aty.T, R.diag, jc, npad, fslim_nnbrs,
                                 simtype).any(dim=0)
    if npad % R.ndev == 0:
        loc = comm.reduce_scatter(aty)
        w = npad // R.ndev
        rows = R.rank * w + torch.arange(w, device=dev)
        act = (loc > l1r) & (rows[:, None] != jc[None, :])
        return comm.all_gather(act.any(dim=1).to(torch.uint8)).bool()
    comm.all_reduce(aty)
    rows = torch.arange(npad, device=dev)
    return ((aty > l1r) & (rows[:, None] != jc[None, :])).any(dim=1)


def distributed_learn_blockwise(train: CSR, cfg, mesh,
                                imodel: CSR | None = None,
                                row_block: int = 512):
    """Distributed CD learn for catalogues whose G cannot be materialized.

    Per superblock of world * block_size item columns (frequency-rank
    order): the memory-bounded screen (flags only, over column chunks of
    at most SLIM_SCREEN_BYTES) gives the union S, the compact Gram G[S, S]
    is the all-reduce of every rank's rows densified through S (densify
    kernel + contraction), and each rank solves its columns in S's space
    -- exact SLIM / FSLIM semantics with O(K²) memory per superblock
    (FSLIM's per-chunk top-k is exact; the solve re-derives each target's
    neighbour set inside the union)."""
    pin_f32()
    R = _Ranked(train, cfg, mesh, row_block)
    fslim_nnbrs = int(cfg.nnbrs) if cfg.mtype in ("fslim", "ofslim") else 0
    chunk = _screen_chunk(R.npad, R.Bsup)

    def flags_cb(jarr, nJ):
        return _chunked_flags(R, jarr, nJ, chunk, lambda jc: _screen_flags(
            R, jc, chunk, float(cfg.l1r), fslim_nnbrs, cfg.simtype))

    def gs_cb(S_dev, K):
        pos = torch.full((R.npad,), K, dtype=torch.int32, device=R.dev)
        pos[S_dev] = torch.arange(K, dtype=torch.int32, device=R.dev)
        return _reduced_gram(R.part, K, R.dev, R.binary, col_map=pos)

    model, stats = _superblocks_solve(R, cfg, flags_cb, gs_cb, imodel,
                                      fslim_nnbrs)
    stats["mode"] = "blockwise"
    return model, stats


# --------------------------------------------------------------------- #
# resident column-sharded G
# --------------------------------------------------------------------- #
def _gram_colshard(R: _Ranked):
    """(G[:, own columns] (W_tot, width) float32, width): for each rank e
    in turn, every rank's partial Gram of its rows against the column
    block of e, reduce-scattered over item rows, leaves tile
    G[rows_r, block_e] on rank r; rank r's column shard is the stack of
    its tiles transposed (G is symmetric).  Nothing is replicated."""
    W_tot = _round_up(R.npad, 128 * R.ndev)
    width = W_tot // R.ndev
    tiles = []
    for e in range(R.ndev):
        acc = gram_partial(R.part, W_tot, R.dev,
                           cols=(e * width, (e + 1) * width))
        acc = acc.to(torch.int32 if R.binary else torch.float32)
        tiles.append(comm.reduce_scatter(acc).T)
        del acc
    return torch.cat(tiles).to(torch.float32), width


def distributed_learn_sharded_g(train: CSR, cfg, mesh,
                                imodel: CSR | None = None,
                                row_block: int = 512):
    """Distributed CD learn with a resident column-sharded Gram: G is
    computed once, each rank holding npad²/world of it; each superblock's
    flags (the owner of a target column tests it, the flags are
    all-reduced) and compact Gram G[S, S] (each rank contributes the
    columns of S it owns, all-reduced) are gathered from it.  Solves and
    harvests are the blockwise mode's, so the result is the
    single-device model.  FSLIM runs blockwise (its top-k screen needs
    ATY values, not flags)."""
    if cfg.mtype in ("fslim", "ofslim"):
        return distributed_learn_blockwise(train, cfg, mesh, imodel,
                                           row_block)
    pin_f32()
    R = _Ranked(train, cfg, mesh, row_block)
    G_sh, width = _gram_colshard(R)
    W_tot = G_sh.shape[0]
    c0 = R.rank * width
    chunk = _screen_chunk(W_tot, R.Bsup)
    rows = torch.arange(W_tot, device=R.dev)
    l1r = float(cfg.l1r)

    def g_screen(jc):
        pos = jc - c0
        valid = (pos >= 0) & (pos < width)
        sub = G_sh[:, pos.clamp(0, width - 1)]
        act = (sub > l1r) & valid[None, :] & (rows[:, None] != jc[None, :])
        loc = act.any(dim=1).to(torch.int32)
        return comm.all_reduce(loc)[:R.npad] > 0

    def flags_cb(jarr, nJ):
        return _chunked_flags(R, jarr, nJ, chunk, g_screen)

    def gs_cb(S_dev, K):
        pos = S_dev - c0
        valid = (pos >= 0) & (pos < width)
        sub = G_sh[S_dev][:, pos.clamp(0, width - 1)]
        return comm.all_reduce(torch.where(valid[None, :], sub, 0.0))

    model, stats = _superblocks_solve(R, cfg, flags_cb, gs_cb, imodel, 0)
    stats["mode"] = "sharded_g"
    return model, stats


# --------------------------------------------------------------------- #
# sharded predict
# --------------------------------------------------------------------- #
def sharded_predict(model: CSR, hist: CSR, mesh, nrcmds: int = 10,
                    sparse=None):
    """Top-N with the users sharded over the ranks (padded to a multiple
    of the world size) and the model replicated: each rank serves its
    shard through :func:`~slim_tpu_torch.predict.predict_topn` on its own
    device, on the device route the single-device predict picks
    (``sparse`` as there; unset, sparse above SPARSE_PREDICT_THRESHOLD),
    pinned so that no rank takes the native host route, as in the JAX
    package, scored at "highest" at every npad (the JAX package's
    HIGHEST), with ties at the lowest id, and the results are
    all-gathered.  Returns (ids, scores, counts) as ``predict_topn``, the
    same on every rank."""
    from ..predict import SPARSE_PREDICT_THRESHOLD, predict_topn

    dev, ndev, rank, _, _ = _where(mesh)
    nusers = hist.nrows
    per = _round_up(max(nusers, ndev), ndev) // ndev
    u0, u1 = min(rank * per, nusers), min((rank + 1) * per, nusers)
    s, e = int(hist.indptr[u0]), int(hist.indptr[u1])
    mine = CSR.from_arrays(u1 - u0, hist.ncols, hist.indptr[u0:u1 + 1] - s,
                           hist.indices[s:e],
                           None if hist.data is None else hist.data[s:e])
    if sparse is None:
        sparse = bucket_npad(max(model.nrows, model.ncols, hist.ncols)) \
            > SPARSE_PREDICT_THRESHOLD
    ids, sc, cnt = predict_topn(model, mine, nrcmds, sparse=sparse,
                                precision="highest", device=dev)
    # one gather: ids, score bits and the count of each user as int32
    rows = np.zeros((per, 2 * nrcmds + 1), np.int32)
    rows[:u1 - u0] = np.concatenate([ids, sc.view(np.int32), cnt[:, None]],
                                    axis=1)
    t = torch.from_numpy(rows).to(comm.wire(None, dev))
    full = comm.all_gather(t).cpu().numpy()[:nusers]
    return (np.ascontiguousarray(full[:, :nrcmds]),
            np.ascontiguousarray(full[:, nrcmds:2 * nrcmds]).view(np.float32),
            np.ascontiguousarray(full[:, -1]))
