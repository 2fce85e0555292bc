"""Coordinate-descent model estimation (port of slim_tpu/solvers/cd.py,
single device).

Item columns are solved in blocks of B against the shared Gram.  Columns
are relabelled by training frequency (rank r = the r-th most-rated item),
so blocks are consecutive rank ranges with similar sweep caps and the
active-set screen concentrates in the low ranks.  Wide catalogues solve
each block in its union-active-set space (compact path), snapped to full
width when the union covers more than :func:`compact_frac` of it; FSLIM
takes the union of the columns' neighbour sets instead of the screen's.  Each
solved block is harvested on the main thread: its counts and column stats
in one fetch, the pack kernel and the maps to item ids on the device
(:func:`_harvest`), and its entries held as tensors
(:class:`_Held`), on the device while they fit in :func:`_card_budget`,
else in host memory; the pack keeps entries > 1e-7 (estimate.c:492-505).
Every CD driver (this learn, the packed grid and the distributed
superblocks) ends in :func:`_assemble` (estimate.c:570-593), which sorts
the held entries where they are: on the card it copies the finished CSR
out once.

Warm starts (estimate.c:453-471) densify each block's x0 on the device
from runs: the previous model's columns, or the retained pack of the
previous learn over the same matrix (model selection).  With
``keep_device_model`` the harvest packs stay on the device as a
:class:`slim_tpu_torch.predict.DeviceModelPack`.

With ``cfg.checkpoint_dir`` each solved block is written to a file keyed
by a signature of everything that shapes it (:class:`_Checkpoint`), and a
later learn loads the blocks it finds instead of solving them.
:func:`estimate_grid_cd` solves a whole (l1r, l2r) grid in one packed
pass, each block's columns carrying their own regularisation.

Where G lives, and the learn's memory plan on the card.  G is built in
rank space, one (npad, npad) float32 buffer (:func:`_rank_space`,
``ops/gram.py``), and lives until the learn returns.  Beside it, phase by
phase (in brackets the peak at Amazon-Book's npad 94,208 on an H100,
where G is 33.1 GiB): the Gram holds the int32 accumulator that becomes
G in place, one panel's product (an eighth of it) and one densified row
block (38.0 GiB); the screen (``relabel+screen``) one panel's mask G >
l1r (35.1 GiB); a full-width block the kept bf16 halves of G (as large as
G), made at the first such block and freed after the last one
(:func:`drop_split` of ``ops/cd_sweep``), and the block's (B, npad)
operands (70.7 GiB); a compact block of width K its gathers (phase
``compact-gather``: G[S, S] and G[j, S], 47.5 GiB at K 61,440), then G[S, S]'s
halves where K is above the compact threshold and (B, K) operands (64.2
GiB); the held entries, 12 bytes each, until the assembly sorts them.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import math
import os
import time
import zipfile
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..config import (SlimConfig, SLIM_DBG_INFO, SLIM_DBG_PROGRESS,
                      SLIM_DBG_TIME, dbg)
from ..ops.cd_kernel import (block_union_flags, block_union_mask,
                             cd_solve_block_ids, cd_solve_compact,
                             compact_union_ids, count_over, gather_compact)
from ..ops.cd_sweep import GROUP, drop_split, pick_large_variant
from ..ops.densify import densify_runs
from ..ops.gram import compute_gram, pin_f32
from ..ops.pack import pack
from ..types import CSR
from ..utils import PhaseTimer, nnz_bucket, resolve_device, span

logger = logging.getLogger("slim_tpu_torch")

EPSILON = 1e-7   # model nonzero threshold (reference def.h:14)
COMPACT_BMAX = 1024  # widest block on the compact path


def compact_frac() -> float:
    """Unions wider than this share of npad solve full width (the compact
    gathers cost more than the 1-(K/npad)^2 of sweep work they save):
    SLIM_COMPACT_FRAC, read at call time, default 0.75."""
    return float(os.environ.get("SLIM_COMPACT_FRAC", "0.75"))


def bucket_npad(n: int) -> int:
    """Pad the coordinate dimension to {256, 384, 512, 768, 1024, ...}
    (powers of two plus 1.5x steps), by 4096 above 16384; always > n so
    npad-1 is a zero row/column."""
    m = 256
    while m + m // 2 < 16384:
        if n + 1 <= m:
            return m
        if n + 1 <= m + m // 2:
            return m + m // 2
        m *= 2
    if n + 1 <= 16384:
        return 16384
    return ((n + 1 + 4095) // 4096) * 4096


def pick_impl(width: int, device: torch.device, compact_threshold: int) -> str:
    """Block-solve route for a coordinate width.  On the CPU the plain
    solve (ops/cd_kernel._cd_core).  On the card there is no VMEM budget
    to split around: every sweep kernel takes any B (one warp per column,
    a few columns per block), so every block runs whole, on the row-major
    whole-array sweep up to ``compact_threshold`` and above it on the
    wide-block sweep that ``ops.cd_sweep.pick_large_variant`` chooses."""
    if device.type != "cuda":
        return "plain"
    if width <= compact_threshold or width % GROUP:
        return "sweep"
    return "sweep_large"


def warm_runs(imodel: CSR, warm_pack, p_pad, posmap_pad, n: int, dev):
    """The warm start's source as runs in rank space: (ids, values) on
    ``dev``, run starts and lengths (host int64) indexed by target rank.
    ``p_pad`` / ``posmap_pad`` map rank -> item and item -> rank.  The
    retained pack of a learn over the same matrix is used as it is when
    its npad, n and permutation match; else the columns of ``imodel``
    (rows = rated item, cols = target item) are uploaded once, their item
    ids mapped to ranks."""
    if warm_pack is not None and warm_pack.npad == len(p_pad) \
            and warm_pack.n == n \
            and np.array_equal(warm_pack.posmap_pad, posmap_pad):
        return (warm_pack.idx, warm_pack.vals, warm_pack.run_starts,
                warm_pack.run_lens)
    csc = imodel.with_ncols(max(imodel.ncols, n)).transpose()
    p = p_pad[:n]
    ids = torch.from_numpy(posmap_pad[csc.indices].astype(np.int32)).to(dev)
    vals = torch.from_numpy(csc.values().astype(np.float32)).to(dev)
    return ids, vals, csc.indptr[p], np.diff(csc.indptr)[p]


def warm_x0(runs, r0: int, nJ: int, B: int, n: int, npad: int):
    """(B, npad) float32 x0 of the block of target ranks [r0, r0 + nJ),
    densified on the device through the densify kernel straight into its
    rows (row-major); rank-padding coordinates (>= n) are dropped and the
    rows past nJ are zero."""
    ids, vals, rs, rl = runs
    x0 = torch.empty((B, npad), dtype=torch.float32, device=ids.device)
    densify_runs(ids, vals, rs[r0:r0 + nJ], rl[r0:r0 + nJ], npad, n,
                 x0[:nJ], row_major=True)
    x0[nJ:].zero_()
    return x0


class _PackAccum:
    """keep_device_model: the harvest's device packs, in block order and
    with coordinates in rank space (compact ids mapped through S), so the
    next warm-started learn over the same matrix densifies x0 straight from
    them.  ``finalize`` builds the run table of the flat arrays."""

    def __init__(self):
        self.vals, self.ids, self.counts = [], [], []

    def add(self, c, fv, fi, S):
        self.counts.append(c)
        self.vals.append(fv)
        self.ids.append(S[fi.long()] if S is not None else fi)

    def finalize(self, p_pad, posmap_pad, n, npad):
        from ..predict import DeviceModelPack

        counts = np.concatenate(self.counts)[:npad]
        rl = np.zeros(npad, np.int64)
        rl[:counts.size] = counts
        rs = np.zeros(npad, np.int64)
        np.cumsum(rl[:-1], out=rs[1:])
        return DeviceModelPack(torch.cat(self.vals), torch.cat(self.ids), rs,
                               rl, p_pad, posmap_pad, n, npad)


class _Block(NamedTuple):
    """One solved block in item space: its model entries (rated item,
    target item, value; tensors, or host arrays as a checkpoint file holds
    them) and its column stats summed (err, obj, niters), with ``sweeps``
    = the sweeps its solve took (its slowest column's)."""
    coord: np.ndarray | torch.Tensor
    target: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    err: float
    obj: float
    niters: int
    sweeps: int


class _Checkpoint:
    """Per-block solve checkpoints (resume = load the solved blocks).

    One ``cdblk_<sig>_<blk>.npz`` per block, written through a temporary
    file and ``os.replace``.  The signature hashes everything that shapes a
    block's result, as the JAX package's does (the full train arrays, the
    regularisation and stopping settings, seed, block_size, shuffle,
    simtype, the warm-start model), plus a discriminator of this package
    (a JAX run's files in the same directory are never taken), the
    effective block width ``B`` after the compact clamp, which numbers the
    blocks, and ``compact_threshold`` and SLIM_COMPACT_FRAC, which pick
    each block's coordinate space.  ``extra`` tells apart drivers whose
    blocks cover other columns (the distributed superblocks)."""

    def __init__(self, cfg: SlimConfig, train: CSR, n: int, B: int,
                 imodel: CSR | None = None, extra: bytes = b""):
        h = hashlib.sha256(b"slim_tpu_torch" + extra)
        h.update(np.asarray([train.nrows, n, train.nnz]).tobytes())
        h.update(np.ascontiguousarray(train.indptr).tobytes())
        h.update(np.ascontiguousarray(train.indices).tobytes())
        if train.data is not None:
            h.update(np.ascontiguousarray(train.data).tobytes())
        h.update(np.asarray([cfg.l1r, cfg.l2r, cfg.optTol,
                             compact_frac()]).tobytes())
        h.update(np.asarray([cfg.maxniters, cfg.nnbrs, cfg.ordered,
                             cfg.seed, cfg.block_size, int(cfg.shuffle), B,
                             cfg.compact_threshold]).tobytes())
        h.update(cfg.simtype.encode())
        if imodel is None:
            h.update(b"none")
        else:
            h.update(np.asarray([imodel.nrows, imodel.ncols,
                                 imodel.nnz]).tobytes())
            h.update(np.ascontiguousarray(imodel.indptr).tobytes())
            h.update(np.ascontiguousarray(imodel.indices).tobytes())
            if imodel.data is not None:
                h.update(np.ascontiguousarray(imodel.data).tobytes())
        self.sig = h.hexdigest()[:16]
        self.dir = cfg.checkpoint_dir
        os.makedirs(self.dir, exist_ok=True)

    def path(self, blk: int) -> str:
        return os.path.join(self.dir, f"cdblk_{self.sig}_{blk}.npz")

    def load(self, blk: int):
        """The block's :class:`_Block`, or None when its file is missing or
        unreadable."""
        try:
            with np.load(self.path(blk)) as z:
                return _Block(z["coord"], z["target"], z["vals"],
                              float(z["err"]), float(z["obj"]),
                              int(z["niters"]), int(z["sweeps"]))
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile):
            return None

    def save(self, blk: int, rec: _Block) -> None:
        """Write the block, its entries copied to host arrays."""
        tmp = self.path(blk) + ".tmp.npz"
        np.savez(tmp, **{k: v.cpu().numpy() if torch.is_tensor(v) else v
                         for k, v in rec._asdict().items()})
        os.replace(tmp, self.path(blk))


def _rank_space(train: CSR, cfg: SlimConfig, npad: int, gram, dev):
    """The frequency relabel (rank r = the r-th most-rated item): the Gram
    in rank space on ``dev``, p (rank -> item), ``p_pad`` / ``posmap_pad``
    over npad, and each rank's sweep cap min(50 nnz_col, maxniters)
    (estimate.c:448-449).  A computed Gram is built in rank space, one
    (npad, npad) buffer (``compute_gram`` through ``col_map`` = item ->
    rank; the JAX package permutes an item-space G instead); a given
    ``gram``, in item space (model selection's shared one), is permuted
    with two gathers."""
    n = train.ncols
    # the column counts on ``dev``, from the ids the Gram uploads: the
    # host's bincount (~0.1 s at 20M ratings) would hold back the Gram,
    # which needs the ranks before it starts
    idx = train.dev_put("idx32", lambda: train.indices.astype(np.int32), dev)
    with span("slim.wait.counts"):
        nnz_col = torch.bincount(idx, minlength=n).cpu().numpy()
    col_caps = np.minimum(50 * nnz_col, cfg.maxniters).astype(np.int32)
    p = np.argsort(-nnz_col, kind="stable").astype(np.int32)  # rank -> item
    pad = np.arange(n, npad, dtype=np.int64)
    p_pad = np.concatenate([p, pad])
    posmap_pad = np.concatenate([np.empty(n, np.int64), pad])
    posmap_pad[p] = np.arange(n)                              # item -> rank
    if gram is None:
        g = compute_gram(train, cfg.gram, pad_to=npad, device=dev,
                         col_map=posmap_pad[:n])
    else:
        p_dev = torch.from_numpy(p_pad).to(dev)
        g = gram.index_select(0, p_dev).index_select(1, p_dev)
    return g, p, p_pad, posmap_pad, col_caps[p], nnz_col


# the main thread's blocked wait in the solve + harvest loop, as the JAX
# package logs it: on a block's count and stats fetch (the solve's end)
WAITS = ("solve-sync",)


def _phases(clock: PhaseTimer) -> dict:
    """The clock's phases, the waits always among them."""
    return dict(clock.phases, **{k: clock.phases.get(k, 0.0)
                                 for k in WAITS})


def _harvest(out, nJ: int, J, p32, n: int, hold=lambda *a: a, S=None,
             clock=None):
    """One solved block's harvest, the same in every CD driver.  ``out``:
    the block solve's (solved (B, K) block, niters, rstatus, rnorm, obj);
    its first ``nJ`` columns are real.  The coordinates that are no model
    item are zeroed (rank padding: coordinate >= n, through S on the
    compact path; the JAX package drops them from the fetched pack
    instead, the same entries remain), then the counts over EPSILON and
    the column stats are fetched in one copy (the phase ``solve-sync`` of
    ``clock``, when given), then on the device (the phase ``harvest``) the
    pack kernel at the counts' offsets and integer maps only: each
    entry's column by ``repeat_interleave`` of the counts, compact ids
    through S, ranks to items through ``p32`` (rank -> item over npad,
    int32) for the coordinate and for the target ``J[column]``.  Returns
    ``hold(counts (B,) int64 with the padded columns 0, stats (4, nJ)
    float64: niters, rstatus, rnorm, obj, pack values, pack ids, coord
    int32, target int32)``, called inside the phase ``harvest`` (by
    default those six as a tuple); the entries are in column order,
    ``counts.sum()`` of each."""
    phase = clock.phase if clock is not None else \
        (lambda name: contextlib.nullcontext())
    x, B = out[0], out[0].shape[0]
    cols = S if S is not None else torch.arange(x.shape[1], device=x.device)
    x = x.masked_fill((cols >= n)[None, :], 0.0).contiguous()
    with phase("solve-sync"):
        h = torch.cat([count_over(x, EPSILON).to(torch.float64),
                       torch.stack([o.to(torch.float64)
                                    for o in out[1:]]).reshape(-1)])
        with span("slim.wait.fetch"):
            h = h.cpu().numpy()
        c = h[:B].astype(np.int64)
        c[nJ:] = 0
    with phase("harvest"):
        off = np.zeros(B, np.int32)
        np.cumsum(c[:-1], out=off[1:])
        T = int(c.sum())
        fv, fi = pack(x, torch.from_numpy(off).to(x.device), EPSILON,
                      nnz_bucket(max(T, 1), floor=128))
        fv, fi = fv[:T], fi[:T]
        rows = torch.repeat_interleave(
            torch.arange(B, device=x.device),
            torch.from_numpy(c).to(x.device), output_size=T)
        cp = S.long()[fi.long()] if S is not None else fi.long()
        return hold(c, h[B:].reshape(4, B)[:, :nJ], fv, fi, p32[cp],
                    p32[J.long()[rows]])


def _card_budget(dev) -> float:
    """The bytes of entries a learn may hold on the card to sort them
    there: a quarter of the free memory ``torch.cuda.mem_get_info``
    reports (the joined copies, the sort's keys, permutation and scratch
    take up to four times the entries' bytes); no bound off the card,
    where the entries are in host memory already.  Read once a learn, at
    its first held block: the query took 0.1-90 ms a call on an H100
    machine."""
    if dev.type != "cuda":
        return math.inf
    return torch.cuda.mem_get_info(dev)[0] // 4


class _Held:
    """The solved blocks (:class:`_Block`) of a learn until its assembly,
    in the order they were added, each under a key (the grid's point; 0
    elsewhere), their entries as tensors on the learn's device (restored
    blocks' arrays uploaded).  Once the entries held pass
    :func:`_card_budget`, every held block moves to host memory as CPU
    tensors, and so does every later one."""

    def __init__(self, dev):
        self.dev, self.blocks, self.keys = dev, [], []
        self.nbytes, self.budget = 0, None

    @property
    def where(self) -> str:
        """Where the held entries are: "card" on a CUDA device, else
        "host"."""
        return "card" if self.dev.type == "cuda" else "host"

    def _on_dev(self, rec: _Block) -> _Block:
        return rec._replace(**{k: torch.as_tensor(getattr(rec, k)).to(
            self.dev) for k in ("coord", "target", "vals")})

    def _move(self):
        """Every held block, and every later one, to host memory."""
        self.dev, self.budget = torch.device("cpu"), math.inf
        self.blocks = [self._on_dev(b) for b in self.blocks]

    def add(self, rec: _Block, key: int = 0):
        if self.budget is None:
            self.budget = _card_budget(self.dev)
        self.nbytes += 12 * len(rec.vals)
        if self.nbytes > self.budget:
            logger.info("model entries past the card's budget (%d of %d "
                        "bytes) after %d held blocks: held in host memory",
                        self.nbytes, self.budget, len(self.blocks))
            self._move()
        self.blocks.append(self._on_dev(rec))
        self.keys.append(key)

    def of(self, key: int = 0):
        """The (coord, target, vals) lists of ``key``'s blocks, as
        :func:`_assemble` takes them, and their column stats summed (err,
        obj, niters, sweeps)."""
        got = [b for b, k in zip(self.blocks, self.keys) if k == key]
        return (([b.coord for b in got], [b.target for b in got],
                 [b.vals for b in got]),
                tuple(sum(getattr(b, f) for b in got)
                      for f in ("err", "obj", "niters", "sweeps")))


def estimate_model_cd(train: CSR, cfg: SlimConfig, imodel: CSR | None = None,
                      gram=None, keep_device_model=False, warm_pack=None,
                      device=None, shard=None):
    """Estimate the SLIM / FSLIM model with batched coordinate descent on
    ``device`` (default: the card; raises without one).

    Returns ``(model, stats)``: model is a CSR with rows = rated item,
    cols = target item (estimate.c:570-593); stats carries loss/fit/nnz,
    the summed per-column sweeps, ``phases`` (seconds per phase),
    ``block_width`` (the columns of a block), ``sweep_work`` (the sums
    over blocks of K^2 x sweeps and npad^2 x sweeps, K a block's
    coordinate width: the sweep work the screen's unions leave of full
    width's) and, on the compact path, ``union_widths`` and ``unions``.

    FSLIM (mtype fslim, and ofslim, which learns as fslim) restricts each
    column's active set to its ``cfg.nnbrs`` most similar items
    (``cfg.simtype``) and ignores the warm start.  On the compact path the
    neighbour selection and the unions it gives are the phase ``select``
    (in place of ``relabel+screen``), and ``stats["fslim"]`` counts its
    ``blocks`` and the ``neighbours`` selected over their columns; at full
    width each block's solve selects its own.  ``imodel``
    warm-starts every column from that model (mtype slim, and
    oslim, whose ``ordered`` flag the reference never reads);
    ``warm_pack``, the retained pack of a learn over the same matrix,
    replaces its upload.  ``gram``: a precomputed (npad, npad) Gram in
    original item space on ``device`` (model selection shares one).
    ``keep_device_model``: ``stats["W_dev"]`` is the model as a
    :class:`slim_tpu_torch.predict.DeviceModelPack`; with
    ``cfg.checkpoint_dir`` set it is None, as in the JAX package
    (restored blocks have no device pack).  ``cfg.checkpoint_dir``:
    blocks found there (:class:`_Checkpoint`) are loaded, the others
    solved and written.

    ``shard`` = (rank, size) solves only the blocks b with b % size ==
    rank (the replicated distributed learn's round-robin) and gathers
    every rank's entries and sums before the assembly, so every rank of
    the process group returns the whole model and its stats
    (``parallel.dist.distributed_learn``).

    Each solved block's entries stay on the device, copied nowhere, until
    the assembly sorts them there (:func:`_assemble`); past
    :func:`_card_budget` they move to host memory (:class:`_Held`).
    ``phases`` are the seconds of each phase, the wait ``solve-sync``
    among them, and ``checkpoint`` the checkpoint writes';
    ``stats["assembly"]`` says where the model was assembled, "card" or
    "host"."""
    if shard is not None and keep_device_model:
        raise ValueError("keep_device_model needs every block on one "
                         "device, not a shard")
    dev = resolve_device(device)
    pin_f32()
    clock = PhaseTimer(dev, "slim.cd")
    n = train.ncols
    npad = bucket_npad(n)
    B = int(cfg.block_size)
    if train.nnz == 0:
        model = CSR.from_ijv(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), nrows=n, ncols=n,
                             no_duplicates=True)
        return model, {"loss": 0.0, "fit": 0.0, "ffrac": 0.0, "nnz": 0,
                       "niters": 0, "sweeps": 0, "phases": {},
                       "assembly": "host"}

    with clock.phase("gram"):
        g, p, p_pad, posmap_pad, caps_p, nnz_col = _rank_space(
            train, cfg, npad, gram, dev)
    # FSLIM ignores the warm start (cd.py:613 of the JAX package: the
    # reference's active-flag handshake only engages for the screen)
    use_warm = imodel is not None and cfg.mtype in ("slim", "oslim")
    fslim_nnbrs = int(cfg.nnbrs) if cfg.mtype in ("fslim", "ofslim") else 0
    fslim = dict(fslim_nnbrs=fslim_nnbrs, simtype=cfg.simtype)
    use_compact = npad > int(cfg.compact_threshold)
    if use_compact:
        B = min(B, COMPACT_BMAX)
    nblocks = (n + B - 1) // B
    mine = range(nblocks) if shard is None else \
        range(shard[0], nblocks, shard[1])

    def block_ids(blk):
        """(first rank, real columns, (B,) target ranks on the device, the
        padding pointing at the zero column npad-1)."""
        r0 = blk * B
        nJ = min(B, n - r0)
        Jpad = np.full(B, npad - 1, dtype=np.int32)
        Jpad[:nJ] = np.arange(r0, r0 + nJ, dtype=np.int32)
        return r0, nJ, torch.from_numpy(Jpad).to(dev)

    union = {}   # blk -> (K, S on device, S on host) for compact blocks
    widths = Counter()
    selected = Counter()   # the FSLIM selection's blocks and neighbours
    # FSLIM's neighbour selection is the compact path's screen
    select = use_compact and fslim_nnbrs > 0
    with clock.phase("select" if select else "relabel+screen"):
        runs = warm_runs(imodel, warm_pack, p_pad, posmap_pad, n, dev) \
            if use_warm else None
        ckpt = _Checkpoint(cfg, train, n, B, imodel if use_warm else None) \
            if cfg.checkpoint_dir else None
        acc = _PackAccum() if keep_device_model and ckpt is None else None
        if select:
            # one block's (B, npad) neighbour top-k at a time
            rows = {}
            for blk in mine:
                S, c, nbrs = block_union_mask(g, block_ids(blk)[2], cfg.l1r,
                                              npad, **fslim)
                rows[blk] = (S, c)
                selected.update(blocks=1, neighbours=nbrs)
        elif use_compact:
            u = block_union_flags(g, nblocks, B, float(cfg.l1r))
            s_dev, cnt = compact_union_ids(u)
            del u
            with span("slim.wait.screen"):
                cnt = cnt.cpu().numpy()
            rows = {blk: (s_dev[blk], cnt[blk]) for blk in mine}
        if use_compact:
            frac = compact_frac()
            for blk, (s_row, c) in rows.items():
                K = min(bucket_npad(max(int(c), 1)), npad)
                if K <= frac * npad and K < npad:
                    S = s_row[:K].contiguous()
                    with span("slim.wait.screen"):
                        union[blk] = (K, S, S.cpu().numpy())
                widths[K if blk in union else npad] += 1
            del rows
            if dbg(cfg, SLIM_DBG_TIME):
                logger.info("union widths: %s", " ".join(
                    f"{k}:{v}" for k, v in sorted(widths.items())))

    def solve_block(blk):
        r0, nJ, J = block_ids(blk)
        K, S, _ = union.get(blk, (npad, None, None))
        x0 = None
        if use_warm:
            with clock.phase("warm x0"):
                x0 = warm_x0(runs, r0, nJ, B, n, npad)
                if S is not None:
                    x0 = x0.index_select(1, S.long())
        pieces = None
        if S is not None:
            with clock.phase("compact-gather"):
                pieces = gather_compact(g, S, J)
        with clock.phase("solve"):
            caps = np.zeros(B, dtype=np.int32)
            caps[:nJ] = caps_p[r0:r0 + nJ]
            caps_d = torch.from_numpy(caps).to(dev)
            gen = torch.Generator().manual_seed(int(cfg.seed) + blk)
            args = (float(cfg.l1r), float(cfg.l2r), float(cfg.optTol), gen)
            if x0 is None:
                x0 = torch.zeros((B, K), dtype=torch.float32, device=dev)
            kw = dict(shuffle=cfg.shuffle, x0_zero=not use_warm,
                      impl=pick_impl(K, dev, cfg.compact_threshold),
                      variant=pick_large_variant(B, K))
            if S is not None:
                Gs, gjs, yty = pieces
                out = cd_solve_compact(Gs, S, npad, J, gjs, yty, caps_d, x0,
                                       *args, **kw, **fslim)
            else:
                out = cd_solve_block_ids(g, J, caps_d, x0, *args, **kw,
                                         n_valid=n, **fslim)
        return r0, nJ, J, S, out

    def harvest(blk, r0, nJ, J, S, out):
        """The block's harvest (:func:`_harvest`), its entries held."""
        def hold(c, st, fv, fi, coord, target):
            niters_h, rstatus_h, rnorm_h, obj_h = st
            if dbg(cfg, SLIM_DBG_PROGRESS):
                for b in range(nJ):
                    j = p[r0 + b]
                    logger.info("Col: %5d %5d rs: %d nits: %4d nnz: %4d "
                                "rsd: %.2e obj: %.2e", j, int(nnz_col[j]),
                                int(rstatus_h[b]), int(niters_h[b]),
                                int(c[b]), rnorm_h[b], obj_h[b])
            if acc is not None:
                acc.add(c, fv, fi, S)
            rec = _Block(coord, target, fv, float(rnorm_h.sum()),
                         float(obj_h.sum()), int(niters_h.sum()),
                         int(niters_h.max()) if nJ else 0)
            held.add(rec)
            return rec

        return _harvest(out, nJ, J, p32, n, hold, S, clock)

    p32 = torch.from_numpy(p_pad.astype(np.int32)).to(dev)
    held = _Held(dev)
    # sweep work: sum over blocks of K^2 x sweeps, and of npad^2 x sweeps
    work = [0, 0]
    # the kept bf16 halves of the full G serve full-width blocks only: free
    # them once the last of those is solved, before the compact gathers
    last_full = max((b for b in mine if b not in union), default=None)
    for blk in mine:
        rec = None
        if ckpt is not None and os.path.exists(ckpt.path(blk)):
            with clock.phase("restore"):
                rec = ckpt.load(blk)
                if rec is not None:
                    held.add(rec)
        if rec is None:
            rec = harvest(blk, *solve_block(blk))
            if ckpt is not None:
                with clock.phase("checkpoint"):
                    ckpt.save(blk, rec)
        if blk == last_full:
            drop_split(g)
        K = union[blk][0] if blk in union else npad
        work[0] += K * K * rec.sweeps
        work[1] += npad * npad * rec.sweeps

    if shard is not None:
        with clock.phase("gather"):
            held = _gathered(*held.of(), dev)
    parts, sums = held.of()
    with clock.phase("assembly"):
        model = _assemble(*parts, n)
    total_err, total_obj, niters, sweeps = sums
    stats = {
        "loss": total_obj,
        "fit": total_err,
        "ffrac": total_err / total_obj if total_obj else 0.0,
        "nnz": model.nnz,
        "niters": niters,
        "sweeps": sweeps,
        "phases": _phases(clock),
        "assembly": held.where,
        "sweep_work": tuple(work),
        "block_width": B,
    }
    if use_compact:
        # coordinate width -> blocks, and each compact block's union (rank
        # ids, rank r = the r-th most-rated item)
        stats["union_widths"] = dict(sorted(widths.items()))
        stats["unions"] = {b: S_h[S_h < npad - 1]
                           for b, (_, _, S_h) in union.items()}
    if selected:
        stats["fslim"] = dict(selected)
    if keep_device_model:
        stats["W_dev"] = None if acc is None else \
            acc.finalize(p_pad, posmap_pad, n, npad)
    if dbg(cfg, SLIM_DBG_TIME):
        logger.info("cd phases: %s [waits: %s] (total %.2fs)", "  ".join(
            f"{k} {v:.2f}s" for k, v in stats["phases"].items()
            if k not in WAITS), " ".join(
            f"{k} {stats['phases'][k]:.2f}s" for k in WAITS),
            time.perf_counter() - clock.start)
    if dbg(cfg, SLIM_DBG_INFO):
        logger.info(
            "Done estimation: loss: %.5e, fit: %.5e, ffrac: %.3f,  #nzs: %d",
            stats["loss"], stats["fit"], stats["ffrac"], stats["nnz"])
    return model, stats


def _assemble(coord, target, vals, n: int) -> CSR:
    """The (n, n) model from lists of (rated item int32, target item int32,
    value float32) tensors on one device, each pair once: the entries
    sorted there by the key coord x n + target (int32 while n^2 < 2^31,
    else int64), the values gathered by the sort's permutation, the row
    counts' cumulative sum as indptr, then indptr, indices and data copied
    to the host once, into pageable memory.  Each (row, column) pair
    appears once, so the keys are unique and any sort gives the one
    order: the CSR equals ``native.csr_from_blocks``' entry for entry."""
    if not coord:
        return CSR.from_arrays(n, n, np.zeros(n + 1, np.int64),
                               np.zeros(0, np.int32), np.zeros(0, np.float32))
    rows = torch.cat(coord)
    indptr = torch.cat([rows.new_zeros(1, dtype=torch.int64),
                        torch.bincount(rows, minlength=n).cumsum(0)])
    key = rows.long() * n if n * n >= 2 ** 31 else rows * n
    del rows
    key += torch.cat(target)
    key, perm = torch.sort(key)
    data = torch.cat(vals)[perm]
    del perm
    indices = key.remainder_(n).int()
    del key
    return CSR.from_arrays(n, n, indptr.cpu().numpy(),
                           indices.cpu().numpy(), data.cpu().numpy())


def _gathered(parts, sums, dev) -> _Held:
    """A ``shard`` solve's entries (lists of tensors, as :func:`_assemble`
    takes them) and summed column stats (err, obj, niters, sweeps) from
    every rank of the process group, the same on each: the entries
    all-gathered in rank order, held as one block (:class:`_Held`: on
    ``dev`` while they fit), the sums summed."""
    from ..parallel.comm import all_gather_host, all_gather_triplets

    cat = [torch.cat(a) if a else torch.zeros(0, dtype=dt, device=dev)
           for a, dt in zip(parts, (torch.int32, torch.int32, torch.float32))]
    tri = all_gather_triplets(*cat, dev)
    err, obj, niters, sweeps = all_gather_host(
        np.asarray(sums, np.float64), dev).sum(axis=0).tolist()
    held = _Held(dev)
    held.add(_Block(*tri, err, obj, int(niters), int(sweeps)))
    return held


def estimate_grid_cd(train: CSR, cfg: SlimConfig, points, device=None,
                     gram=None, shard=None):
    """Solve a whole (l1r, l2r) grid in one packed pass on ``device``
    (default: the card; raises without one).

    Every (grid point, item column) pair is one virtual column v: point
    v // n, rank v % n.  Blocks of ``cfg.block_size`` virtual columns solve
    at full width against the shared rank-space Gram, each column with its
    point's (l1r, l2r), cold (no warm start), block v0's visit order seeded
    with seed + v0 as in the JAX package; FSLIM restricts each column to
    its neighbours.  Each block is harvested through the pack kernel and
    its entries held split by point, as in :func:`estimate_model_cd`.
    Returns a list of (model, stats) aligned with ``points``; a point's
    loss, fit, nnz and niters are its columns' sums, its ``sweeps`` the
    sweeps of the blocks that hold its columns, its ``phases`` those of the
    whole pass.
    ``gram``: the item-space Gram on ``device`` (a shared or all-reduced
    one); ``shard`` = (rank, size): only the blocks b with b % size ==
    rank, each point gathered from every rank, as in
    :func:`estimate_model_cd`."""
    dev = resolve_device(device)
    pin_f32()
    train = train.infer_ncols()
    n = train.ncols
    npad = bucket_npad(n)
    B = int(cfg.block_size)
    P = len(points)
    l1s = np.asarray([pt[0] for pt in points], dtype=np.float32)
    l2s = np.asarray([pt[1] for pt in points], dtype=np.float32)
    clock = PhaseTimer(dev, "slim.cd")
    held = _Held(dev)   # each block's entries split by point, the key
    if train.nnz:
        # the grid's phases have no "gram": its Gram goes to "solve"
        with clock.phase("solve"):
            g, p, p_pad, _, caps_p, _ = _rank_space(train, cfg, npad, gram,
                                                    dev)
            x0 = torch.zeros((B, npad), dtype=torch.float32, device=dev)
            p32 = torch.from_numpy(p_pad.astype(np.int32)).to(dev)
        fslim_nnbrs = int(cfg.nnbrs) if cfg.mtype in ("fslim", "ofslim") \
            else 0
        kw = dict(shuffle=cfg.shuffle, x0_zero=True,
                  impl=pick_impl(npad, dev, cfg.compact_threshold),
                  variant=pick_large_variant(B, npad), n_valid=n,
                  fslim_nnbrs=fslim_nnbrs, simtype=cfg.simtype)
        first, step = (0, B) if shard is None else \
            (B * shard[0], B * shard[1])

        def hold(c, st, fv, fi, coord, target):
            """Block v0's entries held split by grid point (each point's
            columns are a run of the block's, so its entries are a run of
            the pack)."""
            niters_h, _, rnorm_h, obj_h = st
            pts = np.arange(v0, v0 + nv) // n
            ends = np.cumsum(c)
            for pt in np.unique(pts):
                cols = np.flatnonzero(pts == pt)
                lo = int(ends[cols[0] - 1]) if cols[0] else 0
                hi = int(ends[cols[-1]])
                held.add(_Block(coord[lo:hi], target[lo:hi], fv[lo:hi],
                                rnorm_h[cols].sum(), obj_h[cols].sum(),
                                niters_h[cols].sum(), int(niters_h.max())),
                         int(pt))

        for v0 in range(first, P * n, step):
            nv = min(B, P * n - v0)
            with clock.phase("solve"):
                vids = np.arange(v0, v0 + nv)
                ranks, pts = vids % n, vids // n
                Jpad = np.full(B, npad - 1, dtype=np.int32)
                Jpad[:nv] = ranks
                caps = np.zeros(B, dtype=np.int32)
                caps[:nv] = caps_p[ranks]
                l1b = np.zeros(B, dtype=np.float32)
                l2b = np.ones(B, dtype=np.float32)
                l1b[:nv], l2b[:nv] = l1s[pts], l2s[pts]
                J = torch.from_numpy(Jpad).to(dev)
                out = cd_solve_block_ids(
                    g, J, torch.from_numpy(caps).to(dev), x0,
                    *(torch.from_numpy(a).to(dev) for a in (l1b, l2b)),
                    float(cfg.optTol), torch.Generator().manual_seed(
                        int(cfg.seed) + v0), **kw)
            _harvest(out, nv, J, p32, n, hold, clock=clock)

    results = []
    with clock.phase("assembly"):
        for pt in range(P):
            parts, sums = held.of(pt)
            if shard is not None:
                parts, sums = _gathered(parts, sums, dev).of()
            model = _assemble(*parts, n)
            err, obj, niters, sweeps = sums
            results.append((model, {
                "loss": float(obj), "fit": float(err),
                "ffrac": float(err / obj) if obj else 0.0,
                "nnz": model.nnz, "niters": int(niters),
                "sweeps": int(sweeps)}))
    for _, stats in results:
        stats["phases"] = _phases(clock)
    return results
