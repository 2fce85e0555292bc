"""Top-N prediction (port of slim_tpu/predict.py).

score(k) = Σ_{i in history} rating_i · W[i, k] (predict.c:40-58); history
items are excluded and only items with score > 0 are candidates, so a user
can get fewer than N recommendations (predict.c:62).  The device routes
order equal scores by the lowest id (:func:`topk_lowest_id`, the order
``lax.top_k`` gives).  Each call scores on one of four routes, and
:data:`last_route` names the one that served the latest call:

* **native** (small calls, unpinned only): the native runtime's per-user
  sparse loop on the host (:func:`native_predict_applicable`: the JAX
  package's rule and a cap from the card's costs).  Equal scores keep
  the first-touched id first there.
* **dense** (npad <= SPARSE_PREDICT_THRESHOLD): the model is densified on
  the device through the densify kernel (model rows as runs), each user
  block's histories likewise; the scores are a matrix product at the
  call's precision (:func:`_score_precision`): one float32 ``torch.matmul``
  (TF32 off) at ``"highest"``, bfloat16 operands with float32 sums on the
  tensor cores at ``"high"`` (W split in two halves) and ``"default"``.
  A model the solver kept on the device (:class:`DeviceModelPack`)
  densifies there, with no upload.  The halves of a W the caller keeps
  (``W_dev``) are made once and kept on the device while W lives
  unchanged (:func:`_halves_of`).
* **sparse score rows** (wider catalogues, or ``sparse=True``): each
  history entry expands to its model row's real entries (:class:`RowModel`)
  and the (user, candidate, weight) pairs scatter-add into a float32
  (users, npad) score block.  The JAX package gathers padded (users, H, R)
  blocks instead; a learned model's rows are skewed (a popular item
  neighbours most targets), so R reaches thousands, and one step here
  holds at most STEP_BYTES of pairs whatever R or H are.
* **COO** (sparse, npad >= SLIM_PREDICT_COO_NPAD, default 2^19): the pairs,
  keyed user * npad + candidate in int64, are sorted and their duplicates
  summed; each user's runs are ordered by (score desc, id asc), so no
  npad-wide row exists.  History exclusion is a HISTORY_MARK pair.

:func:`predict_candidate_scores` and :func:`predict_topn_1vsk` score an
explicit candidate list per user on the same routes.  The JAX package's
one-dispatch scans, chunked top-k and packed id transport are TPU dispatch
and sort workarounds with the same outputs; ``scan=`` is accepted and
ignored.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from . import native
from .ops.densify import densify_runs
from .ops.gram import pin_f32
from .solvers.cd import bucket_npad
from .types import CSR
from .utils import kept, resolve_device, span, topk_lowest_id

# above this many items a dense (npad, npad) W stops fitting next to the
# score blocks on the JAX package's 16 GB part; kept for parity of routes
SPARSE_PREDICT_THRESHOLD = 36864
SCORE_BLOCK_BYTES = 1 << 30   # bytes of one (users, npad) score block
COO_PREDICT_NPAD = 1 << 19    # default SLIM_PREDICT_COO_NPAD
STEP_BYTES = 1 << 30          # device bytes of one sparse scoring step
PAIR_BYTES = 64               # bytes one pair takes through a step: ids,
                              # keys, weights and the COO sort's buffers
HISTORY_MARK = -1e30          # a COO history pair: its run's sum goes < 0

# The small-catalogue route, the JAX package's thresholds kept for parity
# (predict.py there): unpinned calls up to this npad score on the host
# (SLIM_PREDICT_NATIVE_NPAD overrides, 0 turns the route off) ...
NATIVE_PREDICT_NPAD = 4096
# ... and above it while the per-user work of the host loop, mean history
# nnz x mean model-row nnz, is below this share of npad, the per-user
# work of every device route (SLIM_PREDICT_NATIVE_ALPHA overrides, 0
# keeps the npad rule alone) ...
NATIVE_PREDICT_ALPHA = 0.75
# ... and, the port's own cap, only while the native loop's score updates
# (native_predict_work) take no longer than the card's dense route would
# take for the call: a fixed cost, the model's densify (per npad^2 cell)
# and the f32 scoring (per user and npad^2 cell).  Fit on one H100 and its
# 8-core host by chip_smoke phase 14, where the card serves more users per
# second at every catalogue measured: the host wins only a call small
# enough for the card's costs per call to outweigh the whole host loop.
# The per-cell cost sits mid-way (on a log scale) in the range that routes
# every phase-14 call within its 1.25x check since the model densify
# became one row-major launch (5e-12 to 2e-11; 5e-11 sent the ML-20M FSLIM
# model's first 600 users to the host at 2.1x the card's time).
HOST_S_PER_UPDATE = 5e-10
CARD_S_PER_CALL = 1.25e-3
CARD_S_PER_CELL = 1e-11
CARD_S_PER_SCORE = 4e-14

logger = logging.getLogger("slim_tpu_torch")

# the scoring precision of the dense route: the JAX package's names
# (jax.lax.Precision's), and the npad up to which a call that names none
# scores at "highest" (the JAX package's _BF16_SCORE_NPAD)
PRECISIONS = ("default", "high", "highest")
_BF16_SCORE_NPAD = 8192

# the route that served the latest predict_topn call: "native", "dense",
# "rows" (sparse score rows) or "coo"; and the dense route's precision
# there (None on the other routes)
last_route = None
last_precision = None


def native_predict_work(model: CSR, hist: CSR, sample: int = 1 << 16) -> int:
    """The score updates the native loop makes for the users of ``hist``
    on ``model``: the model-row nnz of every history entry, summed; over
    more than 2 x ``sample`` entries, counted on every k-th entry and
    scaled (a route decision needs no more, at a fraction of the time)."""
    rows = np.concatenate([model.row_nnz(), [0]])    # ids >= n count none
    idx = hist.indices
    sub = idx[::max(1, idx.size // sample)]
    got = int(np.take(rows, sub, mode="clip").sum())
    return round(got * idx.size / max(sub.size, 1))


def native_predict_applicable(n: int, model: CSR | None = None,
                              hist: CSR | None = None) -> bool:
    """True when :func:`predict_topn` routes an unpinned call for an
    ``n``-item catalogue to the native host loop: the JAX package's rule
    (npad at most SLIM_PREDICT_NATIVE_NPAD, default NATIVE_PREDICT_NPAD,
    or, with ``model`` and ``hist`` given, mean(history nnz) x mean(model
    row nnz) below SLIM_PREDICT_NATIVE_ALPHA, default
    NATIVE_PREDICT_ALPHA, x npad) and, with ``model`` and ``hist`` given,
    the host loop's estimated time at most the card's (see
    HOST_S_PER_UPDATE).  Read at call time; never when no C++ compiler is
    found."""
    thr = int(os.environ.get("SLIM_PREDICT_NATIVE_NPAD",
                             NATIVE_PREDICT_NPAD))
    if thr <= 0 or not native.available():
        return False
    npad = bucket_npad(n)
    if model is None or hist is None:
        return npad <= thr
    if npad > thr:
        alpha = float(os.environ.get("SLIM_PREDICT_NATIVE_ALPHA",
                                     NATIVE_PREDICT_ALPHA))
        hbar = hist.nnz / max(hist.nrows, 1)
        rbar = model.nnz / max(model.nrows, 1)
        if not (alpha > 0 and hbar * rbar < alpha * npad):
            return False
    card_s = CARD_S_PER_CALL + npad * npad * (
        CARD_S_PER_CELL + hist.nrows * CARD_S_PER_SCORE)
    return native_predict_work(model, hist) * HOST_S_PER_UPDATE <= card_s


def _score_precision(npad: int, precision=None) -> str:
    """The dense route's scoring precision (the JAX package's
    ``_score_precision``): ``precision`` when given, a name of PRECISIONS
    in any case or an object whose ``.name`` is one
    (``jax.lax.Precision.HIGHEST``); else "highest" up to npad
    _BF16_SCORE_NPAD and "high" above it, where the JAX package takes
    "default".  A single bfloat16 pass (~2^-8 rel a score) moves top-N ids
    the float32 lists hold at 1e-5 rel; the two-half product does not."""
    if precision is None:
        return "highest" if npad <= _BF16_SCORE_NPAD else "high"
    name = getattr(precision, "name", precision)
    if isinstance(name, str) and name.lower() in PRECISIONS:
        return name.lower()
    raise ValueError(f"precision {precision!r}: expected one of "
                     f"{PRECISIONS}, in any case, or an object so named")


def split_bf16(W, halves: int):
    """W (npad, npad) float32 as bfloat16 halves stacked along K: rows
    [0, npad) hold W_hi = bf16(W) and, with ``halves`` 2, rows [npad,
    2 npad) W_lo = bf16(W - W_hi), so that W_hi + W_lo is W within 2^-16
    rel.  The difference is taken in float32 element by element and
    stored as bfloat16, with no temporary as large as W."""
    npad, ncols = W.shape
    Wk = torch.empty((halves * npad, ncols), dtype=torch.bfloat16,
                     device=W.device)
    Wk[:npad].copy_(W)
    if halves == 2:
        torch.sub(W, Wk[:npad], out=Wk[npad:])
    return Wk


# the one kept split of a dense W (_halves_of, utils.kept): (a weak
# reference to W, W's version counter when split, the number of halves,
# the halves)
_SPLIT = {}


def _halves_of(W, halves: int):
    """:func:`split_bf16` of ``W``, made once and kept on W's device while
    W lives unchanged (:func:`~slim_tpu_torch.utils.kept`: the same
    tensor object with the same version counter).  Two kept halves serve
    a one-half call too (its half is the first, byte for byte
    :func:`split_bf16` of one half); a two-half call on one kept half
    splits again.  One split is kept, of the latest W; dropping W frees
    its halves.  A split made is a ``slim.predict.split`` span, a kept
    one served an empty ``slim.predict.split_hit``."""

    def make():
        with span("slim.predict.split"):
            return split_bf16(W, halves)

    Wk, hit = kept(_SPLIT, "W", W, make, halves)
    if not hit:
        return Wk
    with span("slim.predict.split_hit"):
        pass
    return Wk[:halves * W.shape[0]]


def mm_f32(a, b):
    """``a @ b`` of two bfloat16 matrices with float32 products and sums:
    on the card one ``torch.mm`` with ``out_dtype`` float32 (tensor cores,
    float32 accumulation); on the CPU the same operands multiplied in
    float32.  A bfloat16 product is exact in float32, so both differ only
    in the order of the sums."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bf16_exact(hist: CSR) -> bool:
    """True when densifying ``hist`` straight into bfloat16 is exact: every
    value is a bfloat16 value (its low 16 bits are zero) and so is every
    sum the densify makes.  Duplicate ids in a row add: a row whose ids
    strictly ascend has none, and integer values whose row sums of |v|
    are at most 256 keep every partial sum an integer bfloat16 holds."""
    if hist.data is not None and (np.asarray(hist.data, np.float32).view(
            np.uint32) & 0xFFFF).any():
        return False
    idx = hist.indices
    if idx.size < 2:
        return True
    asc = idx[1:] > idx[:-1]
    starts = hist.indptr[1:-1]
    asc[starts[(starts > 0) & (starts < idx.size)] - 1] = True
    if asc.all():
        return True
    v = hist.values()
    if not np.array_equal(v, np.round(v)):
        return False
    cum = np.concatenate([[0.0], np.cumsum(np.abs(v), dtype=np.float64)])
    return bool((cum[hist.indptr[1:]] - cum[hist.indptr[:-1]]).max() <= 256)


def coo_npad() -> int:
    """SLIM_PREDICT_COO_NPAD, read at call time: sparse calls at or above
    this npad take the COO route (0: never)."""
    return int(os.environ.get("SLIM_PREDICT_COO_NPAD", COO_PREDICT_NPAD))


def _wval_bf16() -> bool:
    """SLIM_PREDICT_WVAL_BF16=1, read at call time: the sparse routes keep
    the model's values in bfloat16 (products and sums stay float32)."""
    return os.environ.get("SLIM_PREDICT_WVAL_BF16") == "1"


def densify_model(model: CSR, npad: int | None = None, device=None):
    """Dense (npad, npad) float32 model W on ``device``: the CSR rows are
    densified as runs straight into W's rows (the row-major layout, one
    kernel launch).  Duplicate (row, col) entries accumulate."""
    dev = resolve_device(device)
    n = max(model.nrows, model.ncols)
    npad = npad if npad is not None else bucket_npad(n)
    nr = min(model.nrows, npad)
    rs = np.zeros(npad, np.int64)
    rl = np.zeros(npad, np.int64)
    rs[:nr] = model.indptr[:nr]
    rl[:nr] = np.diff(model.indptr)[:nr]
    idx = model.dev_put("idx32", lambda: model.indices.astype(np.int32), dev)
    val = model.dev_put("val32", lambda: model.values().astype(np.float32),
                        dev)
    return densify_runs(idx, val, rs, rl, npad, npad, torch.empty(
        (npad, npad), dtype=torch.float32, device=dev), row_major=True)


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
        if self.vals is None:
            raise RuntimeError("this DeviceModelPack was freed (free()); "
                               "predict from the model's CSR instead")
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
            M = torch.empty((self.npad, self.npad), dtype=torch.float32,
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

    def free(self):
        """Drop the pack and the cached dense W (the JAX package's
        ``free``): the device memory goes, and :meth:`densify` raises
        after."""
        self.vals = self.idx = self._W = None


def sparsify_model_device(model: CSR, npad: int | None = None, device=None):
    """Padded-row copy of the model on ``device``: (Widx (npad, R) int32,
    Wval (npad, R) float32, or bfloat16 under SLIM_PREDICT_WVAL_BF16=1).
    Row i holds model row i's candidate ids and weights left-aligned,
    padded with (npad-1, 0.0); R is the power-of-two ceiling of the
    longest row.  Built on the device from the flat CSR upload.  Passed
    as ``W_dev`` it routes a call sparse, and only each row's real entries
    are scored."""
    dev = resolve_device(device)
    n = max(model.nrows, model.ncols)
    npad = npad if npad is not None else bucket_npad(n)
    nr = min(model.nrows, npad)
    lens = np.zeros(npad, np.int64)
    lens[:nr] = np.diff(model.indptr)[:nr]
    R = 1 << (max(int(lens.max()), 1) - 1).bit_length()
    vdt = torch.bfloat16 if _wval_bf16() else torch.float32
    Wi = torch.full((npad, R), npad - 1, dtype=torch.int32, device=dev)
    Wv = torch.zeros((npad, R), dtype=vdt, device=dev)
    T = int(model.indptr[nr])
    if T:
        rows = torch.repeat_interleave(
            torch.arange(npad, device=dev), torch.from_numpy(lens).to(dev),
            output_size=T)
        starts = torch.from_numpy(model.indptr[:nr].astype(np.int64)).to(dev)
        pos = torch.arange(T, device=dev) - starts[rows]
        Wi[rows, pos] = model.dev_put(
            "idx32", lambda: model.indices.astype(np.int32), dev)[:T]
        Wv[rows, pos] = model.dev_put(
            "val32", lambda: model.values().astype(np.float32),
            dev)[:T].to(vdt)
    return Wi, Wv


class RowModel:
    """The model's rows on the device as runs of one flat (ids, values)
    pair: row i is ``idx[starts[i]:starts[i] + lens[i]]``.  The sparse
    routes expand a history entry of item i to row i's real entries;
    ``lens_h`` (host) plans their steps."""

    def __init__(self, idx, val, starts, lens_h):
        self.idx, self.val, self.starts = idx, val, starts
        self.lens_h = lens_h
        self.lens = torch.from_numpy(lens_h).to(idx.device)

    @staticmethod
    def of_csr(model: CSR, npad: int, dev) -> "RowModel":
        """The CSR's rows as they are: no padding, uploaded once per
        device (``CSR.dev_put``)."""
        nr = min(model.nrows, npad)
        lens = np.zeros(npad, np.int64)
        starts = np.zeros(npad, np.int64)
        lens[:nr] = np.diff(model.indptr)[:nr]
        starts[:nr] = model.indptr[:nr]
        idx = model.dev_put("idx32", lambda: model.indices.astype(np.int32),
                            dev)
        val = model.dev_put("val32", lambda: model.values().astype(
            np.float32), dev)
        if _wval_bf16():
            val = val.to(torch.bfloat16)
        return RowModel(idx, val, torch.from_numpy(starts).to(dev), lens)

    @staticmethod
    def of_padded(Widx, Wval, npad: int) -> "RowModel":
        """The rows of a :func:`sparsify_model_device` pair: a row's real
        entries are those whose id is not the padding npad-1 (no item
        has that id)."""
        if Widx.shape[0] != npad:
            raise ValueError(f"padded model has {Widx.shape[0]} rows, the "
                             f"call's npad is {npad}")
        R = Widx.shape[1]
        lens = (Widx != npad - 1).sum(dim=1)
        starts = torch.arange(npad, device=Widx.device, dtype=torch.int64) * R
        return RowModel(Widx.reshape(-1), Wval.reshape(-1), starts,
                        lens.cpu().numpy().astype(np.int64))


def _steps(weights, budget: int):
    """Contiguous [a, b) ranges over ``weights`` (host ints), each summing
    to at most ``budget`` unless one weight alone exceeds it."""
    cum = np.cumsum(weights, dtype=np.int64)
    out, a, base = [], 0, 0
    while a < cum.size:
        b = max(int(np.searchsorted(cum, base + budget, side="right")), a + 1)
        out.append((a, b))
        base, a = int(cum[b - 1]), b
    return out


def _block_topn(sc, nrcmds):
    """Top-N of a masked score block: ids (-1 past the count), scores (0
    past it) and the count min(#(score > 0), nrcmds)."""
    cnt = (sc > 0).sum(dim=1).clamp(max=nrcmds)
    top_sc, top_id = topk_lowest_id(sc, nrcmds)
    ok = torch.arange(nrcmds, device=sc.device)[None, :] < cnt[:, None]
    return torch.where(ok, top_id, -1), torch.where(ok, top_sc, 0.0), cnt


def _user_block(npad: int, user_block: int) -> int:
    """Users per dense score block: up to 4x ``user_block``, bounded so
    one score block stays within SCORE_BLOCK_BYTES."""
    fit = max(8, SCORE_BLOCK_BYTES // (npad * 4))
    return max(user_block, min(4 * user_block, 1 << (fit.bit_length() - 1)))


class _Route:
    """Where one call scores: the dense ``W`` at ``precision`` (float32 at
    "highest", else W's bfloat16 halves by :func:`_halves_of`, which keeps
    those of a W that outlives the call), or the sparse ``rows``
    by score rows or, with ``coo``, by sorted pairs (float32 sums whatever
    the precision); ``route`` names it ("dense", "rows" or "coo"), and its
    set-up (the model's densify and split, or its rows and the history's
    upload) is a ``slim.predict.<route>`` span.  A
    :class:`DeviceModelPack` whose npad is not the call's is ignored (the
    model is uploaded), as in the JAX package (predict.py:1122-1125)."""

    def __init__(self, model: CSR, hist: CSR, W_dev, sparse, device,
                 precision=None):
        self.n = n = max(model.nrows, model.ncols, hist.ncols)
        self.npad = npad = bucket_npad(n)
        self.precision = _score_precision(npad, precision)
        if isinstance(W_dev, DeviceModelPack):
            dev = W_dev.device
            if W_dev.npad != npad:
                W_dev = None
        elif isinstance(W_dev, tuple):
            dev = W_dev[0].device
        else:
            dev = resolve_device(device) if W_dev is None else W_dev.device
        self.dev = dev
        if sparse is None:
            sparse = isinstance(W_dev, tuple) or (
                W_dev is None and npad > SPARSE_PREDICT_THRESHOLD)
        pin_f32()
        self.W = self.rows = None
        self.coo = bool(sparse) and 0 < coo_npad() <= npad
        self.route = "coo" if self.coo else ("rows" if sparse else "dense")
        with span(f"slim.predict.{self.route}"):
            if not sparse:
                if isinstance(W_dev, DeviceModelPack):
                    W = W_dev.densify()
                elif torch.is_tensor(W_dev):
                    W = W_dev
                else:
                    W = densify_model(model, npad, dev)
                self.W = W if self.precision == "highest" else _halves_of(
                    W, 2 if self.precision == "high" else 1)
                return
            self.rows = RowModel.of_padded(*W_dev, npad) \
                if isinstance(W_dev, tuple) \
                else RowModel.of_csr(model, npad, dev)
            # the history's entries on the device, and each entry's
            # model-row length on the host (0 for ids >= n, the guard of
            # predict.c:35)
            self.c = hist.dev_put(
                "idx32", lambda: hist.indices.astype(np.int32), dev)
            self.v = None if hist.data is None else hist.dev_put(
                "val32", lambda: hist.values().astype(np.float32), dev)
            self.u = hist.dev_put("row32", lambda: np.repeat(
                np.arange(hist.nrows, dtype=np.int32), np.diff(hist.indptr)),
                dev)
            self.ok_h = hist.indices < n
            self.L_h = np.where(
                self.ok_h,
                self.rows.lens_h[np.minimum(hist.indices, npad - 1)], 0)

    def pairs(self, a: int, b: int, u0: int):
        """The (history entry, model entry) pairs of entries [a, b): each
        pair's key (user - u0) * npad + candidate (int64) and weight
        (float32)."""
        rows, dev = self.rows, self.dev
        P = int(self.L_h[a:b].sum())
        c = self.c[a:b].long()
        c = torch.where(c < self.n, c, 0)
        L = torch.from_numpy(self.L_h[a:b]).to(dev)
        e = torch.repeat_interleave(torch.arange(b - a, device=dev), L,
                                    output_size=P)
        flat = torch.arange(P, device=dev)
        flat -= (torch.cumsum(L, 0) - L)[e]
        flat += rows.starts[c][e]
        cand = rows.idx[flat]
        w = rows.val[flat].float()
        del flat
        if self.v is not None:
            w *= self.v[a:b][e]
        key = self.u[a:b].long()[e]
        key -= u0
        key *= self.npad
        key += cand
        return key, w

    def history_keys(self, a: int, b: int, u0: int):
        """(user - u0) * npad + item of entries [a, b) with item < n."""
        c = self.c[a:b].long()
        return ((self.u[a:b].long() - u0) * self.npad + c)[c < self.n]

    def score_blocks(self, hist: CSR, user_block: int, mask: bool):
        """(users (host ids), float32 (len(users), npad) scores) per user
        block of the dense or score-row route; with ``mask`` the history
        items score -inf."""
        if self.W is not None:
            yield from self._dense_blocks(hist, user_block, mask)
            return
        npad = self.npad
        fit = max(1, SCORE_BLOCK_BYTES // (npad * 4))
        ub = max(1, min(user_block, 1 << (fit.bit_length() - 1)))
        budget = STEP_BYTES // PAIR_BYTES
        for u0 in range(0, hist.nrows, ub):
            u1 = min(u0 + ub, hist.nrows)
            sc = torch.zeros((u1 - u0, npad), dtype=torch.float32,
                             device=self.dev)
            flat = sc.view(-1)
            e0, e1 = int(hist.indptr[u0]), int(hist.indptr[u1])
            for a, b in _steps(self.L_h[e0:e1], budget):
                flat.index_add_(0, *self.pairs(e0 + a, e0 + b, u0))
            if mask:
                flat.index_fill_(0, self.history_keys(e0, e1, u0),
                                 float("-inf"))
            yield np.arange(u0, u1), sc

    def _dense_blocks(self, hist: CSR, user_block: int, mask: bool):
        # users in history-length order so each block's entry width is tight
        n, npad, dev = self.n, self.npad, self.dev
        row_nnz = hist.row_nnz().astype(np.int64)
        order = np.argsort(-row_nnz, kind="stable")
        ones = hist.data is None
        idx = hist.dev_put("idx32", lambda: hist.indices.astype(np.int32),
                           dev)
        val = None if ones else hist.dev_put(
            "val32", lambda: hist.values().astype(np.float32), dev)
        # the bfloat16 routes densify straight to bfloat16 where that is
        # exact (the JAX package's _get_predict_densify), else to float32
        # and split there
        straight = self.precision != "highest" and bf16_exact(hist)
        ub = _user_block(npad, user_block)
        for u0 in range(0, hist.nrows, ub):
            users = order[u0:u0 + ub]
            rs, rl = hist.indptr[users], row_nnz[users]
            if self.precision == "highest":
                hdT = densify_runs(idx, val, rs, rl, npad, n, torch.empty(
                    (npad, len(users)), dtype=torch.float32, device=dev))
                sc = hdT.T @ self.W                        # (users, npad)
            else:
                hdT, sc = self._bf16_block(idx, val, rs, rl, straight)
            if mask:
                maskT = hdT > 0 if ones else densify_runs(
                    idx, None, rs, rl, npad, n, torch.empty(
                        (npad, len(users)), dtype=torch.int8,
                        device=dev)) > 0
                sc.masked_fill_(maskT.T, float("-inf"))
            yield users, sc

    def _bf16_block(self, idx, val, rs, rl, straight: bool):
        """(the block's densified histories, its float32 scores) on the
        bfloat16 halves ``self.W``: with one half (``"default"``) h_hi
        W_hi, with two (``"high"``) [h_hi | h_hi] [W_hi ; W_lo] as one
        product over the stacked K, plus h_lo W_hi where the histories are
        not exact in bfloat16 (``straight`` False)."""
        n, npad, dev = self.n, self.npad, self.dev
        K = self.W.shape[0] // npad
        H = torch.empty((K * npad, len(rl)), dtype=torch.bfloat16,
                        device=dev)
        if straight:
            hdT = densify_runs(idx, val, rs, rl, npad, n, H[:npad])
        else:
            hdT = densify_runs(idx, val, rs, rl, npad, n, torch.empty(
                (npad, len(rl)), dtype=torch.float32, device=dev))
            H[:npad].copy_(hdT)
        if K == 2:
            H[npad:].copy_(H[:npad])
        sc = mm_f32(H.T, self.W)                           # (users, npad)
        if K == 2 and not straight:
            sc += mm_f32((hdT - H[:npad].float()).bfloat16().T,
                         self.W[:npad])
        return hdT, sc

    def coo_runs(self, hist: CSR, exclude: bool):
        """(u0, u1, keys, sums) per step of the COO route: the sorted
        distinct keys (user - u0) * npad + candidate of users [u0, u1) and
        each key's summed weight.  Users are grouped so one step's pairs
        fit STEP_BYTES (a user whose pairs alone exceed it is a step of its
        own).  With ``exclude`` each history item adds a HISTORY_MARK
        pair."""
        per_entry = self.L_h + (self.ok_h if exclude else 0)
        cum = np.concatenate([[0], np.cumsum(per_entry, dtype=np.int64)])
        per_user = cum[hist.indptr[1:]] - cum[hist.indptr[:-1]]
        for u0, u1 in _steps(per_user, STEP_BYTES // PAIR_BYTES):
            e0, e1 = int(hist.indptr[u0]), int(hist.indptr[u1])
            key, w = self.pairs(e0, e1, u0)
            if exclude:
                hk = self.history_keys(e0, e1, u0)
                key = torch.cat([key, hk])
                w = torch.cat([w, torch.full(hk.shape, HISTORY_MARK,
                                             device=self.dev)])
            keys, inv = torch.unique(key, sorted=True, return_inverse=True)
            del key
            sums = torch.zeros(keys.shape[0], dtype=torch.float32,
                               device=self.dev).index_add_(0, inv, w)
            yield u0, u1, keys, sums


def _coo_topn(keys, sums, U: int, npad: int, nrcmds: int):
    """Top-N of U users from their COO runs: a stable sort by -sum then by
    user orders each user's runs by (score desc, id asc), since the keys
    ascend; counts are the runs with sum > 0 (history runs are < 0)."""
    dev = keys.device
    ids = torch.full((U, nrcmds), -1, dtype=torch.int64, device=dev)
    sc = torch.zeros((U, nrcmds), dtype=torch.float32, device=dev)
    cnt = torch.zeros(U, dtype=torch.int64, device=dev)
    N = keys.numel()
    if N == 0:
        return ids, sc, cnt
    user = keys // npad
    o = torch.sort(-sums, stable=True).indices
    o = o[torch.sort(user[o], stable=True).indices]
    start = torch.searchsorted(user[o], torch.arange(U, device=dev))
    cnt.index_add_(0, user, (sums > 0).long())
    cnt.clamp_(max=nrcmds)
    t = o[(start[:, None] + torch.arange(nrcmds, device=dev)).clamp(
        max=N - 1)]
    ok = torch.arange(nrcmds, device=dev)[None, :] < cnt[:, None]
    return (torch.where(ok, keys[t] % npad, ids),
            torch.where(ok, sums[t], sc), cnt)


def _coo_join(keys, sums, cand, n: int, npad: int):
    """Each candidate's summed score from U users' COO runs (0 where no
    pair reached it or the id is outside [0, n)), and each user's count of
    runs with sum > 0."""
    U = cand.shape[0]
    dev = keys.device
    ok = (cand >= 0) & (cand < n)
    q = torch.where(ok, torch.arange(U, device=dev)[:, None] * npad
                    + cand.long().clamp(0, npad - 1), -1)
    ns = torch.zeros(U, dtype=torch.int64, device=dev)
    if keys.numel() == 0:
        return torch.zeros(cand.shape, dtype=torch.float32, device=dev), ns
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    cs = torch.where(keys[pos] == q, sums[pos], 0.0)
    ns.index_add_(0, keys // npad, (sums > 0).long())
    return cs, ns


def _gather_scores(sc, cd, n: int):
    """Scores of the candidates ``cd`` (U, C) from score rows; ids outside
    [0, n) score 0."""
    g = sc.gather(1, cd.long().clamp(0, sc.shape[1] - 1))
    return torch.where((cd >= 0) & (cd < n), g, 0.0)


def predict_topn(model: CSR, hist: CSR, nrcmds: int = 10,
                 user_block: int = 1024, W_dev=None, sparse=None,
                 precision=None, scan=None, device=None):
    """Top-N for every user row of ``hist``.

    Returns (ids (nusers, nrcmds) int32 with -1 padding, scores (nusers,
    nrcmds) float32, counts (nusers,) int32).  ``W_dev``: a dense device
    model from :func:`densify_model` to reuse across calls, a
    :class:`DeviceModelPack`, or a :func:`sparsify_model_device` pair
    (which routes sparse).  ``sparse`` pins the route (default: sparse
    above SPARSE_PREDICT_THRESHOLD); ``precision`` the dense route's
    scoring ("default", "high" or "highest", or ``jax.lax.Precision``'s
    member of that name; default :func:`_score_precision`'s npad rule);
    ``scan`` is accepted and ignored.  At "high" or "default" a dense
    ``W_dev`` (or a pack's dense W) keeps its bfloat16 halves on the
    device while it lives unchanged, as much memory again as a float32 W
    at "high" and half that at "default"; dropping W frees them
    (:func:`_halves_of`).  A call that pins nothing (no
    ``W_dev``, ``sparse``, ``precision`` or ``scan``) and that
    :func:`native_predict_applicable` accepts scores on the host by the
    native loop, whatever ``device`` is.

    The call is a ``slim.predict`` span holding its route's set-up span
    (``slim.predict.native``, ``.dense``, ``.rows`` or ``.coo``), a
    ``slim.predict.block`` span for each user block's launches and a
    ``slim.wait.lists`` span for each block's copies to the host."""
    global last_route, last_precision
    with span("slim.predict"):
        n = max(model.nrows, model.ncols, hist.ncols)
        if W_dev is None and sparse is None and scan is None \
                and precision is None \
                and native_predict_applicable(n, model, hist):
            logger.info("predict_topn: %d users of a %d-item catalogue on "
                        "the native host route", hist.nrows, n)
            last_route, last_precision = "native", None
            with span("slim.predict.native"):
                return native.predict_topn(model, hist, nrcmds=nrcmds)
        r = _Route(model, hist, W_dev, sparse, device, precision)
        last_route = r.route
        last_precision = r.precision if r.W is not None else None
        nusers = hist.nrows
        ids = np.full((nusers, nrcmds), -1, np.int32)
        scores = np.zeros((nusers, nrcmds), np.float32)
        counts = np.zeros(nusers, np.int32)
        if nusers == 0:
            return ids, scores, counts
        if r.coo:
            blocks = ((slice(u0, u1), _coo_topn(keys, sums, u1 - u0,
                                                r.npad, nrcmds))
                      for u0, u1, keys, sums in r.coo_runs(hist,
                                                            exclude=True))
        else:
            blocks = ((users, _block_topn(sc, nrcmds))
                      for users, sc in r.score_blocks(hist, user_block, True))
        for users, (i, s, c) in _spanned(blocks, "slim.predict.block"):
            with span("slim.wait.lists"):
                ids[users] = i.to(torch.int32).cpu().numpy()
                scores[users] = s.cpu().numpy()
                counts[users] = c.to(torch.int32).cpu().numpy()
        return ids, scores, counts


def _spanned(items, name: str):
    """The items of the iterable ``items``, the making of each (a user
    block's densify, products and top-k launches) inside a span ``name``;
    one more, empty, span ends the iteration."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, None)
        if item is None:
            return
        yield item


def _check_cand(hist: CSR, cand):
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if cand.ndim != 2 or cand.shape[0] != hist.nrows:
        raise ValueError(f"candidates {cand.shape} do not match the "
                         f"{hist.nrows} history rows")
    return cand


def predict_candidate_scores(model: CSR, hist: CSR, cand, W_dev=None,
                             user_block: int = 1024, sparse=None,
                             device=None):
    """Scores of an explicit candidate list per user with the history
    excluded: the core of the neg-file mode (slim_predict.c:110-143:
    GetTopN over all items, then a candidate keeps its score if it was
    scored, else 0).

    ``cand`` is (nusers, C) int32 with -1 padding.  Returns (cscores
    (nusers, C) float32, 0 for unscored, -1, out-of-range and history
    candidates; nscored (nusers,) int32, the user's count of items with
    score > 0 over all items, which truncates the final list).  Scores at
    "highest" at every npad, as the JAX package does."""
    r = _Route(model, hist, W_dev, sparse, device, "highest")
    cand = _check_cand(hist, cand)
    out_cs = np.zeros(cand.shape, np.float32)
    out_ns = np.zeros(hist.nrows, np.int32)
    if hist.nrows == 0:
        return out_cs, out_ns
    if r.coo:
        cand_d = torch.from_numpy(cand).to(r.dev)
        for u0, u1, keys, sums in r.coo_runs(hist, exclude=True):
            cs, ns = _coo_join(keys, sums, cand_d[u0:u1], r.n, r.npad)
            out_cs[u0:u1] = cs.clamp(min=0.0).cpu().numpy()
            out_ns[u0:u1] = ns.to(torch.int32).cpu().numpy()
        return out_cs, out_ns
    for users, sc in r.score_blocks(hist, user_block, True):
        cs = _gather_scores(sc, torch.from_numpy(cand[users]).to(r.dev), r.n)
        out_cs[users] = cs.clamp(min=0.0).cpu().numpy()
        out_ns[users] = (sc > 0).sum(dim=1).to(torch.int32).cpu().numpy()
    return out_cs, out_ns


def predict_topn_1vsk(model: CSR, hist: CSR, negitems, nrcmds: int = 10,
                      W_dev=None, user_block: int = 1024, sparse=None,
                      device=None):
    """1-vs-k candidate-restricted prediction (GetRec_1vsk,
    predict.c:77-133): the top min(nrcmds, nnegs) of each user's
    candidates ``negitems`` (nusers, nnegs), equal scores at the lowest
    candidate position first.  The history is not excluded; out-of-range
    ids score 0 and keep their slot (predict.c:97-106).  Returns (ids,
    scores, counts), counts being the full width.  Scores at "highest" at
    every npad, as the JAX package does."""
    r = _Route(model, hist, W_dev, sparse, device, "highest")
    neg = _check_cand(hist, negitems)
    kk = min(nrcmds, neg.shape[1])
    ids = np.full((hist.nrows, kk), -1, np.int32)
    scores = np.zeros((hist.nrows, kk), np.float32)
    counts = np.full(hist.nrows, kk, np.int32)
    if hist.nrows == 0 or kk == 0:
        return ids, scores, counts
    neg_d = torch.from_numpy(neg).to(r.dev)
    if r.coo:
        blocks = ((slice(u0, u1), neg_d[u0:u1],
                   _coo_join(keys, sums, neg_d[u0:u1], r.n, r.npad)[0])
                  for u0, u1, keys, sums in r.coo_runs(hist, exclude=False))
    else:
        blocks = ((users, neg_d[users], _gather_scores(sc, neg_d[users],
                                                       r.n))
                  for users, sc in r.score_blocks(hist, user_block, False))
    for users, cd, cs in blocks:
        top_sc, pos = topk_lowest_id(cs, kk)
        ids[users] = cd.gather(1, pos).cpu().numpy()
        scores[users] = top_sc.cpu().numpy()
    return ids, scores, counts
