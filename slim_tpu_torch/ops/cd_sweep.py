"""CD sweep kernels and the block-solve loops around them (port of
slim_tpu/ops/pallas_cd.py).

Two CUDA engines carry four entry points:

* :func:`cd_sweep` (csrc/sweep_panel.cu at a group width of 128) replaces
  ``_sweep_kernel`` / ``pallas_cd_sweeps``: row-major (B, npad) operands,
  128-wide chunks in ``perm`` order, chunks with ``has == 0`` skipped,
  every chunk's deltas flushed to all of q before the next chunk starts,
  in bf16x3 on the tensor cores as below.
* :func:`cd_sweep_large` (csrc/sweep_large.cu) replaces
  ``_sweep_kernel_large_v4`` / ``pallas_cd_sweep_large_v4``:
  coordinate-major (npad, B) operands, ``GROUP``-wide groups in ``perm``
  order, the q flush deferred over windows of K_FLUSH groups as in the TPU
  kernel (each group's q tile corrected on load, one flush per window; the
  last window may be partial).  Its products run on the tensor cores in
  bf16x3: G and the deltas are each split into two bfloat16 halves
  (:func:`split_bf16`, made once per G) and three products are summed in
  float32.  The TPU kernel's live-panel list (``panarr``) is not kept.
  Its window flush is a kernel of its own (:func:`flush_window` runs one
  window alone, at the tile width :func:`flush_tile_n` picks).
* :func:`cd_sweep_v3` and :func:`cd_sweep_eager` (csrc/sweep_panel.cu)
  replace ``_sweep_kernel_large_v3`` / ``pallas_cd_sweep_large_v3`` and
  ``_sweep_kernel_large`` / ``pallas_cd_sweep_large``: row-major
  operands, ``GROUP``-wide groups in ``perm`` order, each group's q tile
  corrected on load by the pending deltas of its window and its deltas
  flushed to all of q at the window's end.  The window is K_FLUSH groups
  for v3 and one group for eager; the products run in bf16x3 on the
  tensor cores as in the v4 counterpart, reading G's rows for its columns
  (G is symmetric).

One call = one sweep: for each active group or chunk a Gauss-Seidel chain
over its coordinates (masked by active * live) and the propagation of its
deltas to q; at the end a column dies when Σdx² < optTol or
``t0 + 1 >= cap``.  Each entry has a plain PyTorch version used for CPU
tensors and as the on-card reference.

:func:`solve_core` is the counterpart of ``pallas_solve_core``;
:func:`solve_large_core` and :func:`solve_panel_core` of
``pallas_solve_large_core`` with the v4 and the v3 / eager sweep: a
Python loop of one launch per sweep that carries live / converged /
niters exactly as the JAX while-loops do.  Each sweep is a
``slim.cd.sweep`` span (its host work and launches), the liveness check
that ends it a ``slim.wait.live`` span inside it, and the start's sweep
bound a ``slim.wait.tmax`` span.  :func:`pick_large_variant`
chooses among the three wide-block sweeps as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..utils import kept, span
from . import _build
from .cd_kernel import CHUNK, block_stats

GROUP = 512      # coordinates per group of the large sweep
K_FLUSH = 4      # groups per deferred-flush window (v4 and v3 sweeps)


def q_refresh() -> int:
    """Sweeps between exact q = x G refreshes of the group sweeps, read
    from SLIM_PALLAS_QREFRESH at call time (default 8); 0 or less means
    never refresh."""
    n = int(os.environ.get("SLIM_PALLAS_QREFRESH", "8"))
    return n if n > 0 else 1 << 30


SPLIT_ROWS = 2048   # rows of G a split step takes (its float32 temporaries)


def split_bf16(G):
    """G = hi + lo to about 2^-17 relative: hi = bf16(G), lo = bf16(G - hi),
    the operands of the large sweep's bf16x3 tensor-core products.  Made
    SPLIT_ROWS rows at a time, so the float32 temporaries of G - hi stay
    small beside G and its halves (at npad 94,208 each whole one would be
    as large as G, 33 GiB)."""
    hi = torch.empty(G.shape, dtype=torch.bfloat16, device=G.device)
    lo = torch.empty_like(hi)
    for r0 in range(0, G.shape[0], SPLIT_ROWS):
        g = G[r0:r0 + SPLIT_ROWS]
        h = hi[r0:r0 + SPLIT_ROWS]
        h.copy_(g)
        lo[r0:r0 + SPLIT_ROWS] = g - h.to(torch.float32)
    return hi, lo


_SPLIT = {}   # the one kept split of G (utils.kept)


def _split_of(G):
    """:func:`split_bf16` of ``G``, made once and kept while G lives
    unchanged (same object, same version counter): G is loop-invariant
    across the sweeps of a solve and the blocks of a learn."""
    return kept(_SPLIT, "G", G, lambda: split_bf16(G))[0]


def drop_split(G) -> None:
    """Free the kept split of ``G`` now, where the caller knows that no
    later sweep reads it (a learn past its last full-width block): only
    the moment of release changes, the slot stays :func:`_split_of`'s."""
    hit = _SPLIT.get("G")
    if hit is not None and hit[0]() is G:
        _SPLIT.clear()


def _gs_chain(gjl, xl, ql, okf, d, gcc, l1, l2):
    """Gauss-Seidel chain over one 128-wide chunk: returns dx (B, CHUNK);
    ``ql`` (the chunk's q) is scratch, updated in place."""
    dx = torch.zeros_like(xl)
    for i in range(CHUNK):
        num = gjl[:, i] - ql[:, i] + d[i] * xl[:, i]
        cand = torch.clamp(num - l1, min=0.0) / (d[i] + l2)
        delta = okf[:, i] * (cand - xl[:, i])
        ql += delta[:, None] * gcc[i][None, :]
        dx[:, i] = delta
    return dx


def _plain_chunks(G, gj, act, x, q, lv, diag, l1, l2, chunks):
    """Row-major sweep body over ``chunks`` (ids in visit order): updates
    x, q in place and returns Σdx² per column."""
    B = gj.shape[0]
    dltx = torch.zeros(B, dtype=torch.float32, device=gj.device)
    for c in chunks:
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        okf = act[:, sl].to(torch.float32) * lv[:, None]
        dx = _gs_chain(gj[:, sl], x[:, sl], q[:, sl].clone(), okf, diag[sl],
                       G[sl, sl], l1, l2)
        x[:, sl] += dx
        q += dx @ G[sl]
        dltx += (dx * dx).sum(dim=1)
    return dltx


def _end_of_sweep(lv, dltx, cap, t0, tol):
    keep = (dltx >= tol) & (t0 + 1.0 < cap)
    return lv * keep.to(torch.float32)


def _chunk_order(perm, has, cpg):
    """Host list of the chunks to run: each perm entry covers cpg chunks."""
    return [p * cpg + s for p, h in zip(perm.tolist(), has.tolist()) if h
            for s in range(cpg)]


def cd_sweep_plain(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """Plain PyTorch version of :func:`cd_sweep` (same contract)."""
    x, q = x.clone(), q.clone()
    lv = live[:, 0]
    l1, l2, cap, t0, tol = regs.unbind(dim=1)
    dltx = _plain_chunks(G, gj, act, x, q, lv, diag2d[0], l1, l2,
                         _chunk_order(perm.reshape(-1), has.reshape(-1), 1))
    lo = _end_of_sweep(lv, dltx, cap, t0, tol)
    return x, q, lo[:, None], lv[:, None].clone(), dltx[:, None]


def cd_sweep_large_plain(G, gjT, actT, xT, qT, live, diag2d, regsT, perm,
                         has):
    """Plain PyTorch version of :func:`cd_sweep_large` (same contract)."""
    x, q = xT.T.contiguous(), qT.T.contiguous()
    lv = live[0]
    l1, l2, cap, t0, tol = regsT.unbind(dim=0)
    dltx = _plain_chunks(G, gjT.T, actT.T, x, q, lv, diag2d[0], l1, l2,
                         _chunk_order(perm, has, GROUP // CHUNK))
    lo = _end_of_sweep(lv, dltx, cap, t0, tol)
    return (x.T.contiguous(), q.T.contiguous(), lo[None, :],
            lv[None, :].clone(), dltx[None, :])


def _plain_panel(G, gj, act, x, q, live, diag2d, regs, perm, has, K):
    """Row-major group sweep with the q flush deferred over K-group windows
    (the contract of :func:`cd_sweep_v3` / :func:`cd_sweep_eager`)."""
    x, q = x.clone(), q.clone()
    B = gj.shape[0]
    lv, d = live[:, 0], diag2d[0]
    l1, l2, cap, t0, tol = regs.unbind(dim=1)
    dX = torch.zeros((K, B, GROUP), dtype=torch.float32, device=gj.device)
    dltx = torch.zeros(B, dtype=torch.float32, device=gj.device)
    perm, has = perm.reshape(-1).tolist(), has.reshape(-1).tolist()

    def rows(k):
        return G[perm[k] * GROUP:(perm[k] + 1) * GROUP]

    for pos, g in enumerate(perm):
        slot = pos % K
        win = [(k, pos - slot + k) for k in range(K) if has[pos - slot + k]]
        gsl = slice(g * GROUP, (g + 1) * GROUP)
        if has[pos]:
            qt = q[:, gsl].clone()
            for k, wp in win:
                if k < slot:
                    qt += dX[k] @ rows(wp)[:, gsl]
            okf = act[:, gsl].to(torch.float32) * lv[:, None]
            for o in range(0, GROUP, CHUNK):
                a = g * GROUP + o
                sl = slice(a, a + CHUNK)
                dx = _gs_chain(gj[:, sl], x[:, sl], qt[:, o:o + CHUNK].clone(),
                               okf[:, o:o + CHUNK], d[sl], G[sl, sl], l1, l2)
                dX[slot, :, o:o + CHUNK] = dx
                x[:, sl] += dx
                qt[:, o + CHUNK:] += dx @ G[sl, a + CHUNK:(g + 1) * GROUP]
            dltx += (dX[slot] * dX[slot]).sum(dim=1)
        if slot == K - 1:
            for k, wp in win:
                q += dX[k] @ rows(wp)
    lo = _end_of_sweep(lv, dltx, cap, t0, tol)
    return x, q, lo[:, None], lv[:, None].clone(), dltx[:, None]


def cd_sweep_v3_plain(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """Plain PyTorch version of :func:`cd_sweep_v3` (same contract)."""
    return _plain_panel(G, gj, act, x, q, live, diag2d, regs, perm, has,
                        K_FLUSH)


def cd_sweep_eager_plain(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """Plain PyTorch version of :func:`cd_sweep_eager` (same contract)."""
    return _plain_panel(G, gj, act, x, q, live, diag2d, regs, perm, has, 1)


def _check(G, gj, act, x, q, live, diag2d, regs, perm, has, npad, B, group):
    f32 = (G, gj, x, q, live, diag2d, regs)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in f32):
        raise ValueError("G/gj/x/q/live/diag/regs must be contiguous float32")
    if act.dtype != torch.int8 or not act.is_contiguous() \
            or act.shape != gj.shape:
        raise ValueError("act must be contiguous int8 shaped like gj")
    if G.shape != (npad, npad) or x.shape != gj.shape or q.shape != gj.shape:
        raise ValueError("G must be (npad, npad); x/q shaped like gj")
    if npad % group or group % CHUNK:
        raise ValueError(f"npad {npad} must be a multiple of {group}")
    if perm.dtype != torch.int32 or has.dtype != torch.int32 \
            or perm.numel() != npad // group or has.numel() != perm.numel():
        raise ValueError("perm/has must be int32 with one entry per "
                         "chunk/group")
    if live.numel() != B or regs.numel() != 5 * B or diag2d.numel() != npad:
        raise ValueError("live (B), regs (5B), diag (npad) sizes")
    if len({t.device for t in (*f32, act, perm, has)}) != 1:
        raise ValueError("all sweep operands must be on one device")


def _outputs(x, q, live):
    """The kernels update x and q in place: fresh copies of both, and the
    live', nit and (zeroed) dltx buffers."""
    return (x.clone(), q.clone(), torch.empty_like(live),
            torch.empty_like(live), torch.zeros_like(live))


def _launch(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """One call of csrc/sweep_panel.cu's whole-array sweep; the chunk's
    deltas wait in bf16 halves (B, CHUNK)."""
    B, npad = gj.shape
    xo, qo, lo, nit, dltx = _outputs(x, q, live)
    gh, gl = _split_of(G)
    dh = torch.empty(B * CHUNK, dtype=torch.bfloat16, device=x.device)
    dl = torch.empty_like(dh)
    perm, has = perm.contiguous(), has.contiguous()
    _build.check(_build.lib().slim_cd_sweep(
        G.data_ptr(), gh.data_ptr(), gl.data_ptr(), gj.data_ptr(),
        act.data_ptr(), diag2d.data_ptr(), xo.data_ptr(), qo.data_ptr(),
        live.data_ptr(), regs.data_ptr(), perm.data_ptr(), has.data_ptr(),
        perm.numel(), B, npad, dh.data_ptr(), dl.data_ptr(), lo.data_ptr(),
        nit.data_ptr(), dltx.data_ptr(), _build.stream_ptr(x.device)),
        "slim_cd_sweep")
    return xo, qo, lo, nit, dltx


def _window_scratch(G, K, B, dev):
    """The bf16 halves of G (made once per G) and a windowed group sweep's
    scratch: the group's q tile (GROUP * B floats) and the window's deltas
    as bf16 halves Dh / Dl (K, B, GROUP); a slot is read only after its
    group has written it."""
    gh, gl = _split_of(G)
    tile = torch.empty(GROUP * B, dtype=torch.float32, device=dev)
    dh = torch.empty(K * B * GROUP, dtype=torch.bfloat16, device=dev)
    return gh, gl, tile, dh, torch.empty_like(dh)


# The flush's time per column of a 128-wide tile over a 256-wide one: on an
# H100 at npad 28672, B 1024, a sweep's 14 window flushes took 8.71 ms at
# 128 and 7.65 ms at 256 (128 operations a staged byte against 192)
_FLUSH_COST_128 = 1.14


def flush_tile_n(M: int, N: int, clusters: int) -> int:
    """Output tile width (256 or 128 columns) of the window flush on an
    (M, N) q, when ``clusters`` clusters of two 128-row tiles run at once
    (one block per SM): the width whose persistent waves take the least
    time, each wave as long as one tile of its width, so that a last wave
    that leaves many SMs idle counts in full; 256 on a tie."""
    def waves_time(bn, cost):
        pairs = M // 256 * -(-N // bn)
        return -(-pairs // clusters) * bn * cost

    return 256 if waves_time(256, 1.0) <= waves_time(128, _FLUSH_COST_128) \
        else 128


@functools.cache
def _flush_clusters() -> int:
    """Clusters of the flush that the card holds at once."""
    n = _build.lib().slim_flush_clusters()
    if n <= 0:
        raise RuntimeError("slim_flush_clusters: the flush kernel does not "
                           "fit on this card")
    return n


def _flush_bn(M, N):
    """:func:`flush_tile_n` for the card this process runs on."""
    return flush_tile_n(M, N, _flush_clusters())


def flush_window_plain(gh, gl, dh, dl, perm, has, qT, g0, nslots):
    """Plain PyTorch version of :func:`flush_window` (same contract)."""
    npad, B = qT.shape
    dh, dl = dh.reshape(K_FLUSH, B, GROUP), dl.reshape(K_FLUSH, B, GROUP)
    perm, has = perm.tolist(), has.tolist()
    for s in range(nslots):
        if has[g0 + s]:
            c = perm[g0 + s] * GROUP
            ah, al = gh[:, c:c + GROUP].float(), gl[:, c:c + GROUP].float()
            bh, bl = dh[s].float(), dl[s].float()
            qT += ah @ bh.T + ah @ bl.T + al @ bh.T
    return qT


def flush_window(gh, gl, dh, dl, perm, has, qT, g0, nslots,
                 feed_only=False):
    """One window's flush of the coordinate-major sweep, alone: qT (npad,
    B) += sum over the slots s < nslots with has[g0 + s] of G[:, group
    perm[g0 + s]'s columns] . D_s^T in bf16x3 (Gh.Dh + Gh.Dl + Gl.Dh, f32
    sums); gh / gl (npad, npad) and dh / dl (K_FLUSH * B * GROUP, the
    (slot, column, coordinate) layout) bfloat16.  Updates qT in place and
    returns it.  ``feed_only`` (card only) runs the kernel's TMA ring with
    no product and no access to q: the feed's time alone."""
    npad, B = qT.shape
    if qT.device.type == "cpu":
        if feed_only:
            raise ValueError("flush_window: feed_only times the card's "
                             "ring and has no CPU version")
        return flush_window_plain(gh, gl, dh, dl, perm, has, qT, g0, nslots)
    if qT.device.type != "cuda":
        raise ValueError(f"flush_window: unsupported device {qT.device}")
    halves = (gh, gl, dh, dl)
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           for t in halves) or qT.dtype != torch.float32 \
            or not qT.is_contiguous() or gh.shape != (npad, npad) \
            or dh.numel() != K_FLUSH * B * GROUP or npad % GROUP:
        raise ValueError("flush_window: bf16 halves G (npad, npad), D "
                         "(K_FLUSH * B * GROUP), contiguous f32 qT (npad, "
                         "B), npad a multiple of GROUP")
    perm = perm.to(torch.int32).contiguous()
    has = has.to(torch.int32).contiguous()
    _build.check(_build.lib().slim_flush(
        gh.data_ptr(), gl.data_ptr(), dh.data_ptr(), dl.data_ptr(),
        perm.data_ptr(), has.data_ptr(), qT.data_ptr(), npad, B, g0, nslots,
        _flush_bn(npad, B), int(feed_only), _build.stream_ptr(qT.device)),
        "slim_flush")
    return qT


def _launch_large(G, gjT, actT, xT, qT, live, diag2d, regsT, perm, has, B,
                  npad):
    """One call of csrc/sweep_large.cu (the q tile qg is (GROUP, B));
    returns the outputs and the number of flush launches enqueued."""
    xo, qo, lo, nit, dltx = _outputs(xT, qT, live)
    dev = xT.device
    gh, gl, qg, dh, dl = _window_scratch(G, K_FLUSH, B, dev)
    perm, has = perm.contiguous(), has.contiguous()
    flushes = ctypes.c_int(0)
    _build.check(_build.lib().slim_cd_sweep_large(
        G.data_ptr(), gh.data_ptr(), gl.data_ptr(), gjT.data_ptr(),
        actT.data_ptr(), diag2d.data_ptr(), xo.data_ptr(), qo.data_ptr(),
        live.data_ptr(), regsT.data_ptr(), perm.data_ptr(), has.data_ptr(),
        perm.numel(), B, npad, qg.data_ptr(), dh.data_ptr(),
        dl.data_ptr(), lo.data_ptr(), nit.data_ptr(), dltx.data_ptr(),
        _flush_bn(npad, B), ctypes.addressof(flushes),
        _build.stream_ptr(dev)), "slim_cd_sweep_large")
    return (xo, qo, lo, nit, dltx), flushes.value


def cd_sweep(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """One row-major CD sweep.  G (npad, npad) f32; gj/x/q (B, npad) f32;
    act (B, npad) int8; live (B, 1) f32 0/1; diag2d (1, npad); regs (B, 5)
    = per-column [l1r, l2r, cap, t0, optTol]; perm/has (nchunks,) int32.
    Returns (x', q', live', nit = live at sweep start, dltx = Σdx²), the
    last three (B, 1)."""
    B, npad = gj.shape
    perm, has = perm.reshape(-1), has.reshape(-1)
    _check(G, gj, act, x, q, live, diag2d, regs, perm, has, npad, B, CHUNK)
    if gj.device.type == "cpu":
        return cd_sweep_plain(G, gj, act, x, q, live, diag2d, regs, perm, has)
    if gj.device.type != "cuda":
        raise ValueError(f"cd_sweep: unsupported device {gj.device}")
    cd_sweep.launches += 1
    return _launch(G, gj, act, x, q, live, diag2d, regs, perm, has)


cd_sweep.launches = 0


def cd_sweep_large(G, gjT, actT, xT, qT, live, diag2d, regsT, perm, has):
    """One coordinate-major CD sweep.  gjT/xT/qT (npad, B) f32; actT
    (npad, B) int8; live (1, B); regsT (5, B); perm/has (npad // GROUP,)
    int32, groups visited in perm order, a group's chunks in ascending
    order; any npad that is a multiple of GROUP.  Returns (xT', qT' = G xT',
    live', nit, dltx), the last three (1, B).  On the card
    ``cd_sweep_large.flush_launches`` counts the window flushes enqueued,
    one a window of K_FLUSH positions (a window whose slots have no work
    launches and does nothing)."""
    npad, B = gjT.shape
    _check(G, gjT, actT, xT, qT, live, diag2d, regsT, perm, has, npad, B,
           GROUP)
    if gjT.device.type == "cpu":
        return cd_sweep_large_plain(G, gjT, actT, xT, qT, live, diag2d,
                                    regsT, perm, has)
    if gjT.device.type != "cuda":
        raise ValueError(f"cd_sweep_large: unsupported device {gjT.device}")
    cd_sweep_large.launches += 1
    out, flushes = _launch_large(G, gjT, actT, xT, qT, live, diag2d, regsT,
                                 perm, has, B, npad)
    cd_sweep_large.flush_launches += flushes
    return out


cd_sweep_large.launches = 0
cd_sweep_large.flush_launches = 0


def _sweep_panel(wrapper, K, plain, G, gj, act, x, q, live, diag2d, regs,
                 perm, has):
    name = wrapper.__name__
    B, npad = gj.shape
    perm, has = perm.reshape(-1), has.reshape(-1)
    _check(G, gj, act, x, q, live, diag2d, regs, perm, has, npad, B, GROUP)
    if perm.numel() % K:
        raise ValueError(f"{name}: {perm.numel()} groups do not fill "
                         f"windows of {K}")
    if gj.device.type == "cpu":
        return plain(G, gj, act, x, q, live, diag2d, regs, perm, has)
    if gj.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gj.device}")
    xo, qo, lo, nit, dltx = _outputs(x, q, live)
    dev = x.device
    gh, gl, qt, dh, dl = _window_scratch(G, K, B, dev)   # qt is (B, GROUP)
    perm, has = perm.contiguous(), has.contiguous()
    wrapper.launches += 1
    _build.check(_build.lib().slim_cd_sweep_panel(
        K, G.data_ptr(), gh.data_ptr(), gl.data_ptr(), gj.data_ptr(),
        act.data_ptr(), diag2d.data_ptr(), xo.data_ptr(), qo.data_ptr(),
        live.data_ptr(), regs.data_ptr(), perm.data_ptr(), has.data_ptr(),
        perm.numel(), B, npad, qt.data_ptr(), dh.data_ptr(), dl.data_ptr(),
        lo.data_ptr(), nit.data_ptr(), dltx.data_ptr(),
        _build.stream_ptr(dev)), "slim_cd_sweep_panel")
    return xo, qo, lo, nit, dltx


def cd_sweep_v3(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """One row-major group sweep with the q flush deferred over windows of
    K_FLUSH groups.  Operands as :func:`cd_sweep`; perm/has (npad // GROUP,)
    int32 with (npad // GROUP) % K_FLUSH == 0.  Returns (x', q' = x'G,
    live', nit = live at sweep start, dltx = Σdx²), the last three (B, 1)."""
    return _sweep_panel(cd_sweep_v3, K_FLUSH, cd_sweep_v3_plain, G, gj, act,
                        x, q, live, diag2d, regs, perm, has)


cd_sweep_v3.launches = 0


def cd_sweep_eager(G, gj, act, x, q, live, diag2d, regs, perm, has):
    """One row-major group sweep with each group's deltas flushed to all of
    q right after the group: :func:`cd_sweep_v3` with a window of one."""
    return _sweep_panel(cd_sweep_eager, 1, cd_sweep_eager_plain, G, gj, act,
                        x, q, live, diag2d, regs, perm, has)


cd_sweep_eager.launches = 0


def pick_large_variant(B: int, width: int) -> str:
    """Sweep for a block wider than the compact threshold (counterpart of
    ``pallas_pick_large_variant``), read from the environment at call time:
    ``"v4"`` unless SLIM_PALLAS_V4=0, then ``"v3"`` unless SLIM_PALLAS_V3=0
    or its windows do not tile the groups, else ``"eager"``.  The TPU's
    VMEM budgets do not apply on the card, so no rule depends on ``B``; it
    stays in the signature of the JAX function."""
    if os.environ.get("SLIM_PALLAS_V4", "1") != "0":
        return "v4"
    if os.environ.get("SLIM_PALLAS_V3", "1") != "0" \
            and (width // GROUP) % K_FLUSH == 0:
        return "v3"
    return "eager"


def _start(active, x0, caps):
    """Masked x0, sweep bound and the live/converged starting masks:
    empty-active columns converge trivially on their first sweep (the
    reference runs CD over 0 coords, dltx = 0 < optTol).  A column is
    live at the start whenever the bound is above 0."""
    any_act = active.any(dim=1)
    caps = caps.to(active.device)
    tmax = 0
    if caps.numel():
        with span("slim.wait.tmax"):
            tmax = int(torch.where(any_act, caps, 0).max())
    live0 = (any_act & (caps > 0)).to(torch.float32)
    conv0 = (~any_act) & (caps > 0)
    return torch.where(active, x0, 0.0), tmax, live0, conv0


def _perm(n, gen, shuffle, device):
    p = torch.randperm(n, generator=gen) if shuffle else torch.arange(n)
    return p.to(device=device, dtype=torch.int32)


def solve_core(G, gj, diag, active, x0, caps, yty, l1v, l2v, optTol, gen,
               shuffle=True):
    """Block solve on :func:`cd_sweep` (counterpart of
    ``pallas_solve_core``): exact q = x G at every sweep start, chunks
    whose active coordinates all belong to dead columns skipped.  Returns
    (x, niters, converged, rnorm, obj)."""
    B, npad = gj.shape
    dev = gj.device
    nchunks = npad // CHUNK
    act_i8 = active.to(torch.int8).contiguous()
    act_f = active.to(torch.float32)
    diag2d = diag.reshape(1, npad).to(torch.float32).contiguous()
    caps_f = caps.to(device=dev, dtype=torch.float32)
    x, tmax, live, conv = _start(active, x0, caps)
    live = live[:, None]
    niters = torch.zeros(B, dtype=torch.float32, device=dev)
    t, going = 0, tmax > 0
    while going:
        with span("slim.cd.sweep"):
            perm = _perm(nchunks, gen, shuffle, dev)
            chunk_any = (act_f * live).sum(dim=0).reshape(nchunks, CHUNK) \
                .sum(dim=1) > 0
            has = chunk_any[perm.long()].to(torch.int32)
            regs = torch.stack([l1v, l2v, caps_f,
                                torch.full_like(l1v, float(t)),
                                torch.full_like(l1v, float(optTol))], dim=1)
            q = x @ G
            x, _, liven, nit, dl = cd_sweep(G, gj, act_i8, x, q, live,
                                            diag2d, regs.contiguous(), perm,
                                            has)
            died = (live[:, 0] > 0) & (liven[:, 0] == 0)
            conv = conv | (died & (dl[:, 0] < optTol))
            niters += nit[:, 0]
            live = liven
            t += 1
            with span("slim.wait.live"):
                going = t < tmax and bool((live > 0).any())
    q = x @ G
    rnorm, obj = block_stats(x, q, gj, yty, l1v, l2v)
    return x, niters.to(torch.int32), conv, rnorm, obj


_GROUP_SWEEPS = {"v4": cd_sweep_large, "v3": cd_sweep_v3,
                 "eager": cd_sweep_eager}


def _solve_groups(variant, G, gj, diag, active, x0, caps, yty, l1v, l2v,
                  optTol, gen, shuffle, x0_zero):
    """Block solve on a group sweep: operands laid out once (coordinate-
    major for v4, row-major otherwise), q carried between sweeps and
    refreshed exactly (a torch matmul outside the kernel) every
    :func:`q_refresh` sweeps, active groups clustered first in the visit
    order except for eager, stats from the carried q."""
    B, npad = gj.shape
    dev = gj.device
    ngroups = npad // GROUP
    sweep = _GROUP_SWEEPS[variant]
    tr = variant == "v4"
    lay = (lambda a: a.T.contiguous()) if tr else (lambda a: a.contiguous())
    act = lay(active.to(torch.int8))
    gjl = lay(gj)
    diag2d = diag.reshape(1, npad).to(torch.float32).contiguous()
    caps_f = caps.to(device=dev, dtype=torch.float32)
    x, tmax, live, conv = _start(active, x0, caps)
    xl = lay(x)
    live = live[None, :] if tr else live[:, None]
    ga = active.T.to(torch.float32).reshape(ngroups, GROUP, B).amax(dim=1)

    def exact_q(xl):
        return G @ xl if tr else xl @ G

    ql = torch.zeros_like(xl) if x0_zero else exact_q(xl)
    niters = torch.zeros(B, dtype=torch.float32, device=dev)
    refresh = q_refresh()
    t, going = 0, tmax > 0
    while going:
        with span("slim.cd.sweep"):
            lv = live.reshape(-1)
            perm = _perm(ngroups, gen, shuffle, dev).long()
            group_any = (ga @ lv) > 0
            if variant != "eager":
                # cluster active groups first (stable) so that windows are
                # either fully active or skipped
                inactive = (~group_any[perm]).to(torch.int32)
                perm = perm[torch.sort(inactive, stable=True).indices]
            has = group_any[perm].to(torch.int32)
            regs = torch.stack([l1v, l2v, caps_f,
                                torch.full_like(l1v, float(t)),
                                torch.full_like(l1v, float(optTol))],
                               dim=0 if tr else 1)
            if t % refresh == 0 and t > 0:
                ql = exact_q(xl)
            xl, ql, liven, nit, dl = sweep(G, gjl, act, xl, ql, live, diag2d,
                                           regs.contiguous(),
                                           perm.to(torch.int32), has)
            ln = liven.reshape(-1)
            died = (lv > 0) & (ln == 0)
            conv = conv | (died & (dl.reshape(-1) < optTol))
            niters += nit.reshape(-1)
            live = liven
            t += 1
            with span("slim.wait.live"):
                going = t < tmax and bool((live > 0).any())
    x, q = (xl.T, ql.T) if tr else (xl, ql)
    rnorm, obj = block_stats(x, q, gj, yty, l1v, l2v)
    return x.contiguous(), niters.to(torch.int32), conv, rnorm, obj


def solve_large_core(G, gj, diag, active, x0, caps, yty, l1v, l2v, optTol,
                     gen, shuffle=True, x0_zero=False):
    """Block solve on :func:`cd_sweep_large` (counterpart of
    ``_solve_large_core_v4``).  Returns (x, niters, converged, rnorm,
    obj)."""
    return _solve_groups("v4", G, gj, diag, active, x0, caps, yty, l1v, l2v,
                         optTol, gen, shuffle, x0_zero)


def solve_panel_core(G, gj, diag, active, x0, caps, yty, l1v, l2v, optTol,
                     gen, shuffle=True, x0_zero=False, variant="v3"):
    """Block solve on :func:`cd_sweep_v3` (``variant="v3"``) or
    :func:`cd_sweep_eager` (``"eager"``): the counterpart of the non-v4
    branch of ``pallas_solve_large_core``.  Returns (x, niters, converged,
    rnorm, obj)."""
    if variant not in ("v3", "eager"):
        raise ValueError(f"unknown panel sweep variant {variant!r}")
    return _solve_groups(variant, G, gj, diag, active, x0, caps, yty, l1v,
                         l2v, optTol, gen, shuffle, x0_zero)
