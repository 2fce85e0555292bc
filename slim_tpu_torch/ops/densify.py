"""Densify: runs of a flat (id, value) array -> a dense block.

Port of slim_tpu/ops/pallas_gram.py.  The kernel (csrc/densify.cu)
replaces ``_densify_kernel`` / ``pallas_densify``: a CTA owns a tile of
output ids x 32 runs in shared memory, reads its runs' entries, adds the
ids that fall in its tile and writes the tile once, so one launch fills a
whole block, zeros included.  Its users are the Gram (ops/gram.py), the
warm starts (solvers/cd.py), the distributed screen (parallel/dist.py),
the model densify and the history densify of the dense predict
(predict.py), the latter into bfloat16 on the "high" and "default" routes
(the TPU kernel's ``out_dtype``).

Contract (:func:`densify_runs`): run r holds the entries e = start[r] +
k * stride, k < len[r]; entry e has id ``idx[e]`` and value ``val[e]``
(1.0 when ``val`` is None).  Every id c with 0 <= c < min(npad, n_valid)
adds its value at (c, r): ``out[c, r]`` in the transposed layout (npad, R),
``out[r, c]`` row-major (R, npad).  Other ids are dropped; duplicates add.
Sums are taken in float32 (int32 for the int8 output of binary data) and
rounded once into ``out``'s dtype as each element is written: ``out =
sum``, or with ``accumulate`` ``out = dtype(out + sum)``.  CSR runs have
stride 1; :func:`densify` reads the TPU kernel's (W, R) id layout, run r
its column r (stride R).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

RT = 256     # rows per wmax tile of the (W, R) layout (densify_meta)
# output dtypes and the kernel's out_kind for each
OUT_KIND = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
# the H100's shared memory: what one CTA may take, and what one SM holds
# (each CTA also reserves 1 KB); the kernel's tiles fill CTAS_PER_SM CTAs
CTA_SMEM = 232_448
SM_SMEM = 233_472
CTAS_PER_SM = 2
TILE_RUNS = 32   # runs per tile (csrc/densify.cu kTR)


def tile_ids(row_major: bool, npad: int) -> int:
    """Ids of one CTA's tile of TILE_RUNS runs: as many as the shared
    memory granted a CTA holds (a float32 / int32 accumulator cell each,
    rows padded by one word in the transposed layout), in multiples of 32
    and no more than npad needs."""
    row_bytes = 4 * (TILE_RUNS if row_major else TILE_RUNS + 1)
    budget = min(CTA_SMEM, SM_SMEM // CTAS_PER_SM - 1024)
    return min(budget // row_bytes // 32 * 32, -(-npad // 32) * 32)


def densify_meta(idsT: torch.Tensor, npad: int) -> torch.Tensor:
    """Per RT-row tile entry bound of the (W, R) layout: wmax[t] = 1 + the
    highest w holding a real id in tile t (0 for an all-sentinel tile), as
    the TPU kernel's loop bound; :func:`densify` reads run r's first
    wmax[r // RT] entries."""
    W, R = idsT.shape
    nrt = -(-R // RT)
    valid = (idsT >= 0) & (idsT < npad)
    if nrt * RT != R:
        valid = torch.nn.functional.pad(valid, (0, nrt * RT - R))
    anyv = valid.reshape(W, nrt, RT).any(dim=2)                 # (W, nRt)
    w1 = torch.arange(1, W + 1, device=idsT.device, dtype=torch.int32)
    return torch.where(anyv, w1[:, None], 0).amax(dim=0).to(torch.int32) \
        if W else torch.zeros(nrt, dtype=torch.int32, device=idsT.device)


def _check_out(out, npad, R, row_major, val):
    want = (R, npad) if row_major else (npad, R)
    if tuple(out.shape) != want or (out.numel() > 0 and out.stride(1) != 1):
        raise ValueError(f"out must be {want} with unit inner stride")
    if out.dtype not in OUT_KIND:
        raise ValueError("out must be float32, int8 or bfloat16")
    if out.dtype == torch.int8 and val is not None:
        raise ValueError("int8 output is for binary (val=None) data only")


def _runs_plain(idx, val, starts, lens, stride, npad, limit, out,
                accumulate, row_major):
    """The plain version on device tensors: the sums in a float32 (int32
    for int8) block, rounded once into ``out``."""
    dev = out.device
    acc_dt = torch.int32 if out.dtype == torch.int8 else torch.float32
    acc = torch.zeros(out.shape, dtype=acc_dt, device=dev)
    ln = lens.to(torch.int64)
    total = int(ln.sum()) if ln.numel() else 0
    if total:
        r = torch.repeat_interleave(torch.arange(ln.numel(), device=dev), ln,
                                    output_size=total)
        k = torch.arange(total, device=dev) - (torch.cumsum(ln, 0) - ln)[r]
        e = starts.to(torch.int64)[r] + k * stride
        c = idx[e].to(torch.int64)
        ok = (c >= 0) & (c < limit)
        v = (val[e][ok] if val is not None else
             torch.ones(int(ok.sum()), dtype=torch.float32, device=dev))
        r, c = r[ok], c[ok]
        acc.index_put_((r, c) if row_major else (c, r), v.to(acc_dt),
                       accumulate=True)
    if accumulate:
        acc += out.to(acc_dt)
    return out.copy_(acc)


def _runs(idx, val, starts, lens, stride, npad, n_valid, out, accumulate,
          row_major, plain=False):
    """Densify on ``out``'s device: the plain version when asked for or on
    the CPU, else one kernel launch on the card (counted on densify_bf16
    for a bfloat16 block, else on densify)."""
    limit = npad if n_valid is None else max(0, min(npad, int(n_valid)))
    dev = out.device
    if len({t.device for t in (idx, val, starts, lens, out)
            if t is not None}) != 1:
        raise ValueError("all densify operands must be on one device")
    if plain or dev.type == "cpu":
        return _runs_plain(idx, val, starts, lens, stride, npad, limit, out,
                           accumulate, row_major)
    if dev.type != "cuda":
        raise ValueError(f"densify: unsupported device {dev}")
    R = lens.shape[0]
    if R == 0 or npad == 0:
        return out
    tc = tile_ids(row_major, npad)
    if out.dtype == torch.bfloat16:
        densify_bf16.launches += 1
    else:
        densify.launches += 1
    _build.check(_build.lib().slim_densify(
        idx.data_ptr(), None if val is None else val.data_ptr(),
        starts.data_ptr(), lens.data_ptr(), stride, R, npad, limit,
        OUT_KIND[out.dtype], int(row_major), out.data_ptr(), out.stride(0),
        int(accumulate), tc, _build.stream_ptr(dev)), "slim_densify")
    return out


def _device_runs(idx, val, run_starts, run_lens, npad, out, row_major):
    """Check the runs against ``idx`` and bring their starts (int64) and
    lengths (int32) to ``out``'s device in one copy, which does not wait
    for the card."""
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int32 vector")
    if val is not None and (val.shape != idx.shape or val.dtype !=
                            torch.float32 or not val.is_contiguous()):
        raise ValueError("val must be a contiguous float32 vector like idx")
    rs = np.ascontiguousarray(run_starts, np.int64)
    rl = np.ascontiguousarray(run_lens, np.int32)
    if rs.shape != rl.shape or rs.ndim != 1:
        raise ValueError("run_starts and run_lens must be vectors of one "
                         "length")
    _check_out(out, npad, rl.size, row_major, val)
    real = rl > 0
    if (rl < 0).any() or (real.any() and (
            rs[real].min() < 0
            or (rs[real] + rl[real]).max() > idx.numel())):
        raise ValueError("a run reaches outside idx")
    buf = torch.from_numpy(np.concatenate([rs.view(np.uint8),
                                           rl.view(np.uint8)]))
    if out.device.type == "cuda":
        # from pinned memory the copy is queued like a kernel: a pageable
        # one would wait for the card to finish the work before it
        buf = buf.pin_memory().to(out.device, non_blocking=True)
    return buf[:8 * rs.size].view(torch.int64), buf[8 * rs.size:].view(
        torch.int32)


def densify_runs(idx, val, run_starts, run_lens, npad, n_valid, out,
                 accumulate=False, row_major=False):
    """Densify R runs of a flat (id, value) array into ``out``: run r is
    entries [run_starts[r], run_starts[r] + run_lens[r]) of ``idx`` (int32)
    and ``val`` (float32, or None for implicit 1.0), host int arrays; ids
    >= ``n_valid`` (None: npad) are dropped (the reference's ``id < ncols``
    guard, predict.c:35).  ``out`` is (npad, R), or (R, npad) with
    ``row_major``, float32, int8 (binary data) or bfloat16, and may be a
    column slice of a wider block; see the module docstring for the sums
    and their rounding.  The block is overwritten, zeros included, so
    ``torch.empty`` will do; with ``accumulate`` the sums add to what it
    holds.  On a card: one kernel launch per call."""
    starts, lens = _device_runs(idx, val, run_starts, run_lens, npad, out,
                                row_major)
    return _runs(idx, val, starts, lens, 1, npad, n_valid, out, accumulate,
                 row_major)


def densify_runs_plain(idx, val, run_starts, run_lens, npad, n_valid, out,
                       accumulate=False, row_major=False):
    """Plain PyTorch version of :func:`densify_runs` (same contract, same
    rounding) on any device."""
    starts, lens = _device_runs(idx, val, run_starts, run_lens, npad, out,
                                row_major)
    return _runs(idx, val, starts, lens, 1, npad, n_valid, out, accumulate,
                 row_major, plain=True)


def _layout_runs(idsT, valsT, wmax, npad, out):
    """The (W, R) layout as runs: run r starts at r, steps by R and holds
    wmax[r // RT] entries."""
    W, R = idsT.shape
    if idsT.dtype != torch.int32 or not idsT.is_contiguous():
        raise ValueError("idsT must be contiguous int32 (W, R)")
    if valsT is not None and (valsT.shape != idsT.shape
                              or valsT.dtype != torch.float32
                              or not valsT.is_contiguous()):
        raise ValueError("valsT must be contiguous float32 shaped like idsT")
    if wmax.dtype != torch.int32 or wmax.shape != (-(-R // RT),):
        raise ValueError("wmax must be int32 (ceil(R / RT),)")
    _check_out(out, npad, R, False, valsT)
    dev = idsT.device
    starts = torch.arange(R, dtype=torch.int64, device=dev)
    lens = wmax.repeat_interleave(RT)[:R].clamp(max=W).to(torch.int32)
    return (idsT.view(-1), None if valsT is None else valsT.view(-1),
            starts, lens)


def densify(idsT, valsT, wmax, npad, out_dtype=torch.float32, out=None):
    """Densify one row block of the TPU kernel's layout: ``out[c, r] += v``
    for every entry ``(idsT[w, r] = c, valsT[w, r] = v)`` with w <
    wmax[r // RT] (:func:`densify_meta`); ids outside [0, npad) are
    sentinels.  idsT (W, R) int32; valsT (W, R) float32 or None for
    implicit 1.0.  ``out`` (npad, R), float32, int8 or bfloat16, may be a
    column slice of a wider matrix and is accumulated into; when omitted,
    a fresh block of ``out_dtype`` is written.  The same kernel as
    :func:`densify_runs`, at stride R."""
    R = idsT.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((npad, R), dtype=out_dtype, device=idsT.device)
    return _runs(*_layout_runs(idsT, valsT, wmax, npad, out), R, npad, None,
                 out, accumulate, False)


densify.launches = 0


def densify_plain(idsT, valsT, wmax, npad, out):
    """Plain PyTorch version of :func:`densify` into ``out`` (accumulated
    into, rounded once)."""
    return _runs(*_layout_runs(idsT, valsT, wmax, npad, out), idsT.shape[1],
                 npad, None, out, True, False, plain=True)


def densify_bf16(idsT, valsT, wmax, npad, out=None):
    """:func:`densify` into a bfloat16 block (the dense predict's histories
    on its bfloat16 routes).  The launches of every densify into bfloat16,
    :func:`densify_runs` included, count here, apart from the float32 and
    int8 ones."""
    return densify(idsT, valsT, wmax, npad, torch.bfloat16, out)


densify_bf16.launches = 0
