"""Transposed densify: padded sparse rows -> dense (npad, R) block.

Port of slim_tpu/ops/pallas_gram.py.  The kernel (csrc/densify.cu)
replaces ``_densify_kernel`` / ``pallas_densify``; on Hopper it is a
scatter of one store per entry, one thread per output column, so no
thread races another and duplicate ids accumulate.  Its users are the
Gram (ops/gram.py), the model densify and the history densify of the dense
predict (predict.py), the latter into bfloat16 on the "high" and "default"
routes (:func:`densify_bf16`, the TPU kernel's ``out_dtype``).

Layout: ``idsT (W, R)`` holds the w-th column id of row r at
``idsT[w, r]``; ids outside [0, npad) are sentinels.  The output is the
TRANSPOSED dense block ``out[c, r] = v``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

RT = 256     # rows per wmax tile (one CUDA block)
# output dtypes and the kernel's out_kind for each
OUT_KIND = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
WCAP = 4096  # widest entry window one densify pass takes (densify_runs)
SLAB = 4096  # runs gathered at once by densify_runs


def densify_meta(idsT: torch.Tensor, npad: int) -> torch.Tensor:
    """Per RT-row tile entry bound: wmax[t] = 1 + the highest w holding a
    real id in tile t (0 for an all-sentinel tile).  The TPU kernel also
    took per-chunk column bounds for its compare-select skip; a scatter
    visits only real entries, so it needs just this loop bound."""
    W, R = idsT.shape
    nrt = -(-R // RT)
    valid = (idsT >= 0) & (idsT < npad)
    if nrt * RT != R:
        valid = torch.nn.functional.pad(valid, (0, nrt * RT - R))
    anyv = valid.reshape(W, nrt, RT).any(dim=2)                 # (W, nRt)
    w1 = torch.arange(1, W + 1, device=idsT.device, dtype=torch.int32)
    return torch.where(anyv, w1[:, None], 0).amax(dim=0).to(torch.int32) \
        if W else torch.zeros(nrt, dtype=torch.int32, device=idsT.device)


def _check_args(idsT, valsT, wmax, npad, out):
    W, R = idsT.shape
    if idsT.dtype != torch.int32 or not idsT.is_contiguous():
        raise ValueError("idsT must be contiguous int32 (W, R)")
    if valsT is not None and (valsT.shape != idsT.shape
                              or valsT.dtype != torch.float32
                              or not valsT.is_contiguous()):
        raise ValueError("valsT must be contiguous float32 shaped like idsT")
    if wmax.dtype != torch.int32 or wmax.shape != (-(-R // RT),):
        raise ValueError("wmax must be int32 (ceil(R / RT),)")
    if out.shape != (npad, R) or (R > 1 and out.stride(1) != 1):
        raise ValueError("out must be (npad, R) with unit column stride")
    if out.dtype not in OUT_KIND:
        raise ValueError("out must be float32, int8 or bfloat16")
    if out.dtype == torch.int8 and valsT is not None:
        raise ValueError("int8 output is for binary (valsT=None) data only")
    if len({t.device for t in (idsT, valsT, wmax, out)
            if t is not None}) != 1:
        raise ValueError("all densify operands must be on one device")


def densify_plain(idsT, valsT, wmax, npad, out):
    """Plain PyTorch version of the densify kernel (same contract)."""
    W, R = idsT.shape
    if W == 0 or R == 0:
        return out
    r = torch.arange(R, device=idsT.device)
    w = torch.arange(W, device=idsT.device)
    inb = w[:, None] < wmax.to(torch.int64)[r // RT][None, :]
    ok = inb & (idsT >= 0) & (idsT < npad)
    c = idsT[ok].to(torch.int64)
    rr = r[None, :].expand(W, R)[ok]
    v = (valsT[ok] if valsT is not None
         else torch.ones(c.shape[0], dtype=torch.float32, device=out.device))
    out.index_put_((c, rr), v.to(out.dtype), accumulate=True)
    return out


def densify(idsT, valsT, wmax, npad, out_dtype=torch.float32, out=None):
    """Densify one row block: ``out[c, r] += v`` for every entry
    ``(idsT[w, r] = c, valsT[w, r] = v)`` with w < wmax[r // RT].

    idsT (W, R) int32 (sentinels >= npad or < 0 dropped); valsT (W, R)
    float32 or None for implicit 1.0; wmax from :func:`densify_meta`.
    ``out`` (npad, R), float32, int8 or bfloat16, may be a column slice of
    a wider matrix and is accumulated into; a zeroed one is made when
    omitted.  CPU tensors take :func:`densify_plain`; CUDA tensors launch
    the kernel, counted on :func:`densify_bf16` for a bfloat16 ``out``.
    """
    W, R = idsT.shape
    if out is None:
        out = torch.zeros((npad, R), dtype=out_dtype, device=idsT.device)
    _check_args(idsT, valsT, wmax, npad, out)
    if idsT.device.type == "cpu":
        return densify_plain(idsT, valsT, wmax, npad, out)
    if idsT.device.type != "cuda":
        raise ValueError(f"densify: unsupported device {idsT.device}")
    if out.dtype == torch.bfloat16:
        densify_bf16.launches += 1
    else:
        densify.launches += 1
    _build.check(_build.lib().slim_densify(
        idsT.data_ptr(), None if valsT is None else valsT.data_ptr(),
        wmax.data_ptr(), W, R, npad, OUT_KIND[out.dtype], out.data_ptr(),
        out.stride(0), _build.stream_ptr(idsT.device)), "slim_densify")
    return out


densify.launches = 0


def densify_bf16(idsT, valsT, wmax, npad, out=None):
    """:func:`densify` into a bfloat16 block (the dense predict's histories
    on its bfloat16 routes); the kernel adds through float32 and rounds
    once per entry.  Its launches count here, apart from the float32 and
    int8 ones, whichever of the two functions was called."""
    return densify(idsT, valsT, wmax, npad, torch.bfloat16, out)


densify_bf16.launches = 0


def gathered_densifyT(idx, val, rs, rl, W, npad, out_dtype=torch.float32,
                      n_valid=None, out=None):
    """Gather one block's (W, R) transposed id layout from a flat CSR
    (``idx (nnz,)`` int32, ``val (nnz,)`` float32 or None for binary data,
    ``rs``/``rl (R,)`` int32 row starts/lengths, all on one device) and
    densify it.  Ids >= ``n_valid`` are dropped (the reference's
    ``id < ncols`` guard, predict.c:35).  Unlike the TPU glue, ids are not
    sorted within rows: a scatter has no chunk-skip ranges to tighten."""
    dev = idx.device
    R = rs.shape[0]
    if out is None:
        out = torch.zeros((npad, R), dtype=out_dtype, device=dev)
    if idx.numel() == 0 or R == 0 or W == 0:
        return out
    wio = torch.arange(W, device=dev, dtype=torch.int64)[:, None]
    e = (rs.to(torch.int64)[None, :] + wio).clamp_(max=idx.numel() - 1)
    valid = wio < rl.to(torch.int64)[None, :]
    ids = idx[e]
    if n_valid is not None:
        valid &= ids < n_valid
    idsT = torch.where(valid, ids, npad).to(torch.int32).contiguous()
    valsT = None if val is None else \
        torch.where(valid, val[e], 0.0).contiguous()
    return densify(idsT, valsT, densify_meta(idsT, npad), npad, out=out)


def pow2_width(n: int) -> int:
    return max(32, 1 << max(int(n) - 1, 0).bit_length())


def densify_runs(idx, val, run_starts, run_lens, npad, n_valid, out):
    """Densify R runs of a flat (id, value) array into ``out (npad, R)``:
    column r = run r (host int arrays ``run_starts``/``run_lens``).  Runs
    are taken in slabs, each with the pow2 entry width of its longest run
    capped at WCAP; longer runs take several passes over shifted windows
    (disjoint entries, so the passes just add)."""
    run_starts = np.asarray(run_starts, np.int64)
    run_lens = np.asarray(run_lens, np.int64)
    dev = idx.device
    for r0 in range(0, len(run_lens), SLAB):
        rl_s = run_lens[r0:r0 + SLAB]
        rs_s = run_starts[r0:r0 + SLAB]
        wmax = int(rl_s.max()) if rl_s.size else 0
        if wmax == 0:
            continue
        w = min(pow2_width(wmax), WCAP)
        for k in range(-(-wmax // w)):
            rs_k = torch.from_numpy((rs_s + k * w).astype(np.int32)).to(dev)
            rl_k = torch.from_numpy(
                np.clip(rl_s - k * w, 0, w).astype(np.int32)).to(dev)
            gathered_densifyT(idx, val, rs_k, rl_k, w, npad,
                              n_valid=n_valid,
                              out=out[:, r0:r0 + len(rl_s)])
    return out
