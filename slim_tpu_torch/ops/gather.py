"""Submatrix gathers of the Gram for the compact block solve.

The kernel (csrc/gather.cu) reads each wanted entry of G once and writes
it once: G[S, S] and the targets' rows G[j, S] of a compact block come out
in one pass each, with no (K, npad) intermediate (two ``index_select``s
made one, 23 GB at npad 94,208 and K 61,440).  It has no TPU counterpart:
the JAX package gathers with two ``jnp.take``s.
"""

from __future__ import annotations

import torch

from . import _build


def gather_plain(G, rows, cols, trans=False):
    """Plain PyTorch version of :func:`gather` (same contract)."""
    r, c = rows.long(), cols.long()
    if trans:
        return G.index_select(1, r).index_select(0, c).T.contiguous()
    return G.index_select(0, r).index_select(1, c)


def gather(G, rows, cols, trans=False):
    """(R, C) float32 ``out[a, b] = G[rows[a], cols[b]]``, or with
    ``trans`` ``G[cols[b], rows[a]]``, for a float32 G with unit column
    stride and int32 ``rows`` (R,), ``cols`` (C,) on its device.  CPU
    tensors take :func:`gather_plain`; CUDA tensors launch the kernel."""
    if G.dtype != torch.float32 or G.dim() != 2 or G.stride(1) != 1:
        raise ValueError("G must be a float32 (n, m) tensor with unit "
                         "column stride")
    for name, ids in (("rows", rows), ("cols", cols)):
        if ids.dtype != torch.int32 or ids.dim() != 1 \
                or ids.device != G.device:
            raise ValueError(f"{name} must be int32 (k,) on G's device")
    if G.device.type == "cpu":
        return gather_plain(G, rows, cols, trans)
    if G.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {G.device}")
    out = torch.empty((rows.numel(), cols.numel()), dtype=torch.float32,
                      device=G.device)
    rows, cols = rows.contiguous(), cols.contiguous()
    gather.launches += 1
    _build.check(_build.lib().slim_gather(
        G.data_ptr(), G.stride(0), rows.data_ptr(), rows.numel(),
        cols.data_ptr(), cols.numel(), int(trans), out.data_ptr(),
        _build.stream_ptr(G.device)), "slim_gather")
    return out


gather.launches = 0
