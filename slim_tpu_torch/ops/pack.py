"""Harvest pack: ragged compaction of a solved block (port of
slim_tpu/ops/pallas_pack.py).

The kernel (csrc/pack.cu) replaces ``_pack_kernel`` / ``pallas_pack``:
one CUDA block per row, a ballot + popcount rank inside each warp and a
shared-memory prefix across warps, tile by tile in ascending column order.
Contract (cd_kernel.pack_flat): row b's entries ``x > eps`` land at
``[off[b], off[b] + cnt[b])`` in ascending column order as (value, column
id); the padded tail is 0; ids are int32 on the device (narrow on the
host when the catalogue fits 16 bits).
"""

from __future__ import annotations

import torch

from . import _build


def pack_plain(x, offsets, eps, Tpad):
    """Plain PyTorch version of the pack kernel (same contract)."""
    B, K = x.shape
    mask = x > eps
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    pos = offsets.to(torch.int64)[:, None] + rank
    keep = mask & (pos < Tpad) & (pos >= 0)
    vals = torch.zeros(Tpad, dtype=torch.float32, device=x.device)
    ids = torch.zeros(Tpad, dtype=torch.int32, device=x.device)
    cols = torch.arange(K, dtype=torch.int32, device=x.device)
    vals[pos[keep]] = x[keep]
    ids[pos[keep]] = cols[None, :].expand(B, K)[keep]
    return vals, ids


def pack(x, offsets, eps, Tpad):
    """Exact-size flat pack of ``x (B, K)`` float32 with int32 ``offsets``
    (B,): returns (vals (Tpad,) float32, ids (Tpad,) int32).  CPU tensors
    take :func:`pack_plain`; CUDA tensors launch the kernel."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, K) tensor")
    if offsets.dtype != torch.int32 or offsets.shape != (x.shape[0],) \
            or offsets.device != x.device:
        raise ValueError("offsets must be int32 (B,) on x's device")
    if x.device.type == "cpu":
        return pack_plain(x, offsets, eps, Tpad)
    if x.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {x.device}")
    B, K = x.shape
    vals = torch.zeros(Tpad, dtype=torch.float32, device=x.device)
    ids = torch.zeros(Tpad, dtype=torch.int32, device=x.device)
    offsets = offsets.contiguous()
    pack.launches += 1
    _build.check(_build.lib().slim_pack(
        x.data_ptr(), offsets.data_ptr(), B, K, Tpad, float(eps),
        vals.data_ptr(), ids.data_ptr(), _build.stream_ptr(x.device)),
        "slim_pack")
    return vals, ids


pack.launches = 0
