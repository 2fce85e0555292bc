"""The collectives of the distributed learn and predict.

On a NCCL group they work in place on the card.  On a gloo group a card
tensor is copied to the host, reduced or gathered there, and copied back,
explicitly and every time: gloo is what lets several ranks share one card
(NCCL refuses two ranks on one device), and the computation itself stays
on the card.  ``group=None`` is the whole world.  Only calls that exist in
every supported torch are used: ``all_reduce``, the list forms of
``all_gather`` and ``reduce_scatter``, and ``broadcast_object_list``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def staged(group=None) -> bool:
    """Whether collectives on ``group`` go through the host (any backend
    but NCCL)."""
    return dist.get_backend(group) != "nccl"


def wire(group, device) -> torch.device:
    """Where a collective on ``group`` takes its tensors: ``device`` for
    NCCL, the host otherwise."""
    return torch.device("cpu") if staged(group) else torch.device(device)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM):
    """Reduce ``t`` over ``group`` in place; returns ``t``."""
    if t.device.type != "cpu" and staged(group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, rank r keeping its r-th slice of
    dim 0 (which the world size divides).  Through the host it is an
    all-reduce and a slice."""
    world, r = dist.get_world_size(group), dist.get_rank(group)
    if staged(group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return h.chunk(world)[r].to(t.device)
    parts = list(t.contiguous().chunk(world))
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim
    0 in rank order, on ``t``'s device."""
    world = dist.get_world_size(group)
    src = t.contiguous() if not staged(group) else t.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_gather` of tensors whose dim 0 differs by rank: the
    lengths first, then the rows padded to the longest."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64,
                     device=wire(group, t.device))
    lens = all_gather(n, group).tolist()
    pad = max(lens)
    buf = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    buf[:t.shape[0]] = t
    full = all_gather(buf, group)
    return torch.cat([full[i * pad:i * pad + m] for i, m in enumerate(lens)])


def all_gather_triplets(coord, target, vals, device, group=None):
    """Every rank's (coord int32, target int32, value float32) tensors,
    concatenated in rank order, on the device of ``coord``: one gather of
    (N, 3) int32 rows with the values bit-cast, through ``device`` (the
    rank's card) on a NCCL group."""
    rows = torch.stack([coord.int(), target.int(),
                        vals.float().view(torch.int32)], dim=1)
    out = all_gather_rows(rows.to(wire(group, device)), group) \
        .to(coord.device)
    return (out[:, 0].contiguous(), out[:, 1].contiguous(),
            out[:, 2].contiguous().view(torch.float32))


def all_gather_host(x: np.ndarray, device, group=None) -> np.ndarray:
    """Every rank's host array ``x`` (one shape on all ranks) stacked: (world,
    *x.shape)."""
    t = torch.from_numpy(np.ascontiguousarray(x)[None]).to(
        wire(group, device))
    return all_gather(t, group).cpu().numpy()


def broadcast_object(obj, device, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank of ``group`` (the
    other ranks' ``obj`` is ignored)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=wire(group, device))
    return box[0]
