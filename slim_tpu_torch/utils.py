"""Small shared utilities."""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter

import torch
from torch.autograd import _profiler_enabled


def nnz_bucket(n: int, floor: int = 8) -> int:
    """1/8-octave size bucket: the next multiple of pow2ceil(n)/8 at or
    above n (>= floor), so flat nnz-sized buffers waste at most 12.5%."""
    m = max(floor, 8)
    while m < n:
        m *= 2
    if m <= 1024:
        return m
    step = m >> 3
    return max(((n + step - 1) // step) * step, floor)


def topk_lowest_id(sc, k: int):
    """``torch.topk(sc, k, dim=1)`` with equal scores ordered by the lowest
    index first, as ``lax.top_k`` orders them (torch.topk leaves that order
    unspecified, on the CPU and on the card).  The entries above the k-th
    value are the top-k's own, ordered by (score desc, index asc); the
    remaining slots take the lowest indices whose score equals the k-th."""
    top_sc, top_id = torch.topk(sc, k, dim=1)
    o = torch.argsort(top_id, dim=1)
    top_sc, top_id = top_sc.gather(1, o), top_id.gather(1, o)
    o = torch.sort(top_sc, dim=1, descending=True, stable=True).indices
    top_sc, top_id = top_sc.gather(1, o), top_id.gather(1, o)
    kth = top_sc[:, -1:]
    n = sc.shape[1]
    iota = torch.arange(n, dtype=torch.int32, device=sc.device)
    low = torch.topk(torch.where(sc == kth, iota, n), k, dim=1,
                     largest=False).values          # ascending
    n_gt = (top_sc > kth).sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=sc.device)[None, :]
    tie = low.gather(1, (slot - n_gt).clamp(min=0)).to(top_id.dtype)
    return top_sc, torch.where(slot < n_gt, top_id, tie)


def kept(cache: dict, key: str, t, make, size: int = 0):
    """``make()``, a value made from the tensor ``t``, kept in
    ``cache[key]`` while t lives unchanged: the same tensor object with
    the same version counter (an in-place write to t or to any view of it
    bumps it; writes that bypass the counter, through ``.data`` or DLPack,
    are not seen).  A kept value of at least ``size`` serves the call.
    The slot holds (a weak reference to t, t's version, ``size``, the
    value): one value, of the latest t, made after every other in
    ``cache`` is dropped, and dropping t frees it.  Returns (value, whether
    it was kept)."""
    hit = cache.get(key)
    if hit is not None and hit[0]() is t and hit[1] == t._version \
            and hit[2] >= size:
        return hit[3], True

    def drop(ref):
        if cache.get(key, (None,))[0] is ref:
            del cache[key]

    cache.clear()
    value = make()
    cache[key] = (weakref.ref(t, drop), t._version, size, value)
    return value, False


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the first CUDA card.  With no device and no
    card it raises: the port never falls back to the CPU unasked, a CPU run
    passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA card: pass device="cpu" (-device=cpu '
                           'on the command line) to run on the CPU')
    return torch.device("cuda")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` span while a profiler
    runs, else a shared no-op context after one flag check: the port's
    spans cost nothing measurable in an unprofiled run.  Spans opened on a
    thread of the port's own (the harvest worker) do not reach the
    trace."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Seconds per named phase of a solve on ``dev``: each :meth:`phase`
    block is a span ``<prefix>.<name>`` and, at its end, waits for the
    current stream (a ``slim.wait.lap`` span on the card), then charges
    the time since the block began to its phase.  Work on other streams
    (the harvest's copies) is not waited for, so it can overlap the next
    phase."""

    def __init__(self, dev: torch.device, prefix: str):
        self.dev, self.prefix = dev, prefix
        self.start = time.perf_counter()
        self.phases = Counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with span(f"{self.prefix}.{name}"):
            yield
            if self.dev.type == "cuda":
                with span("slim.wait.lap"):
                    torch.cuda.current_stream(self.dev).synchronize()
        self.phases[name] += time.perf_counter() - t0
