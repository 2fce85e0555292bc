"""Start a world of ranks on one host and collect what each returns.

:func:`run_world` spawns one process per rank (``torch.multiprocessing``,
spawn), joins them on a FileStore in a fresh temporary directory, runs a
module-level function in each and returns every rank's result.  It joins
with a deadline: a rank that raises or dies stops the world, and its
traceback is raised here.  The tests and ``chip_smoke.py`` drive the
distributed modes through it; a rank imports only this package.

:func:`run_calls` is the rank function they use: it builds the mesh and
runs a list of :class:`Call` s, each with its launch counts.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device
from .mesh import TIMEOUT_S, init_distributed, make_mesh


def _rank_main(rank, world, tmp, device, backend, timeout_s, fn, args):
    # the ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    init_distributed(device, backend=backend,
                     init_method="file://" + os.path.join(tmp, "store"),
                     world_size=world, rank=rank, timeout_s=timeout_s)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def run_world(fn: Callable, world_size: int, args=(), device=None,
              backend=None, timeout_s: float = TIMEOUT_S):
    """``fn(*args)`` on each of ``world_size`` spawned ranks, returning the
    list of their results in rank order.

    ``device``: "cpu", "cuda" (rank r on card r modulo the visible cards)
    or one card for every rank ("cuda:0"); default the card, as
    :func:`~slim_tpu_torch.utils.resolve_device` (with no card it raises
    before any rank starts); ``backend`` as :func:`~.mesh.init_distributed`
    (default NCCL on a card, gloo on the CPU; gloo lets several ranks
    share one card).  The kernels are built here first, so the ranks only
    load them.  The world has ``timeout_s`` to finish; the process group
    gets it as its own timeout.  ``fn`` and ``args`` are pickled: a
    module-level function and plain data (no tensor on a card)."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if device.type == "cuda":
        from ..ops import _build

        _build.build()
    tmp = tempfile.mkdtemp(prefix="slim_world_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(world_size, tmp, device, backend, timeout_s,
                              fn, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {world_size} ranks still "
                                       f"running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Call(NamedTuple):
    """One call of :func:`run_calls`: ``fn(*args, mesh=mesh, **kwargs)``
    with the environment variables ``env`` set around it, its result kept
    under ``key``."""
    key: str
    fn: Callable
    args: tuple = ()
    kwargs: dict = {}
    env: dict = {}


def plain(obj) -> Any:
    """``obj`` with every tensor as a numpy array and every CSR without its
    device caches: what a rank may pickle back."""
    from ..types import CSR

    if isinstance(obj, CSR):
        return CSR.from_arrays(obj.nrows, obj.ncols, obj.indptr, obj.indices,
                               obj.data)
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    return obj


def run_calls(calls, device=None, shape=None):
    """Rank function: the (dp, mp) mesh (``shape`` or the default) on
    ``device`` (default the card, as ``run_world``), then each
    :class:`Call` in order with every kernel's launch counter set to 0
    just before it.  Returns {key: {"result", "launches", "seconds"}} for
    this rank."""
    from ..ops import kernel_wrappers

    device = resolve_device(device)
    mesh = make_mesh(shape=shape, device=device)
    wrappers = kernel_wrappers()
    out = {}
    for c in calls:
        old = {k: os.environ.get(k) for k in c.env}
        os.environ.update(c.env)
        for w in wrappers.values():
            w.launches = 0
        try:
            t0 = time.perf_counter()
            res = c.fn(*c.args, mesh=mesh, **c.kwargs)
            if device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[c.key] = dict(result=plain(res), seconds=secs, launches={
            k: w.launches for k, w in wrappers.items()})
    return out


def learn_step(a, j_ids, caps, seed, mesh=None, **kw):
    """One :func:`~.dist.sharded_learn_step` on ``mesh`` (a :class:`Call`
    target)."""
    from .dist import sharded_learn_step

    return sharded_learn_step(mesh, **kw)(np.asarray(a), j_ids, caps, seed)
