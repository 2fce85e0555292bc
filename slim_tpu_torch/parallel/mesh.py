"""Process groups and the (dp, mp) device mesh (port of
slim_tpu/parallel/mesh.py).

The port runs one process per device, PyTorch's own idiom: NCCL between
cards (rank r on ``cuda:LOCAL_RANK``), gloo between CPU processes.  A
``torch.distributed.device_mesh.DeviceMesh`` of shape (dp, mp) with dim
names ("dp", "mp") takes the place of ``jax.sharding.Mesh``:

* ``dp`` -- user-row sharding for the Gram (partial Grams are summed over
  this dim, ``mesh.get_group("dp")``);
* ``mp`` -- item-column sharding for the solves.  Solves are embarrassingly
  parallel, so after the Gram reduction the column work is sharded over
  the flattened (dp, mp) grid: rank r = dp * mp_size + mp solves its own
  columns.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device

# a rank that raises leaves its peers blocked in a collective until this
# expires (gloo; NCCL's watchdog aborts the communicator after it)
TIMEOUT_S = 600


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Pick (dp, mp) with dp as close to sqrt as divides n_devices."""
    dp = int(np.floor(np.sqrt(n_devices)))
    while dp > 1 and n_devices % dp:
        dp -= 1
    return dp, n_devices // dp


def init_distributed(device=None, backend=None, init_method=None,
                     world_size=None, rank=None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join (or start) the default process group and return this rank's
    device.  A no-op apart from the device when a group already exists.

    ``device``: "cpu", or a card (default: the card, as
    :func:`~slim_tpu_torch.utils.resolve_device`; a card without an index
    becomes ``cuda:LOCAL_RANK`` modulo the visible cards).  ``backend``:
    default NCCL on a card and gloo on the CPU (gloo on a card stages every
    collective through the host, which lets several ranks share one card).
    The world comes from ``init_method`` / ``world_size`` / ``rank`` when
    given, else from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), else it is a one-rank world on an
    in-memory store."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank or 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and not ("RANK" in os.environ
                                    and "WORLD_SIZE" in os.environ):
        # a world of this process alone: an in-memory store, no file
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
        return dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timeout)
    return dev


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None, device=None):
    """The (dp, mp) DeviceMesh over every rank of the world, which is
    started by :func:`init_distributed` (with ``device``) when there is
    none yet.  One rank per device, so ``n_devices`` must be the world
    size; ``shape`` defaults to :func:`default_mesh_shape`.  Without a
    device and without a card it raises (``resolve_device``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_distributed(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} devices, the world has {world} "
                         "ranks (one device each)")
    dp, mp = shape if shape is not None else default_mesh_shape(n)
    if dp * mp != n:
        raise ValueError(f"mesh shape {(dp, mp)} != {n} devices")
    return init_device_mesh(dev.type, (dp, mp), mesh_dim_names=("dp", "mp"))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its card (the current one), or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
