"""Small shared utilities."""

from __future__ import annotations

import torch


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
