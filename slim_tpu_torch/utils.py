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
    """``device`` as given, else the first CUDA card when one is present,
    else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
