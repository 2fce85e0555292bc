"""Carry state across from the JAX package: a learned model as numpy
arrays, and a config as a plain dict (``dataclasses.asdict``), so both
packages compute on identical inputs.  Nothing here imports jax."""

from __future__ import annotations

import numpy as np

from .config import SlimConfig
from .types import CSR


def model_from_numpy(indptr, indices, data, nrows, ncols) -> CSR:
    """The port's CSR for a model given as CSR arrays (``data`` None means
    implicit ones).  ``predict.densify_model`` turns it into the dense
    device W."""
    return CSR.from_arrays(int(nrows), int(ncols), np.asarray(indptr),
                           np.asarray(indices),
                           None if data is None else np.asarray(data))


def config_from_dict(d: dict) -> SlimConfig:
    """SlimConfig from ``dataclasses.asdict`` of either package's config
    (same fields; unknown keys raise)."""
    return SlimConfig(**dict(d))
