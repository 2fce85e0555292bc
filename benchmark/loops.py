"""What every kind of traffic shares.  A mix (``traffic/<name>.json``) names
its kind and its parameters; the kind is a module of its own,
``kinds/<kind>.py``, found by that name, which provides

* ``Traffic(cfg, mix, seed, dev)``: builds the run's inputs from the
  configuration (``configs/<name>.json``) and the seed; ``warm()`` warms up
  every shape the window uses; ``unit()`` runs one unit (a learn, a
  request) and returns its :class:`Unit`; ``outputs()`` gives the kept
  outputs the comparison judges; ``free()`` drops the program's device
  state; ``KIND`` says what a unit is to the metric readers (``"learn"``
  or ``"serve"``), ``SPAN`` names a unit's trace span;
* ``judge(t, outputs, dev)``: the compared numbers of ``outputs`` against
  the plain reference (``reference/``);
* ``CONTROLS``: {name: ``fn(t, dev)``}, outputs of the control put in the
  program's place (``control.py``).

The window runs units back to back from its start and closes when the
first unit that ends after ``seconds`` ends.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from . import gen

@dataclasses.dataclass
class Unit:
    """One learn or one request of the window."""
    t0: float
    t1: float
    work: int                 # columns learned or users served
    stats: dict | None = None  # the learn's stats
    route: str | None = None   # the route that served a request
    failed: bool = False


class Reservoir:
    """A seeded uniform sample of ``k`` of the items offered."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng(
            gen.derived_seed(seed, gen.STREAM_SAMPLE))

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def ratings(cfg: dict, seed: int):
    """(indptr, indices, each item's popularity) of a run's ratings
    matrix: the configuration's matrix, drawn from ``gen.MATRIX_SEED``,
    with its users and items relabelled by ``seed``, so that every seed
    does the same work in another order."""
    pop = gen.popularity(cfg["items"], cfg["pop_exp"])
    indptr, indices = gen.ratings_matrix(cfg)
    new_row, new_col = gen.relabel_maps(cfg["users"], cfg["items"], seed)
    moved = np.empty_like(pop)
    moved[new_col] = pop
    return (*gen.relabel(indptr, indices, new_row, new_col), moved)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(t, seconds: float, span=None):
    """Units back to back from the window's start until the first that
    ends after ``seconds``; returns (start, end, units).  A unit that
    raises is counted as failed, with the time it took.  ``span(name)``,
    when given, wraps each unit in a named trace span."""
    units = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            if span is None:
                u = t.unit()
            else:
                with span(t.SPAN):
                    u = t.unit()
        except Exception as e:   # counted, and the window goes on
            print(f"unit failed: {type(e).__name__}: {e}", file=sys.stderr)
            u = Unit(t0, time.perf_counter(), 0, failed=True)
        units.append(u)
        if u.t1 - start >= seconds:
            return start, u.t1, units
