"""Kind ``learn``: back-to-back ``api.learn`` calls on the run's ratings
matrix, each on a new port ``CSR`` over the same arrays, so no cache that
the port keeps on its input object (CSC view, column norms, device
uploads) serves a later learn.

The comparison holds every kept model (a seeded sample of the window's
learns, all of them where the window holds few) to the optimality of each
of its columns (``reference.learn``): ``kkt_step``, the longest exact CD
step of any column, and ``bad_entries``, entries no SLIM model holds.  The
reference works out the Gram again from the inputs the benchmark made.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import loops
from benchmark.reference import learn as ref_learn

SAMPLE_LEARNS = 6     # learned models kept for the comparison


class Traffic:
    KIND, SPAN = "learn", "bench.learn"

    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        from slim_tpu_torch.config import SlimConfig

        self.dev, self.seed = dev, seed
        self.nrows, self.ncols = cfg["users"], cfg["items"]
        self.indptr, self.indices, _ = loops.ratings(cfg, seed)
        self.slim = SlimConfig(**cfg["slim"])
        self.kept = loops.Reservoir(SAMPLE_LEARNS, seed)

    def _matrix(self):
        from slim_tpu_torch.types import CSR

        return CSR.from_arrays(self.nrows, self.ncols, self.indptr,
                               self.indices)

    def warm(self) -> None:
        from slim_tpu_torch import api

        api.learn(self._matrix(), self.slim, device=self.dev)
        loops.sync(self.dev)

    def unit(self) -> loops.Unit:
        from slim_tpu_torch import api

        A = self._matrix()
        t0 = time.perf_counter()
        model, stats = api.learn(A, self.slim, device=self.dev)
        t1 = time.perf_counter()
        self.kept.offer(model)
        return loops.Unit(t0, t1, A.ncols, stats=stats)

    def outputs(self) -> list:
        """The kept models as host (indptr, indices, data) triples."""
        return [model_arrays(m) for m in self.kept.items]

    def free(self) -> None:
        """Drop what the program holds on the device."""


def model_arrays(m):
    """(indptr, indices, data) of a port CSR model, data made explicit."""
    return (np.asarray(m.indptr), np.asarray(m.indices),
            np.asarray(m.values(), dtype=np.float32))


def judge(t: Traffic, models, dev) -> dict:
    """kkt_step and bad_entries over ``models`` (host CSR triples) of
    ``t``'s matrix."""
    s = t.slim
    G = ref_learn.gram(t.indptr, t.indices, t.ncols, dev)
    step, bad = 0.0, 0
    for indptr, indices, data in models:
        bad += ref_learn.bad_entries(indptr, indices, data, t.ncols)
        ent = ref_learn.model_entries(indptr, indices, data, dev)
        step = max(step, float(ref_learn.step_norms(
            G, ent, t.ncols, s.l1r, s.l2r).max()))
    return {"kkt_step": step, "bad_entries": bad}


def tf32_step(t: Traffic, dev) -> list:
    """The reference's exact CD update of every coordinate taken once from
    each kept model with G W in TF32 (operands rounded to TF32), as a
    solver whose products ran in TF32 would leave it."""
    G = ref_learn.gram(t.indptr, t.indices, t.ncols, dev)
    models = []
    for arrays in t.outputs():
        ent = ref_learn.model_entries(*arrays, dev)
        models.append(ref_learn.tf32_step_model(
            G, ent, t.ncols, t.slim.l1r, t.slim.l2r))
    return models


CONTROLS = {"tf32_step": tf32_step}
