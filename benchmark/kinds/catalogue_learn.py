"""Kind ``catalogue_learn``: the ``learn`` kind's traffic (back-to-back
``api.learn`` calls, each on a new port ``CSR`` over the run's arrays) at a
catalogue whose dense float64 Gram the reference cannot hold.

The comparison holds every kept model to the optimality of each of its
columns, as the ``learn`` kind does, through ``reference.sparse_learn``:
G[:, J] and (G W)[:, J] from the sparse ratings matrix a block of columns
at a time, never an n x n array; ``kkt_step`` is the longest exact CD step
of any column of any kept model, ``bad_entries`` the entries no SLIM model
holds.  The control ``tf32_step`` holds G once in float32 (exact: counts
below 2^24) and rounds it to TF32 in place.
"""

from __future__ import annotations

from pathlib import Path

from benchmark import harness
from benchmark.reference import learn as ref_learn
from benchmark.reference import sparse_learn as ref_sparse

learn = harness.load(Path(__file__).with_name("learn.py"), "bench_kind_learn")
Traffic = learn.Traffic


def judge(t, models, dev) -> dict:
    """kkt_step and bad_entries over ``models`` (host CSR triples) of
    ``t``'s matrix."""
    s = t.slim
    R = ref_sparse.Ratings(t.indptr, t.indices, t.ncols, dev)
    bad, entries = 0, []
    for indptr, indices, data in models:
        bad += ref_learn.bad_entries(indptr, indices, data, t.ncols)
        entries.append(ref_sparse.model_entries(indptr, indices, data, dev))
    steps = ref_sparse.step_norms(R, entries, s.l1r, s.l2r)
    return {"kkt_step": max((float(x.max()) for x in steps), default=0.0),
            "bad_entries": bad}


def tf32_step(t, dev) -> list:
    """The reference's exact CD update of every coordinate taken once from
    each kept model with G W in TF32 (operands rounded to TF32, float32
    sums), as a solver whose products ran in TF32 would leave it."""
    R = ref_sparse.Ratings(t.indptr, t.indices, t.ncols, dev)
    Gt = ref_sparse.round_tf32_(ref_sparse.dense_gram_f32(R))
    return [ref_sparse.tf32_step_model(
        R, Gt, ref_sparse.model_entries(*arrays, dev), t.slim.l1r,
        t.slim.l2r) for arrays in t.outputs()]


CONTROLS = {"tf32_step": tf32_step}
