"""Kind ``fslim_learn``: the ``learn`` kind's traffic (back-to-back
``api.learn`` calls, each on a new port ``CSR`` over the run's arrays)
with a configuration that selects FSLIM (``slim.nnbrs`` > 0, ``cos``).

The comparison holds every kept model to FSLIM's own optimum
(``reference.fslim``): the column's entries inside its neighbour set and
no more than ``nnbrs`` of them (``bad_entries``, beside the entries no
SLIM model holds), and ``kkt_step``, the longest exact CD step of any
column over the neighbours it must hold and its support.  Full SLIM's
check (``kinds/learn.py``) would fail an FSLIM model by design: it is
zero outside each column's neighbours.
"""

from __future__ import annotations

from pathlib import Path

from benchmark import harness
from benchmark.reference import fslim as ref_fslim
from benchmark.reference import learn as ref_learn

learn = harness.load(Path(__file__).with_name("learn.py"), "bench_kind_learn")
Traffic = learn.Traffic


def _neighbours(t, dev):
    """The float64 Gram of ``t``'s matrix, worked out again, and each
    column's neighbour threshold over it."""
    if t.slim.simtype != "cos":
        raise ValueError(f"the reference ranks by cos, not {t.slim.simtype}")
    G = ref_learn.gram(t.indptr, t.indices, t.ncols, dev)
    return ref_fslim.Neighbours(G, t.slim.nnbrs)


def judge(t, models, dev) -> dict:
    """kkt_step and bad_entries over ``models`` (host CSR triples) of
    ``t``'s matrix."""
    s = t.slim
    nb = _neighbours(t, dev)
    step, bad = 0.0, 0
    for indptr, indices, data in models:
        bad += ref_learn.bad_entries(indptr, indices, data, t.ncols)
        ent = ref_learn.model_entries(indptr, indices, data, dev)
        bad += ref_fslim.bad_entries(nb, ent)
        step = max(step, float(ref_fslim.step_norms(
            nb, ent, s.l1r, s.l2r).max()))
    return {"kkt_step": step, "bad_entries": bad}


def tf32_step(t, dev) -> list:
    """The reference's exact CD update of each kept model's neighbour and
    support coordinates, taken once with G W in TF32 (operands rounded to
    TF32, float32 sums), as a solver whose products ran in TF32 would
    leave it."""
    nb = _neighbours(t, dev)
    Gt = ref_learn.to_tf32(nb.G)

    def product(W):
        return (Gt @ ref_learn.to_tf32(W)).double()

    return [ref_fslim.stepped_model(
        nb, ref_learn.model_entries(*arrays, dev), t.slim.l1r, t.slim.l2r,
        product) for arrays in t.outputs()]


CONTROLS = {"tf32_step": tf32_step}
