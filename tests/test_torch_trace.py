"""The port's trace spans (``slim_tpu_torch.utils.span``): a learn under
``torch.profiler`` holds ``slim.learn`` and a ``<prefix>.<phase>`` span
for each of ``stats["phases"]``, as long as the phase (FSLIM's compact
selection: ``slim.cd.select``, one ``slim.wait.select`` a block); each
sweep of the CD loops is a ``slim.cd.sweep`` span with one
``slim.wait.live`` inside; a predict call holds ``slim.predict`` and the
span of its route; with no profiler running no ``record_function`` is
entered; and spans change no model and no list.  All on the CPU."""

import json
import os
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from slim_tpu_torch import SlimConfig, api, predict
from slim_tpu_torch.ops import cd_sweep as S
from slim_tpu_torch.ops.cd_kernel import per_col
from slim_tpu_torch.types import CSR
from slim_tpu_torch.utils import PhaseTimer, span


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(seed=3, nrows=80, ncols=40, density=0.15):
    m = sp.random(nrows, ncols, density=density, format="csr",
                  random_state=np.random.default_rng(seed),
                  data_rvs=lambda k: np.ones(k))
    return CSR.from_arrays(nrows, ncols, m.indptr, m.indices)


def _spans(prof, prefix="slim."):
    """(name, start, end) in microseconds of the spans whose name starts
    with ``prefix`` in the profile's Chrome trace, as a reader of the
    exported trace sees them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


NNBRS = 10
LEARNS = {
    "cd": (dict(block_size=16), "slim.cd"),
    # npad 256 over a compact threshold of 64: the union screen runs
    "cd-compact": (dict(block_size=16, compact_threshold=64), "slim.cd"),
    # FSLIM at full width selects inside each block's solve; on the compact
    # path the selection is the phase ``select``, a wait for each block
    "fslim": (dict(block_size=16, nnbrs=NNBRS), "slim.cd"),
    "fslim-compact": (dict(block_size=16, nnbrs=NNBRS, compact_threshold=64),
                      "slim.cd"),
    "admm": (dict(algo="admm"), "slim.admm"),
}


@pytest.mark.parametrize("case", sorted(LEARNS))
def test_a_profiled_learn_holds_a_span_as_long_as_each_phase(case):
    kw, prefix = LEARNS[case]
    (_, stats), spans = _profiled(
        lambda: api.learn(_matrix(), SlimConfig(**kw), device="cpu"))
    assert [s[0] for s in spans].count("slim.learn") == 1
    outer = next(s for s in spans if s[0] == "slim.learn")
    for name, secs in stats["phases"].items():
        mine = [s for s in spans if s[0] == f"{prefix}.{name}"]
        assert mine, name
        assert all(_inside(s, outer) for s in mine)
        got = sum(e - b for _, b, e in mine) * 1e-6
        assert abs(got - secs) <= max(0.05 * secs, 1e-3), (name, got, secs)
    if case == "cd-compact":
        assert any(s[0] == "slim.wait.screen" for s in spans)
    waits = [s for s in spans if s[0] == "slim.wait.select"]
    if case == "fslim-compact":
        select = [s for s in spans if s[0] == "slim.cd.select"]
        assert len(waits) == stats["fslim"]["blocks"] == 3
        assert all(_inside(w, select[0]) for w in waits)
        assert 0 < stats["fslim"]["neighbours"] <= NNBRS * 40
    else:
        assert "select" not in stats["phases"] and "fslim" not in stats
        assert not waits


def _block(npad, cap, seed=5, B=8, n=90):
    """A block problem of B columns over n items padded to npad, each
    column's sweeps capped at ``cap``, stopping at Σdx² < 1e-4."""
    rng = np.random.default_rng(seed)
    A = (rng.random((150, n)) < 0.2).astype(np.float32)
    G = np.zeros((npad, npad), np.float32)
    G[:n, :n] = A.T @ A
    J = np.arange(B) * 7 % n
    gj = G[:, J].T.copy()
    active = (gj > 0.3) & (np.arange(npad)[None, :] != J[:, None])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(G), t(gj), t(np.diagonal(G).copy()), t(active),
            torch.zeros((B, npad)), torch.full((B,), cap, dtype=torch.int32),
            t(np.diagonal(G)[J].copy()), per_col(0.3, B, "cpu"),
            per_col(0.5, B, "cpu"), 1e-4, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("cap", [200, 3])
@pytest.mark.parametrize("core", ["solve_core", "solve_large_core"])
def test_each_sweep_is_a_span_holding_one_liveness_wait(core, cap):
    """Converged (cap 200) and stopped by the cap (3 sweeps): one
    ``slim.cd.sweep`` per sweep the block took, each holding one
    ``slim.wait.live``; one ``slim.wait.tmax`` for the start."""
    out, spans = _profiled(lambda: getattr(S, core)(*_block(512, cap)))
    sweeps = int(out[1].max())
    assert sweeps > 1 and (cap > sweeps or sweeps == cap)
    loops = [s for s in spans if s[0] == "slim.cd.sweep"]
    lives = [s for s in spans if s[0] == "slim.wait.live"]
    assert len(loops) == len(lives) == sweeps
    assert all(sum(_inside(w, s) for w in lives) == 1 for s in loops)
    assert [s[0] for s in spans].count("slim.wait.tmax") == 1


def _serve(seed=4):
    model = _matrix(seed, nrows=60, ncols=60, density=0.2)
    hist = _matrix(seed + 1, nrows=100, ncols=60, density=0.1)
    return model, hist


ROUTES = {"dense": dict(sparse=False), "rows": dict(sparse=True),
          "coo": dict(sparse=True), "native": {}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_call_opens_the_span_of_its_route(route, monkeypatch):
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD",
                       "4096" if route == "native" else "0")
    monkeypatch.setenv("SLIM_PREDICT_COO_NPAD", "1" if route == "coo" else "0")
    model, hist = _serve()
    _, spans = _profiled(lambda: predict.predict_topn(
        model, hist, user_block=8, device="cpu", **ROUTES[route]))
    assert predict.last_route == route
    call = [s for s in spans if s[0] == "slim.predict"]
    assert len(call) == 1
    routes = {s[0] for s in spans if s[0].startswith("slim.predict.")} \
        - {"slim.predict.block"}
    assert routes == {f"slim.predict.{route}"}
    assert all(_inside(s, call[0]) for s in spans)
    lists = [s for s in spans if s[0] == "slim.wait.lists"]
    blocks = [s for s in spans if s[0] == "slim.predict.block"]
    if route == "native":
        assert not lists and not blocks
    else:
        # one block span per block, and the empty one that ends them
        assert len(lists) >= 1 and len(blocks) == len(lists) + 1
        assert not any(_inside(w, b) for w in lists for b in blocks)


def test_a_kept_split_is_a_hit_span(monkeypatch):
    """At "high" the first call on a resident W splits it inside its
    ``slim.predict.dense`` span (``slim.predict.split``); the next is
    served the kept split (an empty ``slim.predict.split_hit``)."""
    monkeypatch.setattr(predict, "_SPLIT", {})
    model, hist = _serve()
    W = predict.densify_model(model, device="cpu")
    names = []
    for _ in range(2):
        _, spans = _profiled(lambda: predict.predict_topn(
            model, hist, W_dev=W, precision="high", device="cpu"))
        dense = [s for s in spans if s[0] == "slim.predict.dense"]
        split = [s for s in spans if s[0].startswith("slim.predict.split")]
        assert len(dense) == len(split) == 1
        assert _inside(split[0], dense[0])
        names.append(split[0][0])
    assert names == ["slim.predict.split", "slim.predict.split_hit"]


class _Probe:
    """A stand-in for ``record_function`` that counts its entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Probe.entered += 1

    def __exit__(self, *exc):
        return False


def _every_spanned_path():
    A = _matrix()
    api.learn(A, SlimConfig(block_size=16), device="cpu")
    api.learn(A, SlimConfig(algo="admm"), device="cpu")
    api.learn(A, SlimConfig(block_size=16, nnbrs=NNBRS, compact_threshold=64),
              device="cpu")
    S.solve_core(*_block(512, 200))
    model, hist = _serve()
    predict.predict_topn(model, hist, device="cpu", sparse=False)
    predict.predict_topn(model, hist, device="cpu")


def test_no_record_function_is_entered_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Probe)
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD", "4096")
    _Probe.entered = 0
    _every_spanned_path()
    assert _Probe.entered == 0
    assert span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        _every_spanned_path()
    assert _Probe.entered > 0


def test_a_phase_is_a_span_and_charges_its_block():
    clock = PhaseTimer(torch.device("cpu"), "t")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with clock.phase("a"):
            sum(range(20000))
        with clock.phase("a"):
            pass
        with clock.phase("b"):
            pass
    names = [s[0] for s in _spans(prof, "t.")]
    assert sorted(names) == ["t.a", "t.a", "t.b"]
    assert set(clock.phases) == {"a", "b"}
    assert clock.phases["a"] > clock.phases["b"] >= 0
    with pytest.raises(RuntimeError):
        with clock.phase("c"):
            raise RuntimeError("the block failed")
    assert "c" not in clock.phases


def test_spans_change_no_model():
    A, cfg = _matrix(), SlimConfig(block_size=16)
    off = api.learn(A, cfg, device="cpu")[0]
    on = _profiled(lambda: api.learn(A, cfg, device="cpu"))[0][0]
    for a, b in ((off.indptr, on.indptr), (off.indices, on.indices),
                 (off.values(), on.values())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["dense", "rows", "native"])
def test_spans_change_no_list(route, monkeypatch):
    monkeypatch.setenv("SLIM_PREDICT_NATIVE_NPAD",
                       "4096" if route == "native" else "0")
    model, hist = _serve()
    kw = ROUTES[route]
    off = predict.predict_topn(model, hist, device="cpu", **kw)
    on = _profiled(lambda: predict.predict_topn(model, hist, device="cpu",
                                                **kw))[0]
    assert predict.last_route == route
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
