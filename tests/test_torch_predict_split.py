"""The dense route's kept bfloat16 halves of a W that outlives the call
(``predict._halves_of``), on the CPU: a resident ``W_dev`` is split once
and served from the kept split while it lives unchanged; an in-place
write (to W or to a view of it) splits it again; "default" takes the
first of two kept halves; dropping W frees the halves; a W densified
inside the call is split every call; a :class:`DeviceModelPack`'s dense
W is kept until ``free_dense``.  Every list equals the one a freshly
split copy of W gives, bit for bit."""

import gc
import weakref

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch import predict as P
from test_torch_predict_precision import (HIGH_RTOL, K, N, _hist, _model,
                                          _oracle, _port)


@pytest.fixture(autouse=True)
def splits(monkeypatch):
    """The kept split emptied before and after each test, and the halves
    of every split_bf16 call the route makes, counted (the counter keeps
    no reference to W)."""
    made = []
    split = P.split_bf16

    def counted(W, halves):
        made.append(halves)
        return split(W, halves)

    P._SPLIT.clear()
    monkeypatch.setattr(P, "split_bf16", counted)
    yield made
    P._SPLIT.clear()


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _call(model, hist, W, precision="high"):
    return P.predict_topn(model, hist, nrcmds=K, W_dev=W,
                          precision=precision, device="cpu")


def test_a_resident_W_is_split_once(splits):
    model, hist = _port(_model()), _port(_hist("fractional"))
    W = P.densify_model(model, device="cpu")
    first = _call(model, hist, W)
    second = _call(model, hist, W)
    assert splits == [2]
    assert P._SPLIT["W"][0]() is W
    _equal(first, second)
    _equal(second, _call(model, hist, W.clone()))
    assert splits == [2, 2]


@pytest.mark.parametrize("where", ["W", "view"])
def test_an_in_place_write_splits_again(splits, where):
    """The new W's scores against the f64 oracle of the model written."""
    model, hist = _port(_model()), _port(_hist("ratings"))
    other = _model(seed=7)
    W = P.densify_model(model, device="cpu")
    _call(model, hist, W)
    new = P.densify_model(_port(other), device="cpu")
    if where == "W":
        W.copy_(new)
    else:
        W[:N].copy_(new[:N])
    assert torch.equal(W, new)
    ids, sc, cnt = _call(_port(other), hist, W)
    assert splits == [2, 2]
    S = _oracle(other, _hist("ratings"))
    np.testing.assert_array_equal(cnt, np.minimum((S > 0).sum(1), K))
    ok = ids >= 0
    ref = np.take_along_axis(S, np.maximum(ids, 0), 1)
    assert np.all(np.abs(sc[ok] - ref[ok]) <= HIGH_RTOL * ref[ok])
    _equal((ids, sc, cnt), _call(_port(other), hist, new))


def test_default_takes_the_first_of_two_kept_halves(splits):
    model, hist = _port(_model()), _port(_hist("fractional"))
    W = P.densify_model(model, device="cpu")
    _call(model, hist, W)
    got = _call(model, hist, W, "default")
    assert splits == [2]
    _equal(got, _call(model, hist, W.clone(), "default"))
    assert splits == [2, 1]
    assert torch.equal(P.split_bf16(W, 2)[:W.shape[0]],
                       P.split_bf16(W, 1))


def test_high_after_one_kept_half_splits_again(splits):
    model, hist = _port(_model()), _port(_hist("binary"))
    W = P.densify_model(model, device="cpu")
    _call(model, hist, W, "default")
    got = _call(model, hist, W)
    assert splits == [1, 2]
    assert P._SPLIT["W"][2] == 2
    _equal(got, _call(model, hist, W.clone()))


def test_dropping_W_frees_its_halves(splits):
    model, hist = _port(_model()), _port(_hist("binary"))
    W = P.densify_model(model, device="cpu")
    _call(model, hist, W)
    halves = weakref.ref(P._SPLIT["W"][3])
    del W
    gc.collect()
    assert P._SPLIT == {} and halves() is None


def test_highest_keeps_nothing(splits):
    model, hist = _port(_model()), _port(_hist("binary"))
    W = P.densify_model(model, device="cpu")
    _call(model, hist, W, "highest")
    _call(model, hist, W, "highest")
    assert splits == [] and P._SPLIT == {}


def test_a_W_densified_in_the_call_is_split_every_call(splits):
    """With no W_dev the call densifies its own W, which dies with the
    call: nothing stays kept, and no call is served a kept split."""
    model, hist = _port(_model()), _port(_hist("binary"))
    got = [_call(model, hist, None) for _ in range(2)]
    assert splits == [2, 2] and P._SPLIT == {}
    _equal(got[0], got[1])
    W = P.densify_model(model, device="cpu")
    _equal(got[0], _call(model, hist, W))
    _call(model, hist, None)
    assert splits == [2, 2, 2, 2] and P._SPLIT == {}


def test_a_device_pack_is_split_until_free_dense(splits):
    m = _port(random_csr(np.random.default_rng(13), 60, 30, density=0.2))
    model, stats = learn(m, SlimConfig(l1r=0.5, l2r=0.5),
                         keep_device_model=True, device="cpu")
    pack = stats["W_dev"]
    first = _call(model, m, pack)
    second = _call(model, m, pack)
    assert splits == [2]
    _equal(first, second)
    pack.free_dense()
    gc.collect()
    assert P._SPLIT == {}
    _equal(_call(model, m, pack), first)
    assert splits == [2, 2]
