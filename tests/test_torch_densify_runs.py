"""The port's densify_runs (its plain version, on the CPU) against the JAX
package's gathered_densifyT / pallas_densify in interpret mode: exact at
integer sums, with ids unsorted within runs, duplicated ids, n_valid
drops, runs longer than 4,096 entries, accumulation into a column slice,
both output layouts, and bfloat16 sums rounded once."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from slim_tpu.ops.pallas_gram import densify_meta as jax_meta
from slim_tpu.ops.pallas_gram import gathered_densifyT, pallas_densify
from slim_tpu_torch.ops import densify as D

JAX_DT = {torch.float32: jnp.float32, torch.int8: jnp.int8,
          torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.int8, torch.bfloat16]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(seed, R, npad, wmax, order, dup):
    """A flat CSR of R runs of 0..wmax ids below npad + 8 (ids >= npad
    stand for items past the catalogue) with integer values 1-5: ids
    ascending, or shuffled within each run; with ``dup`` a run's second
    id repeats its first."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, wmax + 1, R)
    lens[0], lens[5] = wmax, 0
    idx, val = [], []
    for L in lens:
        c = rng.choice(npad + 8, L, replace=False)
        c = np.sort(c) if order == "sorted" else rng.permutation(c)
        if dup and L > 1:
            c[1] = c[0]
        idx.append(c)
        val.append(rng.integers(1, 6, L))
    idx = np.concatenate(idx).astype(np.int32)
    val = np.concatenate(val).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return idx, val, starts, lens


def _port(idx, val, starts, lens, npad, n_valid, dtype, row_major=False):
    R = len(lens)
    out = torch.empty((R, npad) if row_major else (npad, R), dtype=dtype)
    return D.densify_runs(torch.from_numpy(idx),
                          None if val is None else torch.from_numpy(val),
                          starts, lens, npad, n_valid, out,
                          row_major=row_major)


def _jax(idx, val, starts, lens, W, npad, n_valid, dtype):
    got = gathered_densifyT(
        jnp.asarray(idx), None if val is None else jnp.asarray(val),
        jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), W, npad, val is None,
        JAX_DT[dtype], n_valid=n_valid, interpret=True)
    return np.asarray(got.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order,dup", [("sorted", False),
                                       ("shuffled", False),
                                       ("shuffled", True)])
def test_runs_match_gathered_densify(dtype, order, dup):
    """f32 and bf16 on integer values, int8 on binary data; ids >=
    n_valid (200 of npad 256) and >= npad dropped."""
    npad, R, W, n_valid = 256, 256, 64, 200
    idx, val, starts, lens = _runs(1, R, npad, W, order, dup)
    if dtype == torch.int8:
        val = None
    got = _port(idx, val, starts, lens, npad, n_valid, dtype)
    assert got.dtype == dtype
    want = _jax(idx, val, starts, lens, W, npad, n_valid, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want.max() > (1 if dup else 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_longer_than_4096(dtype):
    """A run of 5,000 entries (ids with repeats) beside short ones, in one
    call, against numpy's np.add.at."""
    rng = np.random.default_rng(2)
    npad, n_valid = 384, 300
    lens = np.array([5000, 3, 0, 17, 4500])
    idx = rng.integers(0, npad, lens.sum()).astype(np.int32)
    val = None if dtype == torch.int8 else \
        rng.integers(1, 3, idx.size).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = np.zeros((npad, len(lens)), np.int64)
    for r, (s, L) in enumerate(zip(starts, lens)):
        c = idx[s:s + L]
        v = np.ones(L, np.int64) if val is None else val[s:s + L]
        keep = c < n_valid
        np.add.at(want, (c[keep], r), v[keep].astype(np.int64))
    got = _port(idx, val, starts, lens, npad, n_valid, dtype)
    ref = want.astype(np.int8) if dtype == torch.int8 else \
        torch.from_numpy(want.astype(np.float32)).to(dtype).float().numpy()
    assert want.max() > 10
    np.testing.assert_array_equal(got.float().numpy() if dtype != torch.int8
                                  else got.numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulate_into_column_slice(dtype):
    """``accumulate`` adds into a column slice of a wider block and
    leaves the other columns as they were; bfloat16 rounds once, the old
    value plus the sum."""
    npad, R, W = 256, 256, 32
    idx, val, starts, lens = _runs(3, R, npad, W, "shuffled", True)
    if dtype == torch.int8:
        val = None
    rng = np.random.default_rng(4)
    init = rng.integers(0, 4, (npad, R + 9)).astype(np.float32)
    init[:, 4] = 256.0 if dtype == torch.bfloat16 else 2.0
    wide = torch.from_numpy(init.copy()).to(dtype)
    D.densify_runs(torch.from_numpy(idx),
                   None if val is None else torch.from_numpy(val),
                   starts, lens, npad, None, wide[:, 4:4 + R],
                   accumulate=True)
    sums = _jax(idx, val, starts, lens, W, npad, None, torch.float32)
    want = init.copy()
    want[:, 4:4 + R] += sums
    want = torch.from_numpy(want).to(dtype).float().numpy()
    np.testing.assert_array_equal(wide.float().numpy(), want)
    assert sums[:, 0].max() > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_row_major_is_transposed_T(dtype, accumulate):
    """The row-major block (R, npad) equals the transposed block's .T,
    written afresh or accumulated into."""
    npad, R, W = 256, 256, 48
    idx, val, starts, lens = _runs(5, R, npad, W, "shuffled", True)
    if dtype == torch.int8:
        val = None
    args = (torch.from_numpy(idx),
            None if val is None else torch.from_numpy(val), starts, lens,
            npad, 250)
    base = torch.from_numpy(np.random.default_rng(6).integers(
        0, 3, (npad, R)).astype(np.float32)).to(dtype)
    cT = D.densify_runs(*args, base.clone(), accumulate=accumulate)
    rm = D.densify_runs(*args, base.T.contiguous(), accumulate=accumulate,
                        row_major=True)
    assert rm.shape == (R, npad)
    assert torch.equal(rm, cT.T) and cT.float().max() >= 2


@pytest.mark.parametrize("entry", ["runs", "layout"])
def test_bf16_rounds_once(entry):
    """A column of entries 256, 1 and 1 densifies into bfloat16 as 258,
    as the JAX kernel (which sums its tile in float32 and casts once)
    gives; rounding per entry would give 256 (256 + 1 ties to even)."""
    npad, W, R = 128, 32, 256
    idsT = np.full((W, R), npad, np.int32)
    valsT = np.zeros((W, R), np.float32)
    idsT[:3, 7] = 5
    valsT[:3, 7] = (256.0, 1.0, 1.0)
    idsT[:2, 9] = (3, 3)
    valsT[:2, 9] = (1.5, 0.25)
    ids_j = jnp.asarray(idsT)
    want = np.asarray(pallas_densify(
        ids_j, jnp.asarray(valsT), *jax_meta(ids_j, npad), npad,
        out_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32))
    assert want[5, 7] == 258.0
    if entry == "layout":
        ids_t = torch.from_numpy(idsT)
        got = D.densify_bf16(ids_t, torch.from_numpy(valsT),
                             D.densify_meta(ids_t, npad), npad)
    else:
        lens = (idsT < npad).sum(axis=0)
        keep = idsT.T < npad                       # run r = column r
        got = _port(idsT.T[keep].copy(), valsT.T[keep].copy(),
                    np.concatenate([[0], np.cumsum(lens)[:-1]]), lens, npad,
                    None, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_runs_validate():
    """Bad operands raise before any work: an int64 id vector, an int8
    block of valued data, a block of the wrong shape, and a run that
    reaches past the ids."""
    idx = torch.zeros(10, dtype=torch.int32)
    out = torch.empty((64, 2))
    with pytest.raises(ValueError):
        D.densify_runs(idx.long(), None, [0, 5], [5, 5], 64, None, out)
    with pytest.raises(ValueError):
        D.densify_runs(idx, torch.ones(10), [0, 5], [5, 5], 64, None,
                       torch.empty((64, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        D.densify_runs(idx, None, [0, 5], [5, 5], 64, None,
                       torch.empty((2, 64)))
    with pytest.raises(ValueError):
        D.densify_runs(idx, None, [0, 6], [5, 5], 64, None, out)
    before = D.densify.launches
    D.densify_runs(idx, None, [0, 5], [5, 5], 64, None, out)
    assert D.densify.launches == before       # CPU tensors: plain version
    assert out[0].tolist() == [5.0, 5.0] and out[1:].abs().sum() == 0


def test_c_entry_matches_its_binding():
    """ops/_build's ctypes argument list for slim_densify has one type per
    parameter of the C entry in csrc/densify.cu, pointers as void* and
    the long long / int parameters in their places (ctypes passes any
    extra argument as a C int, which would cut a pointer)."""
    import re

    from slim_tpu_torch.ops import _build

    src = (_build.SRC_DIR / "densify.cu").read_text()
    params = re.search(r'extern "C" int slim_densify\(([^)]*)\)',
                       src).group(1).split(",")
    kinds = [_build._P if "*" in p else _build._LL if "long long" in p
             else _build._I for p in params]
    assert kinds == _build._SIGNATURES["slim_densify"]
