"""Densify and pack: the port's plain versions against the JAX package's
Pallas kernels run in interpret mode (exact)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from slim_tpu.ops.cd_kernel import pack_flat as jax_pack_flat
from slim_tpu.ops.pallas_gram import RT, densify_meta as jax_meta
from slim_tpu.ops.pallas_gram import pallas_densify
from slim_tpu.ops.pallas_pack import pallas_pack
from slim_tpu_torch.ops import densify as D
from slim_tpu_torch.ops import pack as P


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, npad, W, R, dup):
    lens = rng.integers(0, W + 1, R)
    lens[0] = W
    idsT = np.full((W, R), npad, np.int32)
    valsT = np.zeros((W, R), np.float32)
    for r in range(R):
        c = np.sort(rng.choice(npad, lens[r], replace=False))
        if dup and lens[r] > 1:
            c[1] = c[0]                       # a duplicated id accumulates
        idsT[:lens[r], r] = c
        valsT[:lens[r], r] = rng.integers(1, 8, lens[r])
    return idsT, valsT


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("dup", [False, True])
def test_densify_matches_pallas_interpret(rng, binary, dup):
    """Sentinel pads, short and full rows, two row tiles, duplicates."""
    npad, W, R = 256, 64, 2 * RT
    idsT, valsT = _rows(rng, npad, W, R, dup)
    ids_j = jnp.asarray(idsT)
    want = np.asarray(pallas_densify(
        ids_j, None if binary else jnp.asarray(valsT), *jax_meta(ids_j, npad),
        npad, out_dtype=jnp.float32, interpret=True))
    ids_t = torch.from_numpy(idsT)
    wmax = D.densify_meta(ids_t, npad)
    assert wmax.tolist() == np.asarray(jax_meta(ids_j, npad)[0]).tolist()
    got = D.densify(ids_t, None if binary else torch.from_numpy(valsT), wmax,
                    npad)
    np.testing.assert_array_equal(got.numpy(), want)
    if binary:
        got8 = D.densify(ids_t, None, wmax, npad, out_dtype=torch.int8)
        np.testing.assert_array_equal(got8.numpy().astype(np.float32), want)


def test_gathered_densify_and_runs_match_host(rng):
    """CSR runs (n_valid drop), rows of up to 300 entries and an empty
    one, all in one densify_runs call == host scatter."""
    npad, n = 256, 200
    R = 40
    lens = rng.integers(0, 300, R)
    lens[3] = 0
    idx = rng.integers(0, npad, int(lens.sum())).astype(np.int32)
    val = rng.integers(1, 5, idx.size).astype(np.float32)
    rs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = np.zeros((npad, R), np.float32)
    for r in range(R):
        sl = slice(rs[r], rs[r] + lens[r])
        keep = idx[sl] < n
        np.add.at(want, (idx[sl][keep], r), val[sl][keep])
    out = torch.zeros((npad, R))
    D.densify_runs(torch.from_numpy(idx), torch.from_numpy(val), rs, lens,
                   npad, n, out)
    np.testing.assert_array_equal(out.numpy(), want)


def test_densify_validates_and_stays_plain_on_cpu():
    ids = torch.zeros((32, RT), dtype=torch.int32)
    before = D.densify.launches
    D.densify(ids, None, D.densify_meta(ids, 128), 128)
    assert D.densify.launches == before      # CPU tensors: plain version
    with pytest.raises(ValueError):
        D.densify(ids.to(torch.int64), None, D.densify_meta(ids, 128), 128)
    with pytest.raises(ValueError):
        D.densify(ids, torch.ones((32, RT)), D.densify_meta(ids, 128), 128,
                  out_dtype=torch.int8)


@pytest.mark.parametrize("B,K,dens", [(8, 256, 0.3), (16, 384, 0.05),
                                      (8, 128, 0.9), (8, 256, 0.0)])
def test_pack_matches_pallas_interpret(rng, B, K, dens):
    """Bit-equal to pallas_pack (interpret) and pack_flat, both id widths."""
    x = np.where(rng.random((B, K)) < dens,
                 rng.random((B, K)).astype(np.float32) + 0.5,
                 0.0).astype(np.float32)
    x[0, :3] = 5e-8                           # below eps: not packed
    c = (x > np.float32(1e-7)).sum(axis=1).astype(np.int32)
    off = np.zeros(B, np.int32)
    np.cumsum(c[:-1], out=off[1:])
    Tpad = max(1 << max(int(c.sum()) - 1, 0).bit_length(), 128)
    fv, fi = P.pack(torch.from_numpy(x), torch.from_numpy(off), 1e-7, Tpad)
    for idx16 in (True, False):
        v0, i0 = jax_pack_flat(jnp.asarray(x), 1e-7, jnp.asarray(off), Tpad,
                               idx16)
        v1, i1 = pallas_pack(jnp.asarray(x), jnp.asarray(off), 1e-7, Tpad,
                             idx16, interpret=True)
        for v, i in ((v0, i0), (v1, i1)):
            np.testing.assert_array_equal(fv.numpy(), np.asarray(v))
            np.testing.assert_array_equal(
                fi.numpy().astype(np.asarray(i).dtype), np.asarray(i))


def test_pack_validates():
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        P.pack(x, torch.zeros(4, dtype=torch.int64), 1e-7, 128)
    with pytest.raises(ValueError):
        P.pack(x.to(torch.float64), torch.zeros(4, dtype=torch.int32), 1e-7,
               128)
