"""Gram and screen of the PyTorch port against the JAX package."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from conftest import random_csr
from slim_tpu.ops import cd_kernel as jcd
from slim_tpu.ops.gram import gram_host as jax_gram_host
from slim_tpu_torch import SlimConfig, learn
from slim_tpu_torch.ops import cd_kernel as tcd
from slim_tpu_torch.ops import gram as tgram
from slim_tpu_torch.types import CSR
from slim_tpu_torch.utils import resolve_device


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs, restored after it: the
    suite runs several pytest workers on the same cores, and the plain
    versions' many small ops stall when every worker runs a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(m):
    return CSR.from_arrays(m.nrows, m.ncols, m.indptr, m.indices, m.data)


@pytest.mark.parametrize("implicit", [True, False])
def test_gram_device_matches_host(rng, implicit):
    """Densify + contraction == the JAX package's host SpGEMM: exact for
    binary data (int8 -> int32), rtol 1e-5 for valued data."""
    mat = random_csr(rng, 700, 100, density=0.12, implicit=implicit)
    want = jax_gram_host(mat, pad_to=128)
    got = tgram.gram_device(_port(mat), pad_to=128, device="cpu").numpy()
    if implicit:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("implicit", [True, False])
def test_gram_long_row_residual(rng, monkeypatch, implicit):
    """Rows far wider than the rest (a 64-nnz power row) densify in one
    call with them, in blocks sized by a width cap (WCAP) lowered below
    the long rows; totals match the host exactly."""
    dense = (rng.random((40, 64)) < 0.1) * rng.integers(1, 5, (40, 64))
    dense[3, :] = 2            # a 64-nnz power row
    dense[17, :50] = 1
    mat = CSR.from_scipy(sp.csr_matrix(dense.astype(np.float32)))
    if implicit:
        mat = mat.binarize()
    monkeypatch.setattr(tgram, "WCAP", 32)
    got = tgram.gram_device(mat, pad_to=128, device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_gram_host(mat, pad_to=128))


def test_compute_gram_modes(rng):
    mat = _port(random_csr(rng, 50, 30, density=0.2))
    h = tgram.compute_gram(mat, "host", pad_to=128, device="cpu")
    d = tgram.compute_gram(mat, "device", pad_to=128, device="cpu")
    a = tgram.compute_gram(mat, "auto", pad_to=128, device="cpu")
    np.testing.assert_allclose(d.numpy(), h.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(a.numpy(), h.numpy())
    with pytest.raises(ValueError):
        tgram.compute_gram(mat, "nope")


def test_gram_default_device_is_resolved(rng, monkeypatch):
    """With no device the port runs on the card: ``resolve_device()`` is
    cuda when a card is present (checked without allocating), and with no
    card it and the entry points called without a device raise, never
    falling back to the CPU; an explicit device is kept."""
    mat = _port(random_csr(rng, 50, 30, density=0.2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    for mode in ("host", "device", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tgram.compute_gram(mat, mode, pad_to=128)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tgram.gram_device(mat, pad_to=128)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        learn(mat, SlimConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


@pytest.mark.parametrize("B", [32, 64, 96])
def test_union_flags_and_ids_match_jax(rng, B):
    mat = random_csr(rng, 300, 200, density=0.05)
    G = jax_gram_host(mat, pad_to=256)
    nblocks = -(-200 // B)
    uj = jcd.block_union_flags(jnp.asarray(G), nblocks, B, 1.0)
    ut = tcd.block_union_flags(torch.from_numpy(G), nblocks, B, 1.0)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    ids_j, cnt_j = jcd.compact_union_ids(uj)
    ids_t, cnt_t = tcd.compact_union_ids(ut)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def test_block_union_mask_and_count_over_match_jax(rng):
    mat = random_csr(rng, 300, 200, density=0.05)
    G = jax_gram_host(mat, pad_to=256)
    J = np.arange(40, 72, dtype=np.int32)
    Sj, cj = jcd.block_union_mask(jnp.asarray(G), jnp.asarray(J), 1.0, 128)
    St, ct, _ = tcd.block_union_mask(torch.from_numpy(G),
                                     torch.from_numpy(J), 1.0, 128)
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    assert ct == int(cj)
    x = np.where(rng.random((8, 256)) < 0.3, rng.random((8, 256)), 0) \
        .astype(np.float32)
    x[0, :4] = 1e-8
    np.testing.assert_array_equal(
        tcd.count_over(torch.from_numpy(x), 1e-7).numpy(),
        np.asarray(jcd.count_over(jnp.asarray(x), 1e-7)))
