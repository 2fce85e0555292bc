"""Warm start, device-model retention and the wide-block variant routing of
the port's solver, held against the JAX package on the same seeded data."""

import numpy as np
import pytest
import torch

from conftest import random_csr
from slim_tpu.config import SlimConfig as JaxConfig
from slim_tpu.solvers.cd import estimate_model_cd as jax_estimate
from slim_tpu_torch import SlimConfig
from slim_tpu_torch.ops import cd_sweep
from slim_tpu_torch.predict import DeviceModelPack, densify_model
from slim_tpu_torch.solvers import cd
from slim_tpu_torch.types import CSR


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


# (matrix, config) of tests/test_cd.py:115 (full width) and
# tests/test_compact.py:23 (compact unions)
WARM_CASES = {
    "full": (lambda: random_csr(np.random.default_rng(5), 60, 24,
                                density=0.3),
             dict(l1r=0.4, l2r=0.6, optTol=1e-12, shuffle=False)),
    "compact": (lambda: random_csr(np.random.default_rng(0), 60, 40,
                                   density=0.25, seed=141),
                dict(l1r=0.3, l2r=0.5, optTol=1e-12, block_size=16,
                     shuffle=False, compact_threshold=128)),
}


@pytest.mark.parametrize("case", sorted(WARM_CASES))
def test_warm_start_reaches_the_cold_optimum(case):
    """Warm from the cold model: the same model (atol 5e-4) in no more
    column-iterations, as in the JAX package, whose warm model it equals."""
    make, kw = WARM_CASES[case]
    mat = make()
    cold, s_cold = cd.estimate_model_cd(_port(mat), SlimConfig(**kw),
                                        device="cpu")
    warm, s_warm = cd.estimate_model_cd(_port(mat), SlimConfig(**kw),
                                        imodel=cold, device="cpu")
    np.testing.assert_allclose(warm.to_dense(), cold.to_dense(), atol=5e-4)
    assert s_warm["niters"] <= s_cold["niters"]
    jcold, _ = jax_estimate(mat, JaxConfig(**kw))
    jwarm, _ = jax_estimate(mat, JaxConfig(**kw), imodel=jcold)
    np.testing.assert_allclose(warm.to_dense(),
                               jwarm.to_scipy().toarray(), atol=5e-4)


RETAIN_CASES = {
    "full": (lambda: random_csr(None, 60, 37, density=0.25, seed=5),
             dict(l1r=0.3, l2r=0.5, optTol=1e-9, block_size=16)),
    "compact": (lambda: random_csr(None, 200, 300, density=0.05, seed=11),
                dict(l1r=1.0, l2r=1.0, optTol=1e-9, block_size=32,
                     compact_threshold=64)),
}


@pytest.mark.parametrize("case", sorted(RETAIN_CASES))
def test_keep_device_model_densifies_to_the_model(case):
    """The retained pack densifies to exactly densify_model of the
    assembled CSR (tests/test_cd.py:315-350), and the model's nnz is the
    JAX package's within 1%."""
    make, kw = RETAIN_CASES[case]
    mat = make().infer_ncols()
    model, stats = cd.estimate_model_cd(_port(mat), SlimConfig(**kw),
                                        keep_device_model=True, device="cpu")
    pack = stats["W_dev"]
    assert isinstance(pack, DeviceModelPack)
    ref = densify_model(model, npad=pack.npad, device="cpu")
    torch.testing.assert_close(pack.densify(), ref, rtol=0, atol=1e-6)
    pack.free_dense()
    assert pack._W is None
    jmodel, _ = jax_estimate(mat, JaxConfig(**kw))
    assert abs(model.nnz - jmodel.nnz) <= max(2, 0.01 * jmodel.nnz)


@pytest.mark.parametrize("case", sorted(RETAIN_CASES))
def test_warm_x0_from_pack_equals_x0_from_model(case):
    """Every block's x0 densified from the retained pack equals the x0
    densified from the model's columns."""
    make, kw = RETAIN_CASES[case]
    mat = _port(make().infer_ncols())
    model, stats = cd.estimate_model_cd(mat, SlimConfig(**kw),
                                        keep_device_model=True, device="cpu")
    pack = stats["W_dev"]
    n, npad, B = mat.ncols, pack.npad, kw["block_size"]
    from_pack = cd.warm_runs(model, pack, pack.p_pad, pack.posmap_pad, n,
                             "cpu")
    from_csc = cd.warm_runs(model, None, pack.p_pad, pack.posmap_pad, n,
                            "cpu")
    assert from_pack[0] is pack.idx and from_csc[0] is not pack.idx
    for r0 in range(0, n, B):
        nJ = min(B, n - r0)
        a = cd.warm_x0(from_pack, r0, nJ, B, n, npad)
        b = cd.warm_x0(from_csc, r0, nJ, B, n, npad)
        assert torch.equal(a, b)
        assert a.abs().sum() > 0 or r0 > 0


def test_wide_blocks_take_the_chosen_variant(monkeypatch):
    """With SLIM_PALLAS_V4=0 a 512-wide block (one group: no whole v3
    window) solves on the eager loop, cold and warm, and reaches the plain
    solve's optimum."""
    mat = _port(random_csr(None, 150, 450, density=0.03, seed=3))
    kw = dict(l1r=0.5, l2r=1.0, optTol=1e-9, block_size=256, shuffle=False)
    plain, s_plain = cd.estimate_model_cd(mat, SlimConfig(**kw),
                                          device="cpu")
    seen = []
    panel = cd_sweep.solve_panel_core

    def spy(*a, variant, **k):
        seen.append((variant, k["x0_zero"]))
        return panel(*a, variant=variant, **k)

    monkeypatch.setenv("SLIM_PALLAS_V4", "0")
    monkeypatch.setattr(cd_sweep, "solve_panel_core", spy)
    monkeypatch.setattr(cd, "pick_impl", lambda w, d, t: "sweep_large")
    model, stats = cd.estimate_model_cd(mat, SlimConfig(**kw), device="cpu")
    warm, s_warm = cd.estimate_model_cd(mat, SlimConfig(**kw), imodel=model,
                                        device="cpu")
    assert seen == [("eager", True)] * 2 + [("eager", False)] * 2
    np.testing.assert_allclose(stats["loss"], s_plain["loss"], rtol=1e-4)
    np.testing.assert_allclose(model.to_dense(), plain.to_dense(), atol=5e-4)
    np.testing.assert_allclose(s_warm["loss"], s_plain["loss"], rtol=1e-4)
    assert s_warm["niters"] <= stats["niters"]
