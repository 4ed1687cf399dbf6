"""The port's kernels (dask_ml_tpu_torch/ops/fused.py) on the CPU, where
each wrapper runs its plain PyTorch version, held against the Pallas
kernels of dask_ml_tpu/ops/pallas_fused.py run with ``interpret=True``.
The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py). Inputs come from
``numpy.random.RandomState`` and go to both packages."""

import numpy as np
import pytest
import torch

from dask_ml_tpu.ops.pallas_fused import (
    fused_assign_update as pl_assign_update,
    fused_glm_value_grad as pl_glm_value_grad,
    fused_lloyd_stats as pl_lloyd_stats,
)
from dask_ml_tpu_torch.ops import fused
from dask_ml_tpu_torch.ops.fused import (
    LLOYD_SMEM_MAX, fused_assign_update, fused_glm_value_grad,
    fused_lloyd_stats, lloyd_geometry,
)


def _glm_inputs(seed, n, d, family):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = (rng.randn(d) * 0.1).astype(np.float32)
    if family == "logistic":
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(1.0, size=n).astype(np.float32)
    else:
        y = rng.randn(n).astype(np.float32)
    return X, y, beta


# n=391 with n_valid=350: a masked tail and n not a multiple of 128;
# n=300: every row valid, again not a 128-multiple (the Pallas kernel
# pads to its tile, the port masks in place)
@pytest.mark.parametrize("n,n_valid", [(391, 350), (300, 300)])
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("bf16", [False, True])
def test_glm_value_grad_matches_pallas(family, bf16, n, n_valid):
    import jax.numpy as jnp

    X, y, beta = _glm_inputs(2, n, 13, family)
    xj = jnp.asarray(X, jnp.bfloat16) if bf16 else X
    v_ref, g_ref = pl_glm_value_grad(xj, n_valid, y, beta, family=family,
                                     interpret=True)
    xt = torch.from_numpy(X)
    if bf16:
        xt = xt.to(torch.bfloat16)
    v, g = fused_glm_value_grad(xt, n_valid, torch.from_numpy(y),
                                torch.from_numpy(beta), family)
    # f32: both sum the same f32 terms in another order (rtol 1e-5 on
    # the loss, 1e-4 on the gradient, as tests/test_pallas_glm.py:72-73).
    # bf16: the residual is rounded to bf16 (8 bits) in both; a residual
    # one f32 ulp apart can round to neighbouring bf16 values, so the
    # gradient gets 2**-8 relative on single rows: rtol/atol 1e-3.
    tol = dict(rtol=1e-3, atol=1e-3) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **tol)


def _near_tie_labels(x, c, lab, lab_ref):
    """Labels equal except on f32 near-ties: where they differ, the
    picked center's d2 is within rounding noise of the row minimum
    (the rule of tests/test_kmeans.py:114-118)."""
    d2 = ((x * x).sum(1)[:, None] - 2.0 * (x @ c.T)
          + (c * c).sum(1)[None, :]).clip(min=0)
    diff = np.flatnonzero(lab != lab_ref)
    np.testing.assert_allclose(d2[diff, lab[diff]], d2[diff, lab_ref[diff]],
                               rtol=1e-5, atol=1e-4)


LLOYD_CASES = [(256, 8, 4, 256), (137, 7, 3, 130), (1000, 13, 5, 900),
               (513, 3, 2, 500)]


@pytest.mark.parametrize("n,d,k,n_valid", LLOYD_CASES)
def test_lloyd_stats_matches_pallas(n, d, k, n_valid):
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    s_ref, n_ref, i_ref = (np.asarray(v) for v in pl_lloyd_stats(
        x, n_valid, c, interpret=True))
    sums, counts, inertia = fused_lloyd_stats(torch.from_numpy(x), n_valid,
                                              torch.from_numpy(c))
    # counts are integers in the port (f32 in Pallas) and must match
    # exactly; sums add the same f32 rows in another order (1e-4); the
    # inertia is a sum of n_valid f32 terms (rtol 1e-4)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), n_ref.astype(np.int64))
    np.testing.assert_allclose(sums.numpy(), s_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(i_ref), rtol=1e-4)


@pytest.mark.parametrize("n,d,k,n_valid", LLOYD_CASES)
def test_assign_update_matches_pallas(n, d, k, n_valid):
    rng = np.random.RandomState(1)
    x = rng.randn(n, d).astype(np.float32)
    mask = (np.arange(n) < n_valid).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    ref = [np.asarray(v) for v in pl_assign_update(x, mask, c,
                                                   interpret=True)]
    out = [v.numpy() for v in fused_assign_update(
        torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(c))]
    lab, mind, sums, counts, inertia = out
    _near_tie_labels(x, c, lab, ref[0])
    # masked min-d2: the same expansion in another order (1e-4)
    np.testing.assert_allclose(mind, ref[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sums, ref[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts, ref[3].astype(np.int64))
    np.testing.assert_allclose(inertia, ref[4], rtol=1e-4)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers are their plain versions: no launch
    is counted, and the result is the plain version's."""
    fused.reset_launches()
    X, y, beta = _glm_inputs(3, 64, 5, "logistic")
    args = (torch.from_numpy(X), 60, torch.from_numpy(y),
            torch.from_numpy(beta), "logistic")
    v, g = fused_glm_value_grad(*args)
    v0, g0 = fused.glm_value_grad_plain(*args)
    assert float(v) == float(v0) and torch.equal(g, g0)
    c = torch.from_numpy(X[:3])
    fused_lloyd_stats(torch.from_numpy(X), 60, c)
    fused_assign_update(torch.from_numpy(X), torch.ones(64), c)
    assert fused.launches() == {name: 0 for name in fused.KERNELS}


def test_shape_gates_are_rules():
    """The Lloyd kernel's geometry is a rule on (d, k) alone, and every
    (d, k) has one: no shape is refused. The main path's shape keeps a
    whole row per step, the centers resident and the sums in shared
    memory; wider rows and more centers are cut into chunks."""
    main = lloyd_geometry(128, 64)
    assert (main.n_fc, main.n_cc, main.sums_smem) == (1, 1, True)
    assert lloyd_geometry(128, 64) == main
    for d, k in [(1, 1), (3, 2), (7, 3), (128, 256), (300, 64), (768, 64),
                 (1001, 70), (8192, 1024), (20000, 8)]:
        g = lloyd_geometry(d, k)
        assert g.smem <= LLOYD_SMEM_MAX
        assert g.fc % 4 == 0 and g.n_fc * g.fc >= d > (g.n_fc - 1) * g.fc
        assert g.n_cc * 64 >= k > (g.n_cc - 1) * 64
    assert lloyd_geometry(128, 256).n_cc == 4
    assert lloyd_geometry(768, 64).n_fc > 1
    assert not lloyd_geometry(8192, 1024).sums_smem
