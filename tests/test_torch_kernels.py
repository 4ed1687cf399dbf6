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
    fused_glm_multi_value_grad as pl_glm_multi_value_grad,
    fused_glm_value_grad as pl_glm_value_grad,
    fused_glm_value_grad_hess as pl_glm_value_grad_hess,
    fused_lloyd_stats as pl_lloyd_stats,
)
from dask_ml_tpu_torch.ops import fused
from dask_ml_tpu_torch.ops.fused import (
    LLOYD_SMEM_MAX, MULTI_MMA_CHUNK, MULTI_MMA_ONE_CHUNK, PARTIAL_FLOATS, VGH_MIN_SPLIT_ROWS, VGH_STEP_ROWS,
    VGH_TAIL, VGH_TILE, fused_assign_update, fused_glm_multi_value_grad,
    fused_glm_value_grad, fused_glm_value_grad_hess, fused_lloyd_stats,
    lloyd_mma_geometry, multi_mma_geometry, multi_stream_geometry,
    vgh_geometry,
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


# n=391 with n_valid=350: a masked tail and n not a multiple of 128;
# d=12 fits one 64-wide Hessian tile of the CUDA kernel, d=130 needs three
# column blocks (six tiles), the last two columns wide
@pytest.mark.parametrize("d", [12, 130])
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
def test_glm_value_grad_hess_matches_pallas(family, d):
    X, y, beta = _glm_inputs(4, 391, d, family)
    v_ref, g_ref, h_ref = (np.asarray(a) for a in pl_glm_value_grad_hess(
        X, 350, y, beta, family=family, interpret=True))
    v, g, h = fused_glm_value_grad_hess(torch.from_numpy(X), 350,
                                        torch.from_numpy(y),
                                        torch.from_numpy(beta), family)
    # the same f32 terms summed in another order: 1e-5 on the loss, 1e-4
    # on the gradient and on the Hessian, whose entries are sums of 350
    # weighted products (the tolerances of tests/test_pallas_glm.py)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(h.numpy(), h.numpy().T)


def _multi_inputs(seed, n, d, n_classes):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    B = (rng.randn(n_classes, d) * 0.2).astype(np.float32)
    codes = rng.randint(0, n_classes, size=n)
    return X, codes, B


@pytest.mark.parametrize("n_classes", [3, 7])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("family", ["logistic", "normal"])
def test_glm_multi_value_grad_matches_pallas(n_classes, bf16, family):
    import jax.numpy as jnp

    X, codes, B = _multi_inputs(5, 391, 13, n_classes)
    xj = jnp.asarray(X, jnp.bfloat16) if bf16 else X
    v_ref, g_ref = pl_glm_multi_value_grad(
        xj, 350, codes.astype(np.float32), B, family=family, interpret=True)
    xt = torch.from_numpy(X)
    if bf16:
        xt = xt.to(torch.bfloat16)
    v, g = fused_glm_multi_value_grad(xt, 350, torch.from_numpy(codes),
                                      torch.from_numpy(B), family)
    assert g.shape == (n_classes, 13)
    # f32: the same terms in another order (1e-5 on the loss, 1e-4 on the
    # gradient); bf16: the residual rounds to 8 bits in both, and a
    # residual one f32 ulp apart can round to neighbouring bf16 values
    # (1e-3, as for the single-target kernel)
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
    h = fused_glm_value_grad_hess(*args)
    h0 = fused.glm_value_grad_hess_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(h, h0))
    codes = torch.from_numpy(np.arange(64) % 3)
    B = torch.from_numpy(np.tile(beta, (3, 1)))
    m = fused_glm_multi_value_grad(args[0], 60, codes, B, "logistic")
    m0 = fused.glm_multi_value_grad_plain(args[0], 60, codes, B, "logistic")
    assert all(torch.equal(a, b) for a, b in zip(m, m0))
    c = torch.from_numpy(X[:3])
    fused_lloyd_stats(torch.from_numpy(X), 60, c)
    fused_assign_update(torch.from_numpy(X), torch.ones(64), c)
    assert fused.launches() == {name: 0 for name in fused.KERNELS}


def test_lloyd_mma_geometry_is_a_rule():
    """The tensor-core Lloyd pass (fused_lloyd_stats, fused_assign_update)
    cuts (d, k) by a rule too, and every (d, k) has a cut. The main
    path's shape keeps a whole row per step and the centers resident;
    wider rows take feature chunks of 128 (the sums' slices), more
    centers chunks of 64; a staged row has room for a 16-byte shift and
    a stride of 8 mod 32 floats."""
    main = lloyd_mma_geometry(128, 64)
    assert (main.fc, main.n_fc, main.n_cc) == (128, 1, 1)
    assert main.stride == 136 and main.smem <= LLOYD_SMEM_MAX
    assert lloyd_mma_geometry(128, 64) == main
    for d, k in [(1, 1), (3, 2), (7, 3), (128, 256), (150, 64), (300, 64),
                 (768, 64), (1001, 70), (8192, 1024), (20000, 8)]:
        g = lloyd_mma_geometry(d, k)
        assert g.smem <= LLOYD_SMEM_MAX
        assert g.fc % 8 == 0 and g.n_fc * g.fc >= d > (g.n_fc - 1) * g.fc
        assert g.n_cc * 64 >= k > (g.n_cc - 1) * 64
        assert g.stride >= g.fc + 8 and g.stride % 32 == 8
        # rows cut into chunks take chunks of the sums' 128-feature slices
        assert g.n_fc == 1 or g.fc == 128
        # two staged tiles of 128 rows, the split (fc, 64) centers, the
        # per-row labels and second-half best, the per-thread inertia,
        # the counting sort's per-warp counts, first slots and order
        assert g.smem == 4 * (2 * 128 * g.stride + 128 * g.fc + 1345)
    assert lloyd_mma_geometry(128, 256).n_cc == 4
    assert lloyd_mma_geometry(768, 64).n_fc > 1


def test_multi_stream_geometry_is_a_rule():
    """The streamed one-vs-rest kernel cuts a row as kernel 4 does; with
    bf16 products it stages f32 rows of kernel 4's bf16 chunk (a k-step
    of 16) and rounds them into rows of kernel 4's bf16 stride."""
    for d in [1, 13, 21, 256, 257, 264, 265, 4097]:
        f = multi_stream_geometry(d)
        assert f[:3] == multi_mma_geometry(d, 4) and f.round_stride == 0
        b = multi_stream_geometry(d, bf16_ops=True)
        g2 = multi_mma_geometry(d, 2)
        assert (b.fch, b.n_fc, b.round_stride) == g2
        assert b.stride >= b.fch + 8 and b.stride % 32 == 8
    assert multi_stream_geometry(256)[:4] == (256, 1, 264, 0)
    assert multi_stream_geometry(256, bf16_ops=True)[:4] == \
        (256, 1, 264, 264)


def test_glm_kernel_geometries_are_rules():
    """The Newton and one-vs-rest kernels cut their work by rules on the
    shapes, and every shape has a cut: none is refused. The Hessian's
    upper triangle is tiled in 128 x 128 blocks (a rest of d at most 16
    wide folded into the diagonal tiles, a wider one a block of its
    own), over row splits that cover every valid row; past the
    partials' budget a single split writes the output directly. The
    one-vs-rest kernel stages whole rows up to 264 features, wider ones
    in chunks of 256, with a bank-conflict-free stride; the streamed
    one-vs-rest and SGD kernels' rule fits one CTA's shared memory at
    every width."""
    for n_valid, d in [(0, 1), (5, 1), (350, 12), (4_000_000, 257),
                       (262_144, 256), (200_000, 2049), (10 ** 6, 20_000)]:
        g = vgh_geometry(n_valid, d, 264)
        assert g == vgh_geometry(n_valid, d, 264)
        # full blocks, the last maybe narrow, and a tail of at most
        # VGH_TAIL columns folded into the diagonal tiles
        assert g.nb * VGH_TILE + VGH_TAIL >= d > (g.nb - 1) * VGH_TILE
        assert d <= g.nb * VGH_TILE or (d > VGH_TILE and
                                        d - g.nb * VGH_TILE <= VGH_TAIL)
        assert g.n_tiles == g.nb * (g.nb + 1) // 2
        assert g.rows_per_split % VGH_STEP_ROWS == 0
        assert g.n_split * g.rows_per_split >= n_valid
        assert (g.n_split - 1) * g.rows_per_split < max(n_valid, 1)
        assert g.n_split == 1 or \
            g.n_split * g.n_tiles * VGH_TILE ** 2 <= PARTIAL_FLOATS
        assert g.n_split == 1 or \
            g.rows_per_split >= VGH_MIN_SPLIT_ROWS - VGH_STEP_ROWS
    # d = 257: two full blocks and a one-column tail in their diagonal
    # tiles; d = 300: two full blocks and a 44-column block
    assert vgh_geometry(4_000_000, 257, 264)[:2] == (2, 3)
    assert vgh_geometry(4_000_000, 257, 264).n_split > 1
    assert vgh_geometry(262_144, 256, 264)[:2] == (2, 3)
    assert vgh_geometry(10_000, 300, 264)[:2] == (3, 6)
    assert vgh_geometry(10_000, 13, 264)[:2] == (1, 1)
    assert vgh_geometry(10 ** 6, 20_000, 264).n_split == 1
    # one-vs-rest: the main shape stages whole rows; bf16 rows round to 16
    # features, f32 to 8 with a stride of 8 mod 32 floats
    assert multi_mma_geometry(257) == (264, 1, 296)
    assert multi_mma_geometry(257, 2) == (272, 1, 280)
    assert multi_mma_geometry(4097) == (256, 17, 264)
    assert multi_mma_geometry(4097, 2) == (256, 17, 264)
    for d in [1, 13, 257, 264, 265, 2000, 4097, 10_000, 30_000]:
        for itemsize in (2, 4):
            g = multi_mma_geometry(d, itemsize)
            assert g == multi_mma_geometry(d, itemsize)
            step = 8 if itemsize == 4 else 16
            assert g.fch % step == 0 and g.n_fc * g.fch >= d
            assert (g.n_fc == 1) == (d <= MULTI_MMA_ONE_CHUNK)
            assert g.n_fc == 1 or (g.n_fc - 1) * g.fch < d
            assert g.n_fc == 1 or g.fch == MULTI_MMA_CHUNK
            # room for a row shifted by up to 16 bytes, and the stride
            # of a conflict-free gather (8 mod 32 floats, 8 mod 16 halfs)
            assert g.stride * itemsize >= g.fch * itemsize + 16
            assert g.stride % (32 if itemsize == 4 else 16) == 8
    # the streamed kernels: whole rows at the main width; the bf16
    # products drop the split weight rows and add the rounded tile
    assert multi_stream_geometry(257)[:2] == (264, 1)
    assert multi_stream_geometry(257, bf16_ops=True).smem < \
        multi_stream_geometry(257).smem
    for d in [1, 257, 2000, 4097, 10_000, 30_000]:
        for bf16 in (False, True):
            g = multi_stream_geometry(d, bf16)
            assert 0 < g.smem <= LLOYD_SMEM_MAX
            assert g.fch % (16 if bf16 else 8) == 0 and g.fch <= 272


def test_fused_has_no_cuda_core_geometry():
    """Every kernel runs a tensor-core step: ops/fused.py keeps no
    geometry of the CUDA-core templates (glm_multi_partials, kernel 8's
    old step; lloyd_partials, kernel 9's) and csrc/ no such template;
    kernels 8 and 9 launch the walks of kernels 4 and 7 and of the Lloyd
    pass."""
    import os

    from dask_ml_tpu_torch.ops import _build

    for name in ("glm_multi_geometry", "MultiGeometry", "MULTI_TILE",
                 "MULTI_MAX_CHUNK", "lloyd_geometry", "LloydGeometry",
                 "LLOYD_THREADS", "LLOYD_TILE", "LLOYD_FEATURE_CHUNKS"):
        assert not hasattr(fused, name), name
    sources = {f: open(os.path.join(_build.CSRC_DIR, f)).read()
               for f in os.listdir(_build.CSRC_DIR)}
    for src in sources.values():
        assert "glm_multi_partials" not in src
        assert "lloyd_partials" not in src
    multi = sources["glm_multi_value_grad.cu"]
    sgd = multi[multi.index('extern "C" int sgd_many_block_grad'):]
    assert "launch_mma<" in sgd
    lloyd = sources["lloyd.cu"]
    stats = lloyd[lloyd.index('extern "C" int kmeans_block_stats'):]
    assert "launch_pass(" in stats
    # the step, the centers' split and the reduce
    assert lloyd.count("__global__") == 3
