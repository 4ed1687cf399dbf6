"""The port's streamed kernels (dask_ml_tpu_torch/ops/fused.py:
fused_glm_stream, fused_glm_multi_stream, fused_kmeans_block_stats) on
the CPU, where each wrapper runs its plain PyTorch version, held against
the Pallas kernels of dask_ml_tpu/ops/pallas_fused.py run with
``interpret=True``. The Pallas kernels take a block height S that is a
multiple of 128 (``stream_tile``); the port's plain versions are also run
at other heights with NaN in the rows past ``n_valid``, which they must
never read. The CUDA kernels are held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances (f32 sums of the same terms in another order): the loss rel
1e-5; the gradient 1e-4 of its largest entry, bf16 1e-3 (the residual
rounds to 8 bits, and one f32 ulp can round a row's residual apart); the
Hessian 1e-4 of its largest entry; KMeans sums and inertia 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.ops.pallas_fused import (
    fused_glm_multi_stream as pl_glm_multi_stream,
    fused_glm_stream as pl_glm_stream,
    fused_kmeans_block_stats as pl_kmeans_block_stats,
)
from dask_ml_tpu_torch.ops import fused


def _inputs(seed, S, d, family, intercept):
    rng = np.random.RandomState(seed)
    X = rng.randn(S, d).astype(np.float32)
    beta = (rng.randn(d + int(intercept)) * 0.2).astype(np.float32)
    if family == "logistic":
        y = (rng.uniform(size=S) < 0.5).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(1.0, size=S).astype(np.float32)
    else:
        y = rng.randn(S).astype(np.float32)
    return X, y, beta


def _close_rel_max(a, ref, rtol):
    """|a - ref| within rtol of ref's largest entry."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(a - ref).max() <= rtol * scale, \
        (np.abs(a - ref).max(), scale)


def _check_glm(out, ref, kind, bf16):
    np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=1e-5)
    if kind != "val":
        _close_rel_max(out[1], ref[1], 1e-3 if bf16 else 1e-4)
    if kind == "vgh":
        h = out[2].numpy()
        np.testing.assert_array_equal(h, h.T)
        _close_rel_max(h, ref[2], 1e-4)


# S = 256 with n_valid = 200: two 128-row Pallas tiles, a masked tail;
# d = 13 and 67: no multiple of anything
@pytest.mark.parametrize("kind,bf16", [("val", False), ("vg", False),
                                       ("vg", True), ("vgh", False)])
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("d", [13, 67])
def test_glm_stream_matches_pallas(kind, bf16, family, intercept, d):
    X, y, beta = _inputs(1, 256, d, family, intercept)
    ref = pl_glm_stream(kind, X, 200, y, beta, family, intercept,
                        mxu=jnp.bfloat16 if bf16 else None, interpret=True)
    out = fused.fused_glm_stream(kind, torch.from_numpy(X), 200,
                                 torch.from_numpy(y), torch.from_numpy(beta),
                                 family, intercept,
                                 mxu=torch.bfloat16 if bf16 else None)
    assert len(out) == len(ref)
    _check_glm(out, [np.asarray(r) for r in ref], kind, bf16)


@pytest.mark.parametrize("kind,bf16", [("val", False), ("vg", False),
                                       ("vg", True)])
@pytest.mark.parametrize("family", ["logistic", "normal"])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("n_classes", [3, 10])
def test_glm_multi_stream_matches_pallas(kind, bf16, family, intercept,
                                         n_classes):
    rng = np.random.RandomState(n_classes)
    S, d = 384, 21
    X = rng.randn(S, d).astype(np.float32)
    codes = rng.randint(0, n_classes, S).astype(np.float32)
    B = (rng.randn(n_classes, d + int(intercept)) * 0.2).astype(np.float32)
    mxu = jnp.bfloat16 if bf16 else None
    ref = pl_glm_multi_stream(kind, X, 300, codes, B, family, intercept,
                              mxu=mxu, interpret=True)
    out = fused.fused_glm_multi_stream(
        kind, torch.from_numpy(X), 300, torch.from_numpy(codes),
        torch.from_numpy(B), family, intercept,
        mxu=torch.bfloat16 if bf16 else None)
    assert len(out) == len(ref)
    np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=1e-5)
    if kind == "vg":
        assert out[1].shape == (n_classes, d + int(intercept))
        _close_rel_max(out[1], ref[1], 1e-3 if bf16 else 1e-4)


# k = 5 and 11, d = 13 and 30: no multiple of anything; bf16 cross term
@pytest.mark.parametrize("k,d", [(5, 13), (11, 30)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kmeans_block_stats_matches_pallas(k, d, bf16):
    rng = np.random.RandomState(k + d)
    S = 512
    centers = (rng.randn(k, d) * 4).astype(np.float32)
    X = (centers[rng.randint(0, k, S)] + rng.randn(S, d)).astype(np.float32)
    mxu = jnp.bfloat16 if bf16 else None
    sums_r, counts_r, inertia_r = (np.asarray(a) for a in
                                   pl_kmeans_block_stats(X, 450, centers,
                                                         mxu=mxu,
                                                         interpret=True))
    sums, counts, inertia = fused.fused_kmeans_block_stats(
        torch.from_numpy(X), 450, torch.from_numpy(centers),
        mxu=torch.bfloat16 if bf16 else None)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), counts_r.astype(np.int32))
    _close_rel_max(sums, sums_r, 1e-5)
    np.testing.assert_allclose(float(inertia), float(inertia_r), rtol=1e-5)


def _nan_tail(a, n_valid):
    a = a.copy()
    a[n_valid:] = np.nan
    return torch.from_numpy(a)


# S = 300 (no multiple of 128, which the Pallas kernels refuse): the plain
# versions on a block whose rows past n_valid hold NaN equal the same
# versions on the valid rows alone
@pytest.mark.parametrize("kind", ["val", "vg", "vgh"])
@pytest.mark.parametrize("intercept", [True, False])
def test_glm_stream_never_reads_the_stale_tail(kind, intercept):
    X, y, beta = _inputs(5, 300, 9, "logistic", intercept)
    out = fused.fused_glm_stream(kind, _nan_tail(X, 211), 211,
                                 _nan_tail(y, 211), torch.from_numpy(beta),
                                 "logistic", intercept)
    ref = fused.glm_stream_plain(kind, torch.from_numpy(X[:211]), 211,
                                 torch.from_numpy(y[:211]),
                                 torch.from_numpy(beta), "logistic",
                                 intercept)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["val", "vg"])
def test_glm_multi_stream_never_reads_the_stale_tail(kind):
    rng = np.random.RandomState(6)
    X = rng.randn(300, 9).astype(np.float32)
    codes = rng.randint(0, 4, 300).astype(np.float32)
    B = torch.from_numpy((rng.randn(4, 10) * 0.2).astype(np.float32))
    out = fused.fused_glm_multi_stream(kind, _nan_tail(X, 123), 123,
                                       _nan_tail(codes, 123), B, "logistic",
                                       True)
    ref = fused.glm_multi_stream_plain(kind, torch.from_numpy(X[:123]), 123,
                                       torch.from_numpy(codes[:123]), B,
                                       "logistic", True)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kmeans_block_stats_never_reads_the_stale_tail():
    rng = np.random.RandomState(7)
    X = rng.randn(300, 9).astype(np.float32)
    c = torch.from_numpy(X[:4].copy())
    out = fused.fused_kmeans_block_stats(_nan_tail(X, 250), 250, c)
    ref = fused.kmeans_block_stats_plain(torch.from_numpy(X[:250]), 250, c)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(out[1].sum()) == 250


def test_accumulators_add_blocks_in_order():
    """With ``acc`` each call adds its block's sums into the pass's
    accumulators; two blocks equal the sum of their separate sums."""
    X, y, beta = _inputs(8, 400, 7, "normal", True)
    xt, yt, bt = (torch.from_numpy(a) for a in (X, y, beta))
    for kind in fused.STREAM_KINDS:
        acc = fused.glm_stream_acc(kind, 7, True, "cpu")
        fused.fused_glm_stream(kind, xt[:250], 250, yt[:250], bt, "normal",
                               True, acc=acc)
        out = fused.fused_glm_stream(kind, xt[250:], 150, yt[250:], bt,
                                     "normal", True, acc=acc)
        a = fused.fused_glm_stream(kind, xt[:250], 250, yt[:250], bt,
                                   "normal", True)
        b = fused.fused_glm_stream(kind, xt[250:], 150, yt[250:], bt,
                                   "normal", True)
        for o, p, q in zip(out, a, b):
            torch.testing.assert_close(o, p + q, rtol=0, atol=0)
    c = xt[:3].clone()
    acc = fused.kmeans_stream_acc(3, 7, "cpu")
    fused.fused_kmeans_block_stats(xt[:250], 250, c, acc=acc)
    s, n, i = fused.fused_kmeans_block_stats(xt[250:], 150, c, acc=acc)
    assert int(n.sum()) == 400 and n.dtype == torch.int32
    ref = fused.kmeans_block_stats_plain(xt, 400, c)
    torch.testing.assert_close(s, ref[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(i, ref[2], rtol=1e-6, atol=0)


def test_refused_arguments_raise():
    x = torch.zeros((4, 3))
    for kind in ("val", "vgh"):
        with pytest.raises(ValueError, match="stays f32"):
            fused.fused_glm_stream(kind, x, 4, torch.zeros(4),
                                   torch.zeros(3), "normal", False,
                                   mxu=torch.bfloat16)
    with pytest.raises(ValueError, match="kind"):
        fused._check_stream_kind("k", "hess", None)
    with pytest.raises(ValueError, match="kind"):
        fused._check_stream_kind("k", "vgh", None, fused.MULTI_STREAM_KINDS)
    assert fused.fused_glm_stream("val", x, 4, torch.zeros(4),
                                  torch.zeros(3), "normal", False)[0] == 0


# the main path's block (d = 128, k = 64), more centers than a chunk and
# rows wider than one
@pytest.mark.parametrize("d,k,n_fc,n_cc", [(128, 64, 1, 1), (128, 256, 1, 4),
                                           (768, 64, 6, 1)])
@pytest.mark.parametrize("bf16", [False, True])
def test_lloyd_mma_geometry_sizes_the_streamed_launch(d, k, n_fc, n_cc,
                                                      bf16):
    """fused_kmeans_block_stats launches the Lloyd pass's tensor-core
    step, sized by lloyd_mma_geometry alone: its bf16 cross term rounds
    the fragments in registers, so the f32 and bf16 launches share one
    layout. Feature chunks of 128 (the sums' slices), chunks of 64
    centers, two staged tiles of 128 rows of a stride 8 mod 32 floats."""
    g = fused.lloyd_mma_geometry(d, k)
    assert (g.n_fc, g.n_cc) == (n_fc, n_cc)
    assert g.fc == min(-(-d // 8) * 8, 128) and g.stride == 136
    assert g.smem == 4 * (2 * 128 * 136 + 128 * g.fc + 1345)
    assert g.smem <= fused.LLOYD_SMEM_MAX
    # the launch's shape: one CTA per 128-row tile, at most one an SM;
    # the (k, d) partials of each
    assert fused.LLOYD_MMA_ROWS == 128 and fused.LLOYD_MMA_THREADS == 512
    # the CPU path takes the plain version with either cross term
    rng = np.random.RandomState(d + k)
    x = torch.from_numpy(rng.randn(300, d).astype(np.float32))
    c = x[:k].clone()
    mxu = torch.bfloat16 if bf16 else None
    s_, n_, i_ = fused.fused_kmeans_block_stats(x, 290, c, mxu=mxu)
    assert s_.shape == (k, d) and int(n_.sum()) == 290 and \
        n_.dtype == torch.int32 and bool(torch.isfinite(i_))
