"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a
CUDA device (decided inside the fixture, never at import). On a machine
with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The tolerances are chip_smoke.py's (check_glm, check_lloyd), at shapes
small enough for a test; chip_smoke.py holds the same kernels to the
same rules at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# d reaches every walk of the kernel (ops/fused.py::glm_value_walk): f32
# d = 13 and 1 the narrow walk; 257, 600, 1365 and 3000 the registers
# walk (2, 4, 8 and 16 columns a thread; 1360 with fewer rows than a
# block); 6000 and 8193 the staged walk's wide rows; bf16 X the staged walk
@pytest.mark.parametrize("n,d,n_valid", [(391, 13, 350), (20000, 257, 19999),
                                         (5, 1, 5), (64, 1360, 10),
                                         (1000, 600, 999),
                                         (3000, 1365, 2999),
                                         (1000, 3000, 997),
                                         (700, 6000, 700),
                                         (2000, 8193, 1990)])
def test_glm_kernel_matches_plain(dev, family, dtype, n, d, n_valid):
    from chip_smoke import check_glm, same_bits
    from dask_ml_tpu_torch.ops import fused

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / 8
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    if family == "poisson":
        y = torch.poisson(torch.ones(n, device=dev), generator=g)
    args = (x, n_valid, y, beta, family)
    before = fused.fused_glm_value_grad.launches
    k1 = fused.fused_glm_value_grad(*args)
    k2 = fused.fused_glm_value_grad(*args)
    torch.cuda.synchronize()
    assert fused.fused_glm_value_grad.launches == before + 2
    assert same_bits(k1, k2)
    check_glm(k1, fused.glm_value_grad_plain(*args), dtype)


# the shapes reach every geometry of the kernel (ops/fused.py::
# lloyd_mma_geometry): a whole row per step with resident centers; rows
# that start off a 16-byte boundary (d % 4); more than one 64-center chunk
# (k=200, k=256); rows cut into 128-feature chunks (d=150, 256, 300, 768,
# 1001, 2048 with k=300)
@pytest.mark.parametrize("n,d,k,n_valid", [(256, 8, 4, 256),
                                           (137, 7, 3, 130),
                                           (100_000, 128, 64, 99_990),
                                           (5000, 33, 17, 4999),
                                           (20_000, 150, 64, 19_999),
                                           (20_000, 256, 64, 20_000),
                                           (20_000, 64, 200, 19_990),
                                           (20_000, 128, 256, 19_999),
                                           (20_000, 300, 64, 19_993),
                                           (20_000, 768, 64, 20_000),
                                           (5000, 1001, 70, 4997),
                                           (3000, 2048, 300, 2999)])
def test_lloyd_kernels_match_plain(dev, n, d, k, n_valid):
    from chip_smoke import check_lloyd, same_bits
    from dask_ml_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.randn((n, d), generator=g, device=dev)
    c = torch.randn((k, d), generator=g, device=dev)
    mask = (torch.arange(n, device=dev) < n_valid).float()
    a1 = fused.fused_assign_update(x, mask, c)
    a2 = fused.fused_assign_update(x, mask, c)
    s1 = fused.fused_lloyd_stats(x, n_valid, c)
    torch.cuda.synchronize()
    assert same_bits(a1, a2)
    assert same_bits(s1, a1[2:])
    plain = fused.assign_update_plain(x, mask, c)
    xv = x[:n_valid]
    lab, mind, sums, counts, inertia = a1
    check_lloyd(xv, c, lab[:n_valid], mind[:n_valid], sums, counts, inertia,
                tuple(p[:n_valid] if i < 2 else p
                      for i, p in enumerate(plain)))
    assert torch.equal(mind[n_valid:], torch.zeros_like(mind[n_valid:]))


# SpectralClustering's assignment KMeans runs on its (n, n_clusters)
# embedding: d = 8 (whole 32-byte rows) and d = 10 (40-byte rows, every
# other one off a 16-byte boundary), and d = 10 on a row view whose first
# row starts off a 16-byte boundary
@pytest.mark.parametrize("n,d,k,offset", [(200_000, 8, 8, 0),
                                          (200_000, 10, 10, 0),
                                          (200_000, 10, 10, 1)])
def test_lloyd_kernels_at_the_embedding_width(dev, n, d, k, offset):
    from chip_smoke import check_lloyd, same_bits
    from dask_ml_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(d + offset)
    x = torch.randn((n + offset, d), generator=g, device=dev)[offset:]
    x = x / x.norm(dim=1, keepdim=True)
    c = x[torch.randperm(n, generator=g, device=dev)[:k]].clone()
    ones = torch.ones(n, device=dev)
    a1 = fused.fused_assign_update(x, ones, c)
    a2 = fused.fused_assign_update(x, ones, c)
    s1 = fused.fused_lloyd_stats(x, n, c)
    s2 = fused.fused_lloyd_stats(x, n, c)
    torch.cuda.synchronize()
    assert same_bits(a1, a2) and same_bits(s1, s2)
    assert same_bits(s1, a1[2:])
    check_lloyd(x, c, *a1, fused.assign_update_plain(x, ones, c))


def test_spectral_fit_goes_through_the_lloyd_kernels(dev):
    from dask_ml_tpu_torch import datasets
    from dask_ml_tpu_torch.cluster import SpectralClustering
    from dask_ml_tpu_torch.ops import fused

    X, truth = datasets.make_blobs(20_000, 16, centers=8, random_state=0)
    fused.reset_launches()
    sc = SpectralClustering(n_clusters=8, random_state=0, gamma=1 / 32,
                            n_init=2).fit(X)
    counts = fused.launches()
    assert counts["fused_lloyd_stats"] >= 2
    assert counts["fused_assign_update"] == 2
    labels = sc.labels_.to_numpy()
    table = np.zeros((8, 8), int)
    np.add.at(table, (labels, truth.to_numpy().astype(int)), 1)
    assert (table.max(1).sum() == 20_000) and (table > 0).sum() == 8


# d reaches one tile (1, 13, 64), two full 128-wide blocks (256), a tail
# folded into the diagonal tiles (257: the main path's width, one column;
# 144: sixteen; 2049, past the Pallas kernel's VMEM gate: one), a rest
# too wide to fold (145: 17 columns; 1000: 104) and rows that start off
# a 16-byte boundary (d % 4 != 0); n_valid < n masks a tail that is not a
# multiple of the 32-row stage; n = 5, 40 and 391 give a single split,
# whose tiles write the output directly, the others several splits
# reduced in order; n_valid = 0 gives zeros
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("n,d,n_valid", [(5, 1, 5), (40, 13, 37),
                                         (391, 64, 350),
                                         (20000, 257, 19999),
                                         (20000, 256, 19_990),
                                         (70_000, 257, 69_997),
                                         (3000, 144, 2999),
                                         (3000, 145, 2990),
                                         (391, 144, 390),
                                         (3000, 1000, 2990),
                                         (700, 2049, 700),
                                         (300, 257, 0)])
def test_newton_kernel_matches_plain(dev, family, n, d, n_valid):
    from chip_smoke import check_vgh, same_bits
    from dask_ml_tpu_torch.ops import fused

    g = torch.Generator(device=dev).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=dev)
    beta = torch.randn(d, generator=g, device=dev) / (4 * d ** 0.5)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    if family == "poisson":
        y = torch.poisson(torch.ones(n, device=dev), generator=g)
    args = (x, n_valid, y, beta, family)
    before = fused.fused_glm_value_grad_hess.launches
    k1 = fused.fused_glm_value_grad_hess(*args)
    k2 = fused.fused_glm_value_grad_hess(*args)
    torch.cuda.synchronize()
    assert fused.fused_glm_value_grad_hess.launches == before + 2
    assert same_bits(k1, k2)
    check_vgh(k1, fused.glm_value_grad_hess_plain(
        x.double(), n_valid, y.double(), beta.double(), family))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# C = 2 and 3 (one n8 tile of classes), 10 (the main path, padded to 16),
# 16 (one full group), 17 (two groups), 20, 40 and 300 (19 groups); both
# walks of csrc/glm_multi_value_grad.cu: rows in one staged chunk (d <=
# 264, ops/fused.py::multi_mma_geometry), and rows in chunks of 256
# features (d = 265, 1000, 2000, 4097, 30000) whose residual tiles are
# parked between the eta and gradient walks; 20,000 rows give CTAs
# several tiles, so the ring runs on across tiles, chunks and groups;
# d = 257, 265 and 4097 leave rows unaligned to 16 bytes (copied from
# their aligned start); n_valid is not a multiple of the 64-row tile, and
# 0 gives zeros; n = 5 and 391 give ragged single tiles
@pytest.mark.parametrize("n,d,c,n_valid", [(5, 1, 2, 5), (391, 13, 3, 350),
                                           (400, 13, 17, 399),
                                           (20000, 257, 10, 19999),
                                           (20000, 256, 10, 19_950),
                                           (3000, 257, 16, 2999),
                                           (3000, 257, 17, 2990),
                                           (2000, 257, 300, 1999),
                                           (20000, 257, 40, 19_990),
                                           (20000, 1000, 20, 19_999),
                                           (20000, 265, 10, 19_937),
                                           (1000, 264, 3, 999),
                                           (1000, 265, 10, 937),
                                           (3000, 2000, 5, 2999),
                                           (2000, 4097, 10, 1993),
                                           (500, 4097, 2, 500),
                                           (200, 30000, 2, 199),
                                           (300, 257, 10, 0)])
def test_multi_kernel_matches_plain(dev, dtype, n, d, c, n_valid):
    from chip_smoke import check_glm, same_bits
    from dask_ml_tpu_torch.ops import fused

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(n + c)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    codes = torch.randint(0, c, (n,), generator=g, device=dev)
    B = torch.randn((c, d), generator=g, device=dev) / (4 * d ** 0.5)
    args = (x, n_valid, codes, B, "logistic")
    before = fused.fused_glm_multi_value_grad.launches
    k1 = fused.fused_glm_multi_value_grad(*args)
    k2 = fused.fused_glm_multi_value_grad(*args)
    torch.cuda.synchronize()
    assert fused.fused_glm_multi_value_grad.launches == before + 2
    assert same_bits(k1, k2)
    check_glm(k1, fused.glm_multi_value_grad_plain(*args), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_kernel_takes_an_unaligned_view(dev, dtype):
    """A view of X that starts off a 16-byte boundary gives the same sums
    as a fresh copy of it (the kernel stages rows from an aligned base)."""
    from chip_smoke import same_bits
    from dask_ml_tpu_torch.ops import fused

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((3001, 257), generator=g, device=dev).to(dtype)[1:]
    assert x.data_ptr() % 16
    codes = torch.randint(0, 10, (3000,), generator=g, device=dev)
    B = torch.randn((10, 257), generator=g, device=dev) / 64
    view = fused.fused_glm_multi_value_grad(x, 2999, codes, B, "logistic")
    fresh = fused.fused_glm_multi_value_grad(x.clone(), 2999, codes, B,
                                             "logistic")
    torch.cuda.synchronize()
    assert same_bits(view, fresh)


def test_refused_shape_raises(dev):
    """Only inputs no kernel is meant for are refused, and on the card
    that is an error, never the plain version."""
    from dask_ml_tpu_torch.ops import fused

    x = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        fused.fused_glm_value_grad(x, 4, torch.zeros(4, device=dev),
                                   torch.zeros(3, device=dev), "gamma")
    with pytest.raises(ValueError, match="no kernel"):
        fused.fused_glm_value_grad(x.double(), 4, torch.zeros(4, device=dev),
                                   torch.zeros(3, device=dev), "logistic")
    # the Newton and ADMM fits keep an f32 design: bf16 is not for it
    with pytest.raises(ValueError, match="no kernel"):
        fused.fused_glm_value_grad_hess(x.to(torch.bfloat16), 4,
                                        torch.zeros(4, device=dev),
                                        torch.zeros(3, device=dev),
                                        "logistic")
    with pytest.raises(ValueError, match="no kernel"):
        fused.fused_glm_multi_value_grad(x, 4, torch.zeros(4, device=dev),
                                         torch.zeros((2, 3), device=dev),
                                         "gamma")


def test_fits_go_through_the_kernels(dev):
    """Both estimators on the card launch their kernels, and agree with
    the same fit on the CPU (the plain versions) to 5e-4 / 1e-3."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    rng = np.random.RandomState(0)
    X = rng.randn(20000, 16).astype(np.float32)
    y = (rng.uniform(size=20000)
         < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))).astype(np.float32)
    fused.reset_launches()
    gpu = LogisticRegression(solver="lbfgs", max_iter=30, tol=1e-8).fit(X, y)
    km = KMeans(n_clusters=5, init=X[:5], max_iter=20).fit(X)
    counts = fused.launches()
    assert counts["fused_glm_value_grad"] >= gpu.n_iter_ > 0
    assert counts["fused_lloyd_stats"] == km.n_iter_
    assert counts["fused_assign_update"] == 1
    with config.set(device="cpu"):
        cpu = LogisticRegression(solver="lbfgs", max_iter=30,
                                 tol=1e-8).fit(X, y)
        kc = KMeans(n_clusters=5, init=X[:5], max_iter=20).fit(X)
    np.testing.assert_allclose(gpu.coef_, cpu.coef_, atol=5e-4)
    np.testing.assert_allclose(km.cluster_centers_, kc.cluster_centers_,
                               atol=1e-3)
    assert km.n_iter_ == kc.n_iter_


def test_newton_and_ovr_fits_go_through_the_kernels(dev):
    """Newton launches its kernel once per iteration, the one-vs-rest
    L-BFGS its kernel at least once per iteration, and both fits agree
    with the same fits on the CPU (the plain versions) to 5e-4."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    rng = np.random.RandomState(1)
    X = rng.randn(20000, 16).astype(np.float32)
    y = (rng.uniform(size=20000)
         < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))).astype(np.float32)
    y4 = np.argmax(X[:, :4] + rng.randn(20000, 4), 1).astype(np.float32)
    fused.reset_launches()
    nt = LogisticRegression(solver="newton", tol=1e-4).fit(X, y)
    counts = fused.launches()
    assert counts["fused_glm_value_grad_hess"] == nt.n_iter_ > 0
    fused.reset_launches()
    ov = LogisticRegression(solver="lbfgs", max_iter=30, tol=1e-6).fit(X, y4)
    assert fused.launches()["fused_glm_multi_value_grad"] >= ov.n_iter_ > 0
    ad = LogisticRegression(max_iter=30).fit(X, y4)
    with config.set(device="cpu"):
        nc = LogisticRegression(solver="newton", tol=1e-4).fit(X, y)
        oc = LogisticRegression(solver="lbfgs", max_iter=30,
                                tol=1e-6).fit(X, y4)
        ac = LogisticRegression(max_iter=30).fit(X, y4)
    np.testing.assert_allclose(nt.coef_, nc.coef_, atol=5e-4)
    np.testing.assert_allclose(ov.coef_, oc.coef_, atol=5e-4)
    np.testing.assert_allclose(ad.coef_, ac.coef_, atol=5e-4)


# The streamed kernels at block heights that are and are not multiples of
# anything; every kind; intercept on and off; f32 and bf16 operands; rows
# past n_valid NaN (never read). d = 13 takes the narrow walk of
# csrc/glm_value_grad.cu, 257 the registers walk, 9000 the staged walk;
# the vgh cases cover a single split (n = 40) and several, the Hessian's
# two full blocks (d = 256), a folded one-column tail (257), a folded
# 16-column tail with a single split (144) and a 104-wide last block
# (1000), and a block of count 0 (its sums are zero).
# (the (d, d) Hessian is not taken at d = 9000)
_GLM_STREAM_CASES = [
    (kind, bf16, n, d, n_valid)
    for kind, bf16 in [("val", False), ("vg", False), ("vg", True),
                       ("vgh", False)]
    for n, d, n_valid in [(40, 13, 37), (20000, 257, 19999),
                          (3000, 256, 2000), (600, 9000, 599),
                          (300, 144, 299), (2000, 1000, 1999), (300, 257, 0)]
    if not (kind == "vgh" and d > 1000)
    and (kind == "vgh" or n_valid > 0)]


@pytest.mark.parametrize("kind,bf16,n,d,n_valid", _GLM_STREAM_CASES)
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("intercept", [True, False])
def test_glm_stream_kernel_matches_plain(dev, kind, bf16, family, intercept,
                                         n, d, n_valid):
    from chip_smoke import check_glm_stream, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=dev)
    x[n_valid:] = torch.nan
    beta = torch.randn(d + int(intercept), generator=g, device=dev) / (
        4 * d ** 0.5)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    if family == "poisson":
        y = torch.poisson(torch.ones(n, device=dev), generator=g)
    args = (kind, x, n_valid, y, beta, family, intercept)
    before = fused.fused_glm_stream.launches
    k1 = tuple(t.clone() for t in fused.fused_glm_stream(*args, mxu=mxu))
    acc = fused.glm_stream_acc(kind, d, intercept, dev)
    fused.fused_glm_stream(*args, mxu=mxu, acc=acc)
    k2 = fused.fused_glm_stream(*args, mxu=mxu, acc=acc)
    torch.cuda.synchronize()
    assert fused.fused_glm_stream.launches == before + 3
    assert all(bool(torch.isfinite(t).all()) for t in k1)
    # the second call added the same sums into the accumulator
    assert same_bits(tuple(2 * t for t in k1), k2)
    xv, yv = x[:n_valid], y[:n_valid]
    ref = fused.glm_stream_plain(kind, xv.double() if kind == "vgh" else xv,
                                 n_valid, yv.double() if kind == "vgh"
                                 else yv, beta.double() if kind == "vgh"
                                 else beta, family, intercept, mxu=mxu)
    check_glm_stream(kind, k1, ref, mxu)


# the tensor-core walks of kernel 4: whole rows (d <= 264) and chunks of
# 256 with the residual scratch (d = 300, 2000), one group of 16 classes
# and two (C = 17, 20), a ragged last tile, and a block of count 0
@pytest.mark.parametrize("kind,bf16", [("val", False), ("vg", False),
                                       ("vg", True)])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("n,d,c,n_valid", [(391, 13, 3, 350),
                                           (20000, 256, 10, 19999),
                                           (3000, 257, 17, 2990),
                                           (2000, 2000, 5, 1999),
                                           (600, 300, 20, 597),
                                           (300, 21, 3, 0)])
def test_multi_stream_kernel_matches_plain(dev, kind, bf16, intercept, n, d,
                                           c, n_valid):
    from chip_smoke import check_glm_stream, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + c)
    x = torch.randn((n, d), generator=g, device=dev)
    x[n_valid:] = torch.nan
    codes = torch.randint(0, c, (n,), generator=g, device=dev).float()
    codes[n_valid:] = torch.nan
    B = torch.randn((c, d + int(intercept)), generator=g, device=dev) / (
        4 * d ** 0.5)
    args = (kind, x, n_valid, codes, B, "logistic", intercept)
    before = fused.fused_glm_multi_stream.launches
    k1 = tuple(t.clone() for t in fused.fused_glm_multi_stream(*args,
                                                               mxu=mxu))
    k2 = fused.fused_glm_multi_stream(*args, mxu=mxu)
    torch.cuda.synchronize()
    assert fused.fused_glm_multi_stream.launches == before + 2
    assert same_bits(k1, k2)
    assert all(bool(torch.isfinite(t).all()) for t in k1)
    check_glm_stream(kind, k1, fused.glm_multi_stream_plain(
        kind, x[:n_valid], n_valid, codes[:n_valid], B, "logistic",
        intercept, mxu=mxu), mxu)


# the Lloyd pass's step over a block's rows < n_valid (NaN past them):
# the main path's d = 128, k = 64; off it k = 256 and d = 768, whose sums
# take several slices; a ragged count of 1, and of 0 (zeros added)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,d,k,n_valid", [(137, 7, 3, 130),
                                           (100_000, 128, 64, 99_990),
                                           (20_000, 64, 200, 19_990),
                                           (20_000, 300, 64, 19_993),
                                           (5000, 1001, 70, 4997),
                                           (30_000, 128, 256, 29_999),
                                           (30_000, 768, 64, 29_871),
                                           (300, 13, 5, 1), (300, 13, 5, 0)])
def test_kmeans_block_stats_matches_plain(dev, bf16, n, d, k, n_valid):
    from chip_smoke import check_block_stats, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.randn((n, d), generator=g, device=dev)
    c = torch.randn((k, d), generator=g, device=dev)
    x_nan = x.clone()
    x_nan[n_valid:] = torch.nan
    before = fused.fused_kmeans_block_stats.launches
    k1 = tuple(t.clone() for t in fused.fused_kmeans_block_stats(
        x_nan, n_valid, c, mxu=mxu))
    acc = fused.kmeans_stream_acc(k, d, dev)
    fused.fused_kmeans_block_stats(x_nan, n_valid, c, mxu=mxu, acc=acc)
    k2 = fused.fused_kmeans_block_stats(x_nan, n_valid, c, mxu=mxu, acc=acc)
    torch.cuda.synchronize()
    assert fused.fused_kmeans_block_stats.launches == before + 3
    assert same_bits((2 * k1[0], 2 * k1[1], 2 * k1[2]), k2)
    check_block_stats(x, n_valid, c, mxu, k1,
                      fused.kmeans_block_stats_plain(x, n_valid, c, mxu))


def test_streamed_fits_go_through_the_kernels(dev, tmp_path):
    """Memmap fits on the card launch one streamed kernel per block per
    pass and agree with the same fits on the CPU."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    rng = np.random.RandomState(2)
    X = rng.randn(20000, 16).astype(np.float32)
    y = (rng.uniform(size=20000)
         < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))).astype(np.float32)
    y3 = np.argmax(X[:, :3] + rng.randn(20000, 3), 1).astype(np.float32)
    mm = np.memmap(str(tmp_path / "X.f32"), dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X
    fits = {}
    for where in ("cuda", "cpu"):
        with config.set(device=where, stream_block_rows=6000):
            fused.reset_launches()
            fits[where] = (
                LogisticRegression(solver="lbfgs", tol=1e-3).fit(mm, y),
                LogisticRegression(solver="newton", tol=1e-4).fit(mm, y),
                LogisticRegression(solver="lbfgs", tol=1e-3).fit(mm, y3),
                KMeans(n_clusters=4, init=X[:4], max_iter=10).fit(mm))
            counts = fused.launches()
        if where == "cuda":
            lb, nt, ov, km = fits["cuda"]
            passes = lb.solver_info_["data_passes"] + \
                nt.solver_info_["data_passes"]
            assert counts["fused_glm_stream"] == 4 * passes
            assert counts["fused_glm_multi_stream"] == \
                4 * ov.solver_info_["data_passes"]
            assert counts["fused_kmeans_block_stats"] == 4 * km.n_iter_
            assert counts["fused_assign_update"] == 4
    for a, b in zip(fits["cuda"][:3], fits["cpu"][:3]):
        np.testing.assert_allclose(a.coef_, b.coef_, atol=5e-4)
    np.testing.assert_allclose(fits["cuda"][3].cluster_centers_,
                               fits["cpu"][3].cluster_centers_, atol=1e-3)


# d = 13 and 128 take the narrow walk of csrc/glm_value_grad.cu, 257 and
# 1365 the registers walk (2 and 8 columns a thread), 9000 the staged
# walk; rows past n_valid are NaN (never read); n_valid = 0
# gives zeros
@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,d,n_valid", [(40, 13, 37), (20000, 128, 19999),
                                         (3000, 257, 2000), (1000, 1365, 999),
                                         (600, 9000, 599), (300, 64, 0)])
def test_sgd_block_kernel_matches_plain(dev, loss, bf16, n, d, n_valid):
    from chip_smoke import check_sgd, hinge_slack, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=dev)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    x[n_valid:] = torch.nan
    y[n_valid:] = torch.nan
    w = torch.randn(d + 1, generator=g, device=dev) / (4 * d ** 0.5)
    before = fused.fused_sgd_block_grad.launches
    k1 = tuple(t.clone() for t in fused.fused_sgd_block_grad(
        x, n_valid, y, w, 1.0, loss, mxu))
    k2 = fused.fused_sgd_block_grad(x, n_valid, y, w, 1.0, loss, mxu)
    k3 = fused.fused_sgd_block_grad(x, n_valid, y, w, 0.0, loss, mxu)
    torch.cuda.synchronize()
    assert fused.fused_sgd_block_grad.launches == before + 3
    assert same_bits(k1, k2)
    assert all(bool(torch.isfinite(t).all()) for t in k1 + k3)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for out, iflag in ((k1, 1.0), (k3, 0.0)):
        slack = hinge_slack(x, n_valid, y, w, iflag, False, mxu)[0] \
            if loss == "hinge" else 0.0
        check_sgd(out, fused.sgd_block_grad_plain(
            x[:n_valid], n_valid, y[:n_valid], w, iflag, loss, mxu), dtype,
            slack)


# N = 3 and 10 (one group of 16 rows), 17 (two groups), 128 (eight);
# d = 13, 128 and 256 stage a row in one chunk, d = 2000 in four
@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error"])
@pytest.mark.parametrize("codes", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,d,N,n_valid", [(391, 13, 3, 350),
                                           (20000, 256, 10, 19999),
                                           (3000, 128, 17, 2990),
                                           (5000, 128, 128, 4999),
                                           (2000, 2000, 5, 1999),
                                           (300, 64, 4, 0)])
def test_sgd_many_kernel_matches_plain(dev, loss, codes, bf16, n, d, N,
                                       n_valid):
    from chip_smoke import check_sgd, hinge_slack, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + N)
    x = torch.randn((n, d), generator=g, device=dev)
    y = torch.randint(0, N, (n,), generator=g, device=dev).float() if codes \
        else (torch.rand(n, generator=g, device=dev) < 0.5).float()
    x[n_valid:] = torch.nan
    y[n_valid:] = torch.nan
    W = torch.randn((N, d + 1), generator=g, device=dev) / (4 * d ** 0.5)
    iflags = 1.0 if codes else (torch.arange(N, device=dev) % 2).float()
    args = (x, n_valid, y, W, iflags, loss, codes, mxu)
    before = fused.fused_sgd_many_block_grad.launches
    k1 = tuple(t.clone() for t in fused.fused_sgd_many_block_grad(*args))
    k2 = fused.fused_sgd_many_block_grad(*args)
    torch.cuda.synchronize()
    assert fused.fused_sgd_many_block_grad.launches == before + 2
    assert same_bits(k1, k2)
    assert all(bool(torch.isfinite(t).all()) for t in k1)
    slack = hinge_slack(x, n_valid, y, W, iflags, codes, mxu)[0] \
        if loss == "hinge" else 0.0
    check_sgd(k1, fused.sgd_many_block_grad_plain(
        x[:n_valid], n_valid, y[:n_valid], W, iflags, loss, codes, mxu),
        torch.bfloat16 if bf16 else torch.float32, slack)


def test_sgd_fits_go_through_the_kernels(dev, tmp_path):
    """The SGD paths on the card launch one step kernel per block per
    epoch and agree with the same fits on the CPU: host data, a memmap,
    device data, multiclass, Incremental and the batched-trial step."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier, SGDRegressor
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import ShardedArray
    from dask_ml_tpu_torch.wrappers import Incremental

    rng = np.random.RandomState(3)
    X = rng.randn(20000, 16).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(20000) > 0).astype(np.float32)
    y3 = np.argmax(X[:, :3] + rng.randn(20000, 3), 1).astype(np.float32)
    yr = (X @ rng.randn(16)).astype(np.float32)
    mm = np.memmap(str(tmp_path / "X.f32"), dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X
    kw = dict(max_iter=3, random_state=0, alpha=1e-3, eta0=0.05)
    fits = {}
    for where in ("cuda", "cpu"):
        with config.set(device=where):
            fused.reset_launches()
            cohort = [SGDClassifier(alpha=a) for a in (1e-4, 1e-2, 1e-1)]
            for m in cohort:
                m._batch_prepare({"classes": np.array([0.0, 1.0])})
            SGDClassifier._batched_fused_calls(
                cohort, [(X[:7000], y[:7000]), (X[7000:], y[7000:])])
            SGDClassifier._batch_publish(cohort, 16)
            fits[where] = (
                SGDClassifier(**kw).fit(X, y),
                SGDClassifier(loss="hinge", **kw).fit(mm, y),
                SGDClassifier(**kw).fit(torch.from_numpy(X).to(where),
                                        torch.from_numpy(y3).to(where)),
                SGDRegressor(**kw).fit(X, yr),
                Incremental(SGDClassifier(**kw), random_state=1).fit(
                    ShardedArray.from_array(X), ShardedArray.from_array(y)
                ).estimator_,
                *cohort)
            counts = fused.launches()
        if where == "cuda":
            # 8 blocks a pass: 3 epochs of the two binary fits, the
            # regressor, one Incremental pass; the multiclass fit and the
            # cohort's two steps on the many-rows kernel
            assert counts["fused_sgd_block_grad"] == 8 * 3 * 3 + 8
            assert counts["fused_sgd_many_block_grad"] == 8 * 3 + 2
    # 1e-4: f32 sums in another order; a hinge row whose margin sits on 1
    # may take the other side, moving one step by lr |x| / rows (6e-5)
    for a, b in zip(fits["cuda"], fits["cpu"]):
        np.testing.assert_allclose(a.coef_, b.coef_, rtol=0, atol=1e-4)
        np.testing.assert_allclose(a.intercept_, b.intercept_, rtol=0,
                                   atol=1e-4)


# a block that is a row view of a larger X at d = 13 (it starts 52 bytes
# into X's storage, off a 16-byte boundary), and the widest cohort (N =
# 128: eight groups of 16 weight rows, each walking the CTA's tiles)
@pytest.mark.parametrize("loss", ["log_loss", "hinge"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d,N,codes", [(13, 10, True), (13, 16, False),
                                       (128, 128, False)])
def test_sgd_many_kernel_on_a_view_and_at_128_models(dev, loss, bf16, d, N,
                                                     codes):
    from chip_smoke import check_sgd, hinge_slack, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    n, lo, n_valid = 30_000, 1, 29_990
    g = torch.Generator(device=dev).manual_seed(d + N)
    X = torch.randn((n + 2, d), generator=g, device=dev)
    Y = torch.randint(0, N, (n + 2,), generator=g, device=dev).float() \
        if codes else (torch.rand(n + 2, generator=g, device=dev) < 0.5
                       ).float()
    x, y = X[lo:lo + n], Y[lo:lo + n]
    assert x.data_ptr() % 16 != 0 or d % 4 == 0
    W = torch.randn((N, d + 1), generator=g, device=dev) / (4 * d ** 0.5)
    iflags = 1.0 if codes else (torch.arange(N, device=dev) % 2).float()
    args = (x, n_valid, y, W, iflags, loss, codes, mxu)
    k1 = tuple(t.clone() for t in fused.fused_sgd_many_block_grad(*args))
    k2 = fused.fused_sgd_many_block_grad(*args)
    kc = fused.fused_sgd_many_block_grad(x.clone(), *args[1:])
    torch.cuda.synchronize()
    assert same_bits(k1, k2) and same_bits(k1, kc)
    slack = hinge_slack(x, n_valid, y, W, iflags, codes, mxu)[0] \
        if loss == "hinge" else 0.0
    check_sgd(k1, fused.sgd_many_block_grad_plain(
        x[:n_valid], n_valid, y[:n_valid], W, iflags, loss, codes, mxu),
        torch.bfloat16 if bf16 else torch.float32, slack)


# The walks of csrc/glm_value_grad.cu as ops/fused.py::glm_value_walk
# picks them: the staged walk (bf16 X up to d = 12288, f32 from
# GLM_STAGED_F32_MIN_D), the narrow walk (f32, d <= 128), the registers
# walk between them and the stream walk past d = 12288. ``lo``: the block
# is rows lo.. of a larger X, so at d % 4 != 0 it starts off a 16-byte
# boundary. Rows past n_valid are NaN (never read); n_valid 0 gives zeros.
_GLM_WALK_CASES = [
    # (dtype, n, d, n_valid, lo)
    ("bfloat16", 5, 1, 5, 0), ("bfloat16", 391, 7, 350, 1),
    ("bfloat16", 20_000, 257, 19_999, 0), ("bfloat16", 3000, 257, 2001, 3),
    ("bfloat16", 700, 4097, 699, 0), ("bfloat16", 300, 257, 0, 0),
    ("bfloat16", 100, 13_000, 97, 0),
    ("float32", 700, 4097, 693, 0), ("float32", 500, 4097, 499, 1),
    ("float32", 300, 10_000, 297, 0), ("float32", 100, 20_000, 97, 0),
    ("float32", 2000, 2049, 1999, 0), ("float32", 700, 4096, 693, 0),
    ("float32", 20_000, 128, 19_999, 0), ("float32", 5000, 13, 4990, 1),
    ("float32", 5000, 64, 4999, 0), ("float32", 100, 1, 97, 0),
    ("float32", 300, 64, 0, 0),
]


@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("dtype,n,d,n_valid,lo", _GLM_WALK_CASES)
def test_glm_walks_match_plain(dev, family, dtype, n, d, n_valid, lo):
    from chip_smoke import check_glm, same_bits
    from dask_ml_tpu_torch.ops import fused

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(n + d + lo)
    X = torch.randn((n + lo, d), generator=g, device=dev).to(dtype)
    x = X[lo:]
    x[n_valid:] = torch.nan
    beta = torch.randn(d, generator=g, device=dev) / (2 * d ** 0.5)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    if family == "poisson":
        y = torch.poisson(torch.ones(n, device=dev), generator=g)
    elif family == "normal":
        y = torch.randn(n, generator=g, device=dev)
    args = (x, n_valid, y, beta, family)
    before = fused.fused_glm_value_grad.launches
    k1 = tuple(t.clone() for t in fused.fused_glm_value_grad(*args))
    k2 = fused.fused_glm_value_grad(*args)
    torch.cuda.synchronize()
    assert fused.fused_glm_value_grad.launches == before + 2
    assert same_bits(k1, k2)
    assert all(bool(torch.isfinite(t).all()) for t in k1)
    if n_valid == 0:
        assert not any(bool(t.any()) for t in k1)
        return
    check_glm(k1, fused.glm_value_grad_plain(
        x[:n_valid].contiguous(), n_valid, y[:n_valid], beta, family), dtype)


# kernel 5 on the narrow walk (d <= 128) at d = 1, 13 (a view off 16
# bytes), 64 and 128, and the registers walk beside it at d = 256
@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,d,n_valid,lo", [(100, 1, 97, 0),
                                            (30_000, 13, 29_990, 1),
                                            (30_000, 64, 29_999, 0),
                                            (250_000, 128, 249_990, 0),
                                            (3000, 128, 0, 0),
                                            (20_000, 256, 19_999, 0)])
def test_sgd_block_walks_match_plain(dev, loss, bf16, n, d, n_valid, lo):
    from chip_smoke import check_sgd, hinge_slack, same_bits
    from dask_ml_tpu_torch.ops import fused

    mxu = torch.bfloat16 if bf16 else None
    g = torch.Generator(device=dev).manual_seed(n + d)
    X = torch.randn((n + lo, d), generator=g, device=dev)
    x = X[lo:]
    assert lo == 0 or d % 4 == 0 or x.data_ptr() % 16 != 0
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    if loss == "squared_error":
        y = torch.randn(n, generator=g, device=dev)
    x[n_valid:] = torch.nan
    y[n_valid:] = torch.nan
    w = torch.randn(d + 1, generator=g, device=dev) / (4 * d ** 0.5)
    walk = fused.glm_value_walk(d, torch.float32,
                                "vg_bf16" if bf16 else "vg")
    assert walk.walk == ("narrow" if d <= 128 else "registers")
    args = (x, n_valid, y, w, 1.0, loss, mxu)
    k1 = tuple(t.clone() for t in fused.fused_sgd_block_grad(*args))
    k2 = fused.fused_sgd_block_grad(*args)
    torch.cuda.synchronize()
    assert same_bits(k1, k2)
    assert all(bool(torch.isfinite(t).all()) for t in k1)
    if n_valid == 0:
        assert not any(bool(t.any()) for t in k1)
        return
    slack = hinge_slack(x, n_valid, y, w, 1.0, False, mxu)[0] \
        if loss == "hinge" else 0.0
    check_sgd(k1, fused.sgd_block_grad_plain(
        x[:n_valid], n_valid, y[:n_valid], w, 1.0, loss, mxu),
        torch.bfloat16 if bf16 else torch.float32, slack)


def test_streamed_cohort_round_goes_through_the_kernel(dev):
    """A streamed cohort round on the card: one launch of
    fused_sgd_many_block_grad per block step and no other kernel, the
    weights against the same round on the CPU (the kernel against its
    plain version, 1e-5: f32 sums in another order), two runs bit-equal,
    and a model not active in the round untouched."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel.streaming import BlockStream

    rng = np.random.RandomState(5)
    X = rng.randn(12000, 24).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(12000) > 0).astype(np.float32)
    order = np.array([0, 1, 2, 3, 4, 5, 0, 1])
    act = np.zeros((len(order), 5), np.float32)
    act[:, 0] = 1
    act[2:6, 1] = 1
    act[5:, 2] = 1
    act[::2, 3] = 1

    def run(where):
        with config.set(device=where):
            ms = [SGDClassifier(alpha=a, eta0=e) for a, e in
                  [(1e-4, 0.05), (1e-3, 0.1), (1e-2, 0.02), (1e-5, 0.3),
                   (1e-3, 0.01)]]
            for m in ms:
                m._batch_prepare({"classes": np.array([0.0, 1.0])})
                m.partial_fit(X[:2000], y[:2000])
            before = ms[4]._w.clone()
            stream = BlockStream((X, y), block_rows=2000)
            fused.reset_launches()
            info = SGDClassifier._streamed_cohort_round(ms, stream, order,
                                                        act, n_slots=8)
            torch.cuda.synchronize()
            counts = fused.launches()
            assert torch.equal(ms[4]._w, before)
            return np.stack([m._w.cpu().numpy() for m in ms]), info, counts

    W1, info, counts = run("cuda")
    W2, _, _ = run("cuda")
    Wc, _, _ = run("cpu")
    want = dict.fromkeys(counts, 0)
    want["fused_sgd_many_block_grad"] = len(order)
    assert counts == want and info["dispatches"] == len(order)
    assert info["fused"] and info["fused_reason"] is None
    np.testing.assert_array_equal(W1, W2)
    np.testing.assert_allclose(W1, Wc, rtol=0, atol=1e-5)


@pytest.mark.parametrize("what", ["lbfgs", "sgd", "kmeans"])
def test_kill_and_resume_on_the_card(dev, tmp_path, what):
    """A streamed fit on the card killed mid-fit (an injected crash at a
    block's yield, with queued copies and launches behind it) and rerun:
    bit-equal to an uncheckpointed fit, through the kernels, with one
    resume and no checkpoint left."""
    import os

    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.observability import (counters_reset,
                                                 counters_snapshot)
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.reliability import InjectedCrash, reset_plans

    rng = np.random.RandomState(3)
    X = rng.randn(40000, 64).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(40000) > 0).astype(np.float32)

    def make():
        if what == "lbfgs":
            return LogisticRegression(solver="lbfgs", max_iter=10,
                                      tol=0.0).fit(X, y)
        if what == "sgd":
            return SGDClassifier(max_iter=3, shuffle=True,
                                 random_state=0).fit(X, y)
        return KMeans(n_clusters=8, init=X[:8], max_iter=6,
                      tol=0.0).fit(X)

    attrs = {"lbfgs": ("coef_", "intercept_"), "sgd": ("coef_", "_t"),
             "kmeans": ("cluster_centers_", "inertia_", "n_iter_")}[what]
    cfg = dict(stream_block_rows=5000)
    with config.set(**cfg):
        fused.reset_launches()
        ctl = make()
        launched = sum(fused.launches().values())
    assert launched > 0
    path = str(tmp_path)
    reset_plans()
    counters_reset()
    with config.set(stream_checkpoint_path=path,
                    fault_plan="superblock_dispatch:crash@20", **cfg):
        with pytest.raises(InjectedCrash):
            make()
    reset_plans()
    with config.set(stream_checkpoint_path=path, **cfg):
        res = make()
    torch.cuda.synchronize()
    assert counters_snapshot()["stream_resumes"] == 1
    assert os.listdir(path) == []
    for a in attrs:
        np.testing.assert_array_equal(np.asarray(getattr(res, a)),
                                      np.asarray(getattr(ctl, a)), a)


def test_served_entry_points_replay_one_graph_per_bucket(dev):
    """Each served entry point captures one CUDA graph per batch height
    and replays it: outputs equal to the body run eagerly on the CPU
    (labels) and within 1e-5 (margins, distances), a same-shape swap
    captures nothing, and the parameters stay on the card."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.observability import counters_snapshot
    from dask_ml_tpu_torch.wrappers import compiled_batch_fn

    rng = np.random.RandomState(0)
    X = rng.randn(500, 12).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with config.set(device="cpu"):
        clf = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
        km = KMeans(n_clusters=4, random_state=0).fit(X)
        cases = ((clf, "decision_function"), (clf, "predict"),
                 (km, "transform"), (km, "predict"))
        refs = [compiled_batch_fn(e, m)(X[:100]) for e, m in cases]
    for (est, method), ref in zip(cases, refs):
        fn = compiled_batch_fn(est, method)
        assert fn.graphs.cuda and all(
            p.is_cuda for p in fn.graphs.params.values())
        c0 = counters_snapshot().get("graph_captures", 0)
        outs = [fn(X[:100]) for _ in range(3)]
        fn(X[:37])
        fn.swap_params(est)
        fn(X[:100])
        assert counters_snapshot()["graph_captures"] - c0 == 2
        assert all(np.array_equal(o, outs[0]) for o in outs)
        if method in ("decision_function", "transform"):
            np.testing.assert_allclose(outs[0], ref, atol=1e-5)
        else:
            np.testing.assert_array_equal(outs[0], ref)


def test_a_failed_capture_raises(dev):
    """A body the card cannot capture (a host sync inside) raises: there
    is no eager fallback."""
    from dask_ml_tpu_torch.plans import ProgramPlan

    prog = ProgramPlan(name="t.uncapturable",
                       body=lambda p, x: x * float(x.sum().item())).build()
    gs = prog.graphs({}, dev)
    with pytest.raises(RuntimeError):
        gs.run((np.ones((8, 2), np.float32),))
    assert gs.keys() == ()


def test_kernel_registry_times_launches_and_counts_captures(dev):
    """With obs_programs on, every launch of kernel 1 is timed by a CUDA
    event pair, resolved at snapshot time, within its bound; a launch
    inside a CUDA graph capture records no event and is counted only."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.observability import _programs
    from dask_ml_tpu_torch.ops import fused

    n, d = 200_000, 257
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=dev)
    y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    beta = torch.randn(d, generator=gen, device=dev) / 16.0
    name = "fused_glm_value_grad"
    _programs.programs_reset()
    l0 = fused.launches()[name]
    with config.set(obs_programs=True):
        for _ in range(3):
            fused.fused_glm_value_grad(x, n, y, beta, "logistic")
        rows = {r["program"]: r for r in _programs.programs_snapshot()}
        r = rows[name]
        assert r["calls"] - l0 == 3 and r["timed_calls"] == 3
        assert r["device_ms_median"] > 0 and r["exec_s"] > 0
        nbytes, _ = _programs.KERNEL_COSTS[name](n, d, 4)
        assert r["bytes_per_call"] == nbytes
        if r["bound_s"] is not None:
            assert r["share_of_bound"] <= _programs.SHARE_FLAG
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused.fused_glm_value_grad(x, n, y, beta, "logistic")
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused.fused_glm_value_grad(x, n, y, beta, "logistic")
        graph.replay()
        torch.cuda.synchronize()
        rows = {r["program"]: r for r in _programs.programs_snapshot()}
    r = rows[name]
    assert r["captured_calls"] == 1
    assert r["timed_calls"] == 4 and r["calls"] - l0 == 5
    ref = fused.glm_value_grad_plain(x, n, y, beta, "logistic")
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=0)
    _programs.programs_reset()


def test_serving_observability_is_bit_equal_and_captures_nothing(dev):
    """A warmed server with traces, drift, shadow rows and the alert
    engine on answers bit-equal to one with every knob off (the same
    sequential requests, so the same batches), and neither its traffic
    nor its hot swap's canary captures a CUDA graph."""
    import numpy as np

    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.observability import (_requests, alerts,
                                                 counters_snapshot, drift)
    from dask_ml_tpu_torch.serving import BucketLadder, ModelServer

    rng = np.random.RandomState(0)
    X = rng.randn(4000, 32).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(4000) > 0).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    clf2 = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    on = dict(obs_trace_sample=1.0, obs_shadow_fraction=1.0,
              obs_drift_interval_s=0.0, obs_alert_rules="builtin",
              obs_alert_interval_s=60.0)
    outs = {}
    try:
        for knobs in ({"obs_drift": False}, on):
            with config.set(**knobs):
                srv = ModelServer(clf, ladder=BucketLadder(8, 256, 2.0),
                                  batch_window_ms=0.0).warmup()
                with srv:
                    c0 = counters_snapshot().get("graph_captures", 0)
                    outs[len(knobs)] = [
                        srv.submit(X[i:i + 1 + i % 200]).result(30)
                        for i in range(0, 3000, 37)]
                    srv.swap_model(clf2)
                    srv.submit(X[:5]).result(30)
                    assert counters_snapshot().get(
                        "graph_captures", 0) == c0
        assert srv._drift_on and srv._canary_versions == {1}
        (canary,) = drift.status_block()["canaries"]
        assert canary["n_rows"] > 0
        assert _requests.traces_data()["counts"]["completed"] == \
            len(outs[len(on)]) + 1
        for a, b in zip(outs[1], outs[len(on)]):
            assert np.array_equal(a, b)
    finally:
        alerts.reset()
        drift.reset()
        _requests.traces_reset()
