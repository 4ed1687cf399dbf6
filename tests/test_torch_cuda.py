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
# d reaches every build of the kernel: 1, 2, 4, 8, 16 and 32 columns per
# thread in registers (d = 13, 257, 600, 1365, 3000, 6000; 1 and 1360
# with fewer rows than a block), and rows streamed by column (d = 8193)
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
# lloyd_geometry): a whole row per step with resident centers; 16-byte
# and 4-byte row copies (d % 4); more than one 64-center chunk (k=200,
# k=256); rows cut into feature chunks with the sums in shared memory
# (d=300) and in device memory (d=768, d=1001, d=2048 with k=300)
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
