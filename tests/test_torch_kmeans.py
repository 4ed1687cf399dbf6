"""The port's KMeans (dask_ml_tpu_torch) against dask_ml_tpu on the same
data, on the CPU (device="cpu": the fused kernels run their plain
versions). Inputs come from numpy.random.RandomState."""

import os

import numpy as np
import pytest

from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.cluster import KMeans, k_means


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _blobs(seed, n=2000, d=6, k=4, spread=0.5, scale=10.0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-scale, scale, size=(k, d)).astype(np.float32)
    lab = rng.randint(0, k, size=n)
    X = (centers[lab] + spread * rng.randn(n, d)).astype(np.float32)
    return X, centers


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("seed,n,d,k", [(0, 2000, 6, 4), (1, 4096, 16, 8),
                                        (2, 777, 3, 5)])
def test_ndarray_init_matches_jax(seed, n, d, k, use_kernel):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[: n // 2] += 3.0
    init = X[:k].copy()
    j = JKMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    t = KMeans(n_clusters=k, init=init, max_iter=50,
               use_kernel=use_kernel).fit(X)
    assert (t.kernel_info_["kernel"] is not None) == (use_kernel is None)
    # centers are means of the same rows summed in another order: 1e-3;
    # the inertia sums n f32 terms: rel 1e-4
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               atol=1e-3)
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-4)
    np.testing.assert_array_equal(t.labels_.to_numpy(),
                                  j.labels_.to_numpy())
    assert t.n_iter_ == j.n_iter_


@pytest.mark.parametrize("init", ["k-means||", "k-means++", "random"])
def test_inits_recover_blobs(init):
    """Well-separated blobs: every true center has a fitted center
    within the blob's noise (spread 0.5 in 6-D, 4 blobs)."""
    X, centers = _blobs(3)
    t = KMeans(n_clusters=4, init=init, random_state=0).fit(X)
    dist = np.sqrt(((centers[:, None] - t.cluster_centers_[None]) ** 2)
                   .sum(-1))
    if init == "random":
        # a uniform draw may seed two centers in one blob; Lloyd from it
        # still ends at a local optimum of finite inertia
        assert np.isfinite(t.inertia_) and t.n_iter_ >= 1
        return
    assert dist.min(1).max() < 0.2
    assert sorted(np.bincount(t.labels_.to_numpy(), minlength=4)) == \
        sorted(np.bincount(((X[:, None] - centers[None]) ** 2).sum(-1)
                           .argmin(1), minlength=4))


def test_kmeans_parallel_is_seeded():
    X, _ = _blobs(4)
    a = KMeans(n_clusters=4, random_state=7).fit(X)
    b = KMeans(n_clusters=4, random_state=7).fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)


def test_predict_transform_score_and_functional():
    X, _ = _blobs(5, n=600)
    t = KMeans(n_clusters=4, random_state=0).fit(X)
    np.testing.assert_array_equal(t.predict(X).to_numpy(),
                                  t.labels_.to_numpy())
    dist = t.transform(X).to_numpy()
    assert dist.shape == (600, 4)
    np.testing.assert_array_equal(dist.argmin(1), t.labels_.to_numpy())
    assert t.score(X) == pytest.approx(-t.inertia_, rel=1e-5)
    np.testing.assert_array_equal(t.fit_predict(X).to_numpy(),
                                  t.labels_.to_numpy())
    c, lab, inertia, n_iter = k_means(X, 4, random_state=0,
                                      return_n_iter=True)
    np.testing.assert_allclose(c, t.cluster_centers_)
    assert inertia == pytest.approx(t.inertia_) and n_iter == t.n_iter_


def test_convert_carries_jax_fit():
    """A KMeans fitted by dask_ml_tpu, carried across as plain numpy:
    equal predict, transform within 1e-4 and score to rel 1e-4. Both are
    f32 expansions ||x||² - 2x.c + ||c||² summed in another order; with
    ||x||² near 300 against d² near 1.4 each row keeps ~2e-5 absolute."""
    X, _ = _blobs(6, n=1000)
    j = JKMeans(n_clusters=4, init="k-means||", random_state=0).fit(X)
    t = convert.convert(j)
    np.testing.assert_array_equal(t.predict(X).to_numpy(),
                                  j.predict(X).to_numpy())
    np.testing.assert_allclose(t.transform(X).to_numpy(),
                               j.transform(X).to_numpy(), atol=1e-4)
    assert t.score(X) == pytest.approx(j.score(X), rel=1e-4)
    np.testing.assert_array_equal(t.labels_.to_numpy(),
                                  j.labels_.to_numpy())


def test_errors(tmp_path):
    X, _ = _blobs(7, n=50)
    with pytest.raises(ValueError, match="n_clusters"):
        KMeans(n_clusters=60).fit(X)
    with pytest.raises(ValueError, match="init array"):
        KMeans(n_clusters=3, init=X[:2]).fit(X)
    # checkpoint_path is ported: a checkpointed fit is the plain one and
    # clears its checkpoint (tests/test_torch_checkpoint.py kills one)
    ck = str(tmp_path / "ck")
    a = KMeans(n_clusters=3, random_state=0, checkpoint_path=ck,
               checkpoint_every=1).fit(X)
    b = KMeans(n_clusters=3, random_state=0).fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    assert a.n_iter_ == b.n_iter_ and not os.path.exists(ck)
    bad = X.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        KMeans(n_clusters=3).fit(bad)
