"""The port's streamed (out-of-core) KMeans against dask_ml_tpu's on the
same data, on the CPU (device="cpu": ``fused_kmeans_block_stats`` runs
its plain version). Both packages stream an ndarray taller than
``config.stream_block_rows`` or an ``np.memmap``; dask_ml_tpu runs on
one device (``stream_mesh=1``), so both cut the same blocks."""

import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.ops import fused

BLOCK = 600


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every superblock in fresh buffers,
    the reference's own switch for backends whose ``device_put`` aliases
    host memory: jax's CPU backend aliases a 64-byte-aligned numpy array,
    and a reused staging slab could then be rewritten under a read that
    is still queued. Its one-time probe (an 8-float array, copied) does
    not see that."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(seed, n, d, k):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[: n // 2] += 3.0
    return X, X[:k].copy()


def _blobs(seed, n=2000, d=6, k=4, spread=0.5, scale=10.0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-scale, scale, size=(k, d)).astype(np.float32)
    lab = rng.randint(0, k, size=n)
    X = (centers[lab] + spread * rng.randn(n, d)).astype(np.float32)
    return X, centers


def _memmap(tmp_path, X):
    path = str(tmp_path / "X.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)


def _assert_same_fit(t, j):
    # centers are means of the same rows summed in another order: 1e-3;
    # the inertia sums n f32 terms: rel 1e-4
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               atol=1e-3)
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-4)
    np.testing.assert_array_equal(np.asarray(t.labels_),
                                  np.asarray(j.labels_))
    assert t.n_iter_ == j.n_iter_


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("seed,n,d,k", [(0, 2000, 6, 4), (1, 3001, 16, 8),
                                        (2, 777, 3, 5)])
def test_streamed_matches_jax(seed, n, d, k, use_kernel):
    X, init = _data(seed, n, d, k)
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1):
        j = JKMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    with config.set(stream_block_rows=BLOCK):
        t = KMeans(n_clusters=k, init=init, max_iter=50,
                   use_kernel=use_kernel).fit(X)
    assert isinstance(t.labels_, np.ndarray) and t.labels_.dtype == np.int32
    assert (t.kernel_info_["kernel"] == "fused_kmeans_block_stats") == \
        (use_kernel is None)
    _assert_same_fit(t, j)


def test_memmap_matches_jax_and_resident(tmp_path):
    X, init = _data(3, 2500, 8, 5)
    mm = _memmap(tmp_path, X)
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1):
        j = JKMeans(n_clusters=5, init=init, max_iter=50).fit(mm)
    with config.set(stream_block_rows=BLOCK):
        t = KMeans(n_clusters=5, init=init, max_iter=50).fit(mm)
    _assert_same_fit(t, j)
    r = KMeans(n_clusters=5, init=init, max_iter=50).fit(X)
    np.testing.assert_allclose(t.cluster_centers_, r.cluster_centers_,
                               atol=1e-3)
    np.testing.assert_array_equal(t.labels_, r.labels_.to_numpy())
    assert t.n_iter_ == r.n_iter_
    assert t.stream_stats_["passes"] >= t.n_iter_ + 2


def test_streamed_inference_equals_resident(tmp_path):
    """predict, transform and score stream a memmap (or a tall ndarray)
    and equal the resident port's."""
    X, init = _data(4, 1800, 5, 3)
    r = KMeans(n_clusters=3, init=init, max_iter=20).fit(X)
    mm = _memmap(tmp_path, X)
    for src in (mm, X):
        with config.set(stream_block_rows=BLOCK):
            lab = r.predict(src)
            dist = r.transform(src)
            score = r.score(src)
        assert isinstance(lab, np.ndarray) and lab.shape == (1800,)
        np.testing.assert_array_equal(lab, r.predict(X).to_numpy())
        np.testing.assert_allclose(dist, r.transform(X).to_numpy(),
                                   rtol=1e-6, atol=1e-5)
        assert score == pytest.approx(r.score(X), rel=1e-6)


@pytest.mark.parametrize("init", ["k-means||", "k-means++", "random"])
def test_streamed_inits_recover_blobs(init):
    """The resident test's rule (tests/test_torch_kmeans.py): every true
    center has a fitted center within the blob's noise, with the inits
    drawn block by block."""
    X, centers = _blobs(3)
    with config.set(stream_block_rows=BLOCK):
        t = KMeans(n_clusters=4, init=init, random_state=0).fit(X)
        again = KMeans(n_clusters=4, init=init, random_state=0).fit(X)
    np.testing.assert_array_equal(t.cluster_centers_, again.cluster_centers_)
    if init == "random":
        assert np.isfinite(t.inertia_) and t.n_iter_ >= 1
        return
    dist = np.sqrt(((centers[:, None] - t.cluster_centers_[None]) ** 2)
                   .sum(-1))
    assert dist.min(1).max() < 0.2
    assert sorted(np.bincount(t.labels_, minlength=4)) == \
        sorted(np.bincount(((X[:, None] - centers[None]) ** 2).sum(-1)
                           .argmin(1), minlength=4))


def test_streamed_bf16_cross_term():
    """fit_dtype="bfloat16" takes the bf16 cross term in the streamed
    kernel (the JAX streamed flavour's mxu policy): on separated blobs
    the same clusters as the f32 fit."""
    X, centers = _blobs(5)
    init = centers + 0.5
    with config.set(stream_block_rows=BLOCK):
        b = KMeans(n_clusters=4, init=init, fit_dtype="bfloat16").fit(X)
        f = KMeans(n_clusters=4, init=init).fit(X)
    assert b.fit_dtype_ == "bfloat16" and f.fit_dtype_ == "float32"
    np.testing.assert_array_equal(b.labels_, f.labels_)
    np.testing.assert_allclose(b.cluster_centers_, f.cluster_centers_,
                               atol=1e-3)


def test_streamed_errors_and_no_launches_on_the_cpu():
    X, init = _data(6, 500, 4, 3)
    fused.reset_launches()
    with config.set(stream_block_rows=100):
        KMeans(n_clusters=3, init=init, max_iter=3).fit(X)
        with pytest.raises(ValueError, match="n_clusters"):
            KMeans(n_clusters=600).fit(X)
        with pytest.raises(ValueError, match="init array"):
            KMeans(n_clusters=3, init=X[:2]).fit(X)
        with pytest.raises(ValueError, match="Unknown init"):
            KMeans(n_clusters=3, init="forgy").fit(X)
        bad = X.copy()
        bad[7, 1] = np.nan
        with pytest.raises(FloatingPointError, match="non-finite"):
            KMeans(n_clusters=3, init=init, max_iter=3).fit(bad)
    assert all(v == 0 for v in fused.launches().values())
