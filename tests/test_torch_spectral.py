"""The port's SpectralClustering against dask_ml_tpu's, on the CPU.

The inducing sample is drawn from JAX's key and handed to the port
(``jax_inducing``), so both build the same Nyström factor; the
embedding's column signs differ between QR implementations, so the test
compares ``eigenvalues_`` (relative 1e-4) and ``labels_`` up to a
permutation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu.cluster import SpectralClustering as JS
from dask_ml_tpu.models.kmeans import _gumbel_top_l
from dask_ml_tpu_torch import config, convert, datasets
from dask_ml_tpu_torch.cluster import KMeans, SpectralClustering as TS
from dask_ml_tpu_torch.models import spectral


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture
def jax_inducing(monkeypatch):
    def draw(mask, random_state, c):
        key = jax.random.PRNGKey(0 if random_state is None
                                 else int(random_state))
        idx = _gumbel_top_l(jnp.asarray(mask.numpy()), key, c)
        return torch.as_tensor(np.array(idx), device=mask.device)

    monkeypatch.setattr(spectral, "_inducing_rows", draw)


def _blobs(seed=0, n=1500, d=6, k=4):
    X, y = datasets.make_blobs(n, d, centers=k, random_state=seed)
    return X.to_numpy(), y.to_numpy().astype(int)


def _agreement(a, b):
    """Share of rows on which two labelings agree under the best
    one-to-one relabeling (greedy on the contingency table)."""
    a, b = np.asarray(a, int), np.asarray(b, int)
    table = np.zeros((a.max() + 1, b.max() + 1), int)
    np.add.at(table, (a, b), 1)
    hit = 0
    while table.size and table.max() > 0:
        i, j = np.unravel_index(np.argmax(table), table.shape)
        hit += table[i, j]
        table[i, :] = 0
        table[:, j] = 0
    return hit / len(a)


# (affinity, its parameters, inducing rows): the low-rank kernels take at
# most as many inducing rows as their Gram matrix's numerical rank (6
# features here), where A^{-1/2} is well conditioned; past it, both
# packages invert eigenvalues at the 1e-6 jitter, which no two
# eigensolvers agree on
@pytest.mark.parametrize("affinity,kw,c", [
    ("rbf", dict(gamma=1 / 12), 60),
    ("polynomial", dict(gamma=0.1, degree=2, coef0=1.0), 10),
    ("polynomial", dict(gamma=0.1, degree=3, coef0=1.0), 12),
    ("linear", dict(), 6),
    ("sigmoid", dict(gamma=0.01, coef0=0.0), 10),
])
def test_eigenvalues_match_jax(affinity, kw, c, jax_inducing):
    X, _ = _blobs(1)
    params = dict(n_clusters=4, random_state=2, n_init=2, n_components=c,
                  affinity=affinity, **kw)
    j = JS(**params).fit(X)
    t = TS(**params).fit(X)
    np.testing.assert_allclose(t.eigenvalues_, j.eigenvalues_, rtol=1e-4)


def test_labels_recover_blobs_and_match_jax(jax_inducing):
    X, truth = _blobs(3, n=2000, d=8, k=5)
    params = dict(n_clusters=5, random_state=0, gamma=1 / 16, n_init=3,
                  persist_embedding=True)
    j = JS(**params).fit(X)
    t = TS(**params).fit(X)
    labels = t.labels_.to_numpy()
    assert _agreement(labels, np.asarray(j.labels_.to_numpy())) == 1.0
    assert _agreement(labels, truth) == 1.0
    assert isinstance(t.assign_labels_, KMeans)
    assert t.embedding_.shape == (2000, 5)
    np.testing.assert_array_equal(t.fit_predict(X).to_numpy(), labels)
    c = convert.convert(j)
    assert isinstance(c.assign_labels_, KMeans)
    np.testing.assert_allclose(c.eigenvalues_, j.eigenvalues_)
    np.testing.assert_array_equal(c.labels_.to_numpy(),
                                  np.asarray(j.labels_.to_numpy()))


def test_callable_affinity(jax_inducing):
    X, truth = _blobs(4, n=900)

    def kern(x, z, scale=1.0):
        d2 = ((x[:, None, :] - z[None, :, :]) ** 2).sum(-1)
        return (-d2 / (12.0 * scale)).exp()

    t = TS(n_clusters=4, random_state=0, n_init=1, affinity=kern,
           kernel_params={"scale": 1.0}).fit(X)
    assert _agreement(t.labels_.to_numpy(), truth) == 1.0


@pytest.mark.parametrize("kw,msg", [
    (dict(assign_labels="discretize"), "assign_labels"),
    (dict(eigen_solver="arpack"), "eigen_solver"),
    (dict(eigen_tol=1e-3), "eigen_tol"),
    (dict(affinity="nearest_neighbors"), "nearest_neighbors"),
    (dict(affinity="cosine"), "Unknown affinity"),
])
def test_refused_parameters(kw, msg):
    X, _ = _blobs(5, n=200)
    with pytest.raises(ValueError, match=msg):
        TS(**kw).fit(X)
    with pytest.raises(ValueError, match=msg):
        JS(**kw).fit(X)
