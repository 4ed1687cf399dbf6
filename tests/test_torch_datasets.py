"""The port's dataset generators against dask_ml_tpu's, on the CPU.

The JAX package draws one seed per data shard of its mesh, so its data
depends on the shard count; the port draws one shard. On a one-device
mesh the two must be bit-equal, at every seed and shape here (several
classes, more than 62 informative features). The chunked normal draw of
make_classification must equal the one-shot draw, and the port's
make_blobs must equal scikit-learn 1.9's for one shard."""

import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from sklearn.datasets import make_blobs as sk_make_blobs

from dask_ml_tpu import datasets as J
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import datasets as T


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _one_device():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _bits(t, j):
    for a, b in zip(t, j):
        a, b = a.to_numpy(), np.asarray(b.to_numpy())
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


CASES = {
    "classification": ("make_classification",
                       dict(n_samples=1000, n_features=8)),
    "classification_multi": ("make_classification",
                             dict(n_samples=777, n_features=12,
                                  n_informative=6, n_classes=5,
                                  class_sep=2.0, flip_y=0.05)),
    "classification_wide": ("make_classification",
                            dict(n_samples=300, n_features=80,
                                 n_informative=70, n_classes=3)),
    "regression": ("make_regression",
                   dict(n_samples=500, n_features=9, noise=0.5, bias=2.0)),
    "blobs": ("make_blobs", dict(n_samples=611, n_features=5, centers=4)),
    "blobs_given": ("make_blobs",
                    dict(n_samples=400, centers=np.array(
                        [[0.0, 1.0], [5.0, -2.0], [-3.0, 4.0]]),
                         cluster_std=[0.5, 1.0, 2.0])),
    "counts": ("make_counts", dict(n_samples=500, n_features=6, scale=0.5)),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generators_bit_equal_on_one_device(case, seed):
    name, kw = CASES[case]
    t = getattr(T, name)(random_state=seed, **kw)
    j = getattr(J, name)(random_state=seed, mesh=_one_device(), **kw)
    _bits(t, j)


def test_classification_df_equal():
    kw = dict(n_samples=300, n_features=6, predictability=0.5,
              response_rate=0.3, random_state=3,
              dates=("2020-01-01", "2021-01-01"))
    tx, ty = T.make_classification_df(**kw)
    jx, jy = J.make_classification_df(mesh=_one_device(), **kw)
    assert list(tx.columns) == list(jx.columns)
    np.testing.assert_array_equal(tx.to_numpy(), jx.to_numpy())
    np.testing.assert_array_equal(ty.to_numpy(), jy.to_numpy())
    assert ty.name == jy.name == "target"


def test_chunked_draw_equals_one_shot(monkeypatch):
    kw = dict(n_samples=5000, n_features=16, n_classes=3, random_state=5)
    whole = T.make_classification(**kw)
    monkeypatch.setattr(T, "_DRAW_ELEMS", 16 * 37)   # 37-row chunks
    _bits(T.make_classification(**kw), whole)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cluster_std=[0.3, 1.0, 2.5], shuffle=False),
    dict(cluster_std=1.7),
])
def test_blobs_equal_scikit_learn(kw):
    centers = np.random.RandomState(0).uniform(-10, 10, size=(3, 4))
    X, y = T._blobs(1001, centers, random_state=11, **kw)
    Xs, ys = sk_make_blobs(n_samples=1001, n_features=4, centers=centers,
                           random_state=11, **kw)
    np.testing.assert_array_equal(X, Xs)
    np.testing.assert_array_equal(y, ys)


def test_dataframe_generator_names_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        T.make_classification_df(n_samples=10, random_state=0)
