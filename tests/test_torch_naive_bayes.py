"""The port's GaussianNB against dask_ml_tpu's on the same numpy data, on
the CPU. Tolerances: theta_ to relative 1e-5; var_ to 1e-6 of E[x²] =
var + theta² (both packages take JAX's f32 E[x²] − mean², whose sums
round at the scale of E[x²] and add in another order); class counts and
priors exactly, predictions equal; predict_proba to 1e-5 on the same
statistics (a fit, or JAX's statistics carried across), and to 1e-4
after streamed partial_fits, whose running sums part by those f32
roundings block after block."""

import pickle

import numpy as np
import pytest

from dask_ml_tpu import naive_bayes as JN
from dask_ml_tpu import wrappers as JW
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import naive_bayes as TN
from dask_ml_tpu_torch import wrappers as TW
from dask_ml_tpu_torch.parallel import ShardedArray


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every block in fresh buffers
    (see tests/test_torch_sgd.py): jax's CPU backend aliases
    64-byte-aligned numpy arrays."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(seed=0, n=1200, d=6, k=3):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n).astype(np.float32) * 2.0 - 1.0
    X = rng.randn(n, d) * (1.0 + np.arange(d)) + y[:, None] * 1.5 + 4.0
    return X.astype(np.float32), y


def _same(t, j):
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.class_count_, j.class_count_)
    np.testing.assert_allclose(t.class_prior_, j.class_prior_, rtol=1e-12)
    np.testing.assert_allclose(t.theta_, j.theta_, rtol=1e-5, atol=1e-6)
    second = j.var_ + j.theta_ ** 2
    assert np.all(np.abs(t.var_ - j.var_) <= 1e-6 * second)


def _predictions(t, j, X, atol=1e-5):
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               atol=atol)
    assert t.score(X, j.predict(X)) == 1.0


@pytest.mark.parametrize("kw", [dict(), dict(priors=[0.2, 0.3, 0.5]),
                                dict(var_smoothing=1e-3)])
@pytest.mark.parametrize("sharded", [False, True])
def test_fit_matches_jax(kw, sharded):
    X, y = _data()
    Xt = ShardedArray.from_array(X) if sharded else X
    j = JN.GaussianNB(**kw).fit(X, y)
    t = TN.GaussianNB(**kw).fit(Xt, y)
    _same(t, j)
    _predictions(t, j, X)
    np.testing.assert_allclose(t.predict_log_proba(X),
                               j.predict_log_proba(X), atol=1e-4)


def test_partial_fit_matches_jax_and_fit():
    X, y = _data(1)
    j, t = JN.GaussianNB(), TN.GaussianNB()
    for lo in range(0, len(X), 250):
        kw = {"classes": [-1.0, 1.0, 3.0]} if lo == 0 else {}
        j.partial_fit(X[lo:lo + 250], y[lo:lo + 250], **kw)
        t.partial_fit(X[lo:lo + 250], y[lo:lo + 250], **kw)
    _same(t, j)
    _predictions(t, j, X, atol=1e-4)
    _same(t, TN.GaussianNB().fit(X, y))
    with pytest.raises(ValueError, match="outside classes"):
        t.partial_fit(X[:5], np.full(5, 9.0))
    with pytest.raises(ValueError, match="classes= is required"):
        TN.GaussianNB().partial_fit(X, y)


def test_pickle_mid_stream():
    X, y = _data(2)
    t = TN.GaussianNB().partial_fit(X[:600], y[:600], classes=[-1, 1, 3])
    j = JN.GaussianNB().partial_fit(X[:600], y[:600], classes=[-1, 1, 3])
    t2 = pickle.loads(pickle.dumps(t))
    assert isinstance(t2._stats_[0], np.ndarray)
    _same(t2, j)
    t2.partial_fit(X[600:], y[600:])
    j.partial_fit(X[600:], y[600:])
    _same(t2, j)
    _predictions(t2, j, X, atol=1e-4)


def test_incremental_gaussian_nb():
    X, y = _data(3, n=3000)
    j = JW.Incremental(JN.GaussianNB(), shuffle_blocks=False).fit(X, y)
    t = TW.Incremental(TN.GaussianNB(), shuffle_blocks=False).fit(X, y)
    _same(t.estimator_, j.estimator_)
    _predictions(t, j, X, atol=1e-4)


def test_convert_carries_jax_fit():
    X, y = _data(4)
    j = JN.GaussianNB().partial_fit(X, y, classes=[-1, 1, 3])
    t = convert.convert(j)
    assert type(t) is TN.GaussianNB
    _same(t, j)
    _predictions(t, j, X)
