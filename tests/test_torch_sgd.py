"""The port's SGDClassifier and SGDRegressor against dask_ml_tpu's on the
same data and ``random_state``, on the CPU.

dask_ml_tpu runs its XLA step (its default off a TPU) on one device: its
host fits under ``stream_mesh=1`` and its device fits on a one-device
mesh, because the eight virtual devices of tests/conftest.py would round
its blocks to a multiple of 8 rows and shard them. The port runs its
kernels' plain versions. Both cut the same blocks (``grid_partition``:
3000 rows in 8 blocks of 375) and walk them in the same shuffled order
(one ``np.random.RandomState(random_state)``), so the minibatches and lr
clocks are the same and only the summation order differs:
``coef_``/``intercept_`` agree to COEF_ATOL (measured: 1e-6 or less),
``n_iter_``, the predicted labels and the step clocks are equal.
"""

import numpy as np
import pytest
import torch

import jax

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.models import sgd as J
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu.parallel.sharded import ShardedArray as JShardedArray
from dask_ml_tpu.parallel.streaming import BlockStream as JBlockStream
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.models import sgd as T
from dask_ml_tpu_torch.ops import fused
from dask_ml_tpu_torch.parallel.sharded import ShardedArray
from dask_ml_tpu_torch.parallel.streaming import BlockStream

COEF_ATOL = 1e-5
N, D = 3000, 12


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


def _mesh():
    return device_mesh(devices=jax.devices()[:1])


def _jax(fn):
    """Run a dask_ml_tpu call on one device (host streams and device
    data alike)."""
    with jconfig.set(stream_mesh=1), use_mesh(_mesh()):
        return fn()


def _data(kind, seed=0, n=N, d=D):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    if kind == "binary":
        y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0)
        return X, np.where(y, 4.0, -1.0).astype(np.float32)  # labels -1, 4
    if kind == "multi":
        W = rng.randn(d, 3)
        return X, (np.argmax(X @ W + rng.randn(n, 3), 1) * 2 + 1
                   ).astype(np.float32)                       # labels 1, 3, 5
    return X, (X @ rng.randn(d) + 0.5 + 0.1 * rng.randn(n)).astype(np.float32)


def _cls(kind):
    return "SGDRegressor" if kind == "regression" else "SGDClassifier"


def _same_model(j, t, X):
    np.testing.assert_allclose(t.coef_, j.coef_, rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, rtol=0,
                               atol=COEF_ATOL)
    assert np.shape(t.coef_) == np.shape(j.coef_)
    assert np.shape(t.intercept_) == np.shape(j.intercept_)
    assert t._t == j._t
    if hasattr(j, "n_iter_"):
        assert t.n_iter_ == j.n_iter_
    pj = _jax(lambda: j.predict(X))
    if isinstance(t, T.SGDClassifier):
        np.testing.assert_array_equal(t.predict(X), pj)
        np.testing.assert_array_equal(t.classes_, j.classes_)
        np.testing.assert_allclose(t.decision_function(X),
                                   _jax(lambda: j.decision_function(X)),
                                   rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(t.predict(X), pj, rtol=0, atol=1e-4)


def _fit_both(kind, X, y, device=False, **kw):
    name = _cls(kind)
    if device:
        j = _jax(lambda: getattr(J, name)(**kw).fit(
            JShardedArray.from_array(X, mesh=_mesh()),
            JShardedArray.from_array(y, mesh=_mesh())))
        t = getattr(T, name)(**kw).fit(ShardedArray.from_array(X),
                                       ShardedArray.from_array(y))
    else:
        j = _jax(lambda: getattr(J, name)(**kw).fit(X, y))
        t = getattr(T, name)(**kw).fit(X, y)
    return j, t


@pytest.mark.parametrize("penalty", ["l2", "l1", "elasticnet", None])
@pytest.mark.parametrize("learning_rate", ["constant", "invscaling",
                                           "optimal"])
def test_binary_fit_matches(penalty, learning_rate):
    X, y = _data("binary")
    kw = dict(penalty=penalty, learning_rate=learning_rate, alpha=1e-3,
              eta0=0.05, max_iter=3, random_state=0)
    j, t = _fit_both("binary", X, y, **kw)
    _same_model(j, t, X)
    assert t.solver_info_ == {"streamed": True, "n_blocks": 8,
                              "fused_stream": True,
                              "fused_stream_reason": None}


@pytest.mark.parametrize("kind,loss,shuffle", [
    ("binary", "hinge", True), ("binary", "squared_error", True),
    ("multi", "log_loss", True), ("multi", "hinge", True),
    ("regression", "squared_error", True), ("binary", "log_loss", False),
    ("multi", "log_loss", False)])
@pytest.mark.parametrize("device", [False, True])
def test_fit_matches(kind, loss, shuffle, device):
    X, y = _data(kind, seed=1)
    kw = dict(loss=loss, penalty="elasticnet", alpha=1e-3, eta0=0.02,
              max_iter=2, random_state=3, shuffle=shuffle)
    j, t = _fit_both(kind, X, y, device=device, **kw)
    _same_model(j, t, X)
    assert t.solver_info_["streamed"] is not device


def test_memmap_fit_and_streamed_inference(tmp_path):
    """A memmap streams through BlockStream; decision values and
    probabilities of a memmap are the resident ones."""
    X, y = _data("multi", seed=2)
    path = str(tmp_path / "X.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)
    kw = dict(max_iter=2, random_state=0, learning_rate="constant", eta0=0.1)
    j, t = _fit_both("multi", mm, y, **kw)
    _same_model(j, t, X)
    assert t.stream_stats_["passes"] == 2
    with config.set(stream_block_rows=700):
        np.testing.assert_allclose(t.decision_function(mm),
                                   t.decision_function(X), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.predict_proba(mm), t.predict_proba(X),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.predict_proba(X),
                               _jax(lambda: j.predict_proba(X)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_block_orders_match_the_jax_stream(seed):
    """The port's stream shuffles its blocks in the JAX stream's order,
    pass after pass (one RandomState for the stream)."""
    n, rows = 1000, 125
    ids = np.repeat(np.arange(8, dtype=np.float32), rows)[:, None]
    y = np.zeros(n, np.float32)
    js = _jax(lambda: JBlockStream((ids, y), block_rows=rows, shuffle=True,
                                   seed=seed))
    ts = BlockStream((ids, y), block_rows=rows, shuffle=True, seed=seed)
    for _ in range(3):
        j_order = _jax(lambda: [int(np.asarray(b.arrays[0])[0, 0])
                                for b in js])
        t_order = [int(b.arrays[0][0, 0]) for b in ts.blocks()]
        assert t_order == j_order
        assert sorted(t_order) == list(range(8))
    t_explicit = [int(b.arrays[0][0, 0]) for b in ts.blocks([3, 3, 0])]
    assert t_explicit == [3, 3, 0]


@pytest.mark.parametrize("kind", ["binary", "multi", "regression"])
def test_partial_fit_matches(kind):
    X, y = _data(kind, seed=4)
    name = _cls(kind)
    kw = dict(alpha=1e-3, penalty="l1", eta0=0.05)
    extra = {"classes": np.unique(y)} if kind != "regression" else {}
    j = getattr(J, name)(**kw)
    t = getattr(T, name)(**kw)
    for lo in range(0, N, 1000):
        sl = slice(lo, lo + 1000)
        _jax(lambda: j.partial_fit(X[sl], y[sl], **extra))
        t.partial_fit(X[sl], y[sl], **extra)
        np.testing.assert_allclose(t.coef_, j.coef_, rtol=0, atol=COEF_ATOL)
    _same_model(j, t, X)
    assert isinstance(t._last_loss, torch.Tensor)
    np.testing.assert_allclose(float(t._last_loss), float(j._last_loss),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_warm_start_matches(kind):
    X, y = _data(kind, seed=6)
    kw = dict(max_iter=2, random_state=1, warm_start=True)
    j, t = _fit_both(kind, X, y, **kw)
    j = _jax(lambda: j.fit(X, y))
    t.fit(X, y)
    assert t._t == 2 * 2 * 8
    _same_model(j, t, X)


def test_score_and_proba():
    X, y = _data("binary", seed=7)
    j, t = _fit_both("binary", X, y, max_iter=2, random_state=0)
    # dask_ml_tpu's accuracy is a float32 mean
    np.testing.assert_allclose(t.score(X, y), _jax(lambda: j.score(X, y)),
                               rtol=1e-6)
    p = t.predict_proba(X)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(p, _jax(lambda: j.predict_proba(X)), rtol=0,
                               atol=1e-5)
    Xr, yr = _data("regression", seed=7)
    j, t = _fit_both("regression", Xr, yr, max_iter=2, random_state=0)
    np.testing.assert_allclose(t.score(Xr, yr), _jax(lambda: j.score(Xr, yr)),
                               rtol=1e-5)
    with pytest.raises(AttributeError, match="log_loss"):
        T.SGDClassifier(loss="hinge").fit(X, y).predict_proba(X)


def test_classes_errors():
    X, y = _data("binary", seed=8)
    with pytest.raises(ValueError, match="classes must be passed"):
        T.SGDClassifier().partial_fit(X, y)
    clf = T.SGDClassifier().partial_fit(X, y, classes=np.unique(y))
    with pytest.raises(ValueError, match="not the same as on last call"):
        clf.partial_fit(X, y, classes=np.array([0.0, 1.0]))
    with pytest.raises(ValueError, match="not passed via"):
        clf.partial_fit(X, np.where(y > 0, 7.0, -1.0))
    with pytest.raises(ValueError, match="not passed via"):
        clf.partial_fit(ShardedArray.from_array(X),
                        ShardedArray.from_array(np.where(y > 0, 7.0, -1.0)
                                                .astype(np.float32)))
    with pytest.raises(ValueError, match="at least 2 classes"):
        T.SGDClassifier().fit(X, np.ones(N, np.float32))
    Xm, ym = _data("multi", seed=8)
    m = T.SGDClassifier().partial_fit(Xm, ym, classes=np.unique(ym))
    with pytest.raises(ValueError, match="not passed via"):
        m.partial_fit(Xm, np.where(ym == 3, 4.0, ym))
    with pytest.raises(ValueError, match="not passed via"):
        m.partial_fit(ShardedArray.from_array(Xm), ShardedArray.from_array(
            np.where(ym == 3, 4.0, ym).astype(np.float32)))
    with pytest.raises(AttributeError, match="no classes"):
        T.SGDRegressor()._set_classes(np.array([0, 1]))
    for bad in (dict(loss="huber"), dict(penalty="l3"),
                dict(learning_rate="adaptive")):
        with pytest.raises(ValueError):
            T.SGDClassifier(**bad).fit(X, y)


def test_use_kernel_gate_and_no_ported_paths():
    X, y = _data("binary", seed=9)
    with config.set(use_kernel=False):
        t0 = T.SGDClassifier(max_iter=1, random_state=0).fit(X, y)
    assert t0.solver_info_["fused_stream"] is False
    assert t0.solver_info_["fused_stream_reason"] == "use_kernel=False"
    t1 = T.SGDClassifier(max_iter=1, random_state=0).fit(X, y)
    np.testing.assert_array_equal(t0.coef_, t1.coef_)
    fused.reset_launches()
    t1.partial_fit(X, y)
    # on CPU tensors the wrappers run their plain versions: no launch
    assert fused.launches()["fused_sgd_block_grad"] == 0
    import scipy.sparse as sp

    with pytest.raises(NotImplementedError, match="item 10"):
        T.SGDClassifier().fit(sp.csr_matrix(X), y)
    with pytest.raises(NotImplementedError, match="item 9"):
        T.SGDClassifier._streamed_cohort_round([t1], None, None, None)


@pytest.mark.parametrize("kind", ["binary", "multi", "regression"])
def test_convert_then_partial_fit_matches(kind):
    """A model fitted in dask_ml_tpu and carried across continues its
    partial_fit in the port with the JAX package's lr clock and
    weights."""
    X, y = _data(kind, seed=10)
    j = _jax(lambda: getattr(J, _cls(kind))(
        max_iter=2, random_state=0, learning_rate="invscaling",
        eta0=0.05).fit(X, y))
    t = convert.convert(j)
    assert type(t) is getattr(T, _cls(kind)) and t._t == j._t == 16
    _same_model(j, t, X)
    for lo in (0, 1500):
        sl = slice(lo, lo + 1500)
        j = _jax(lambda: j.partial_fit(X[sl], y[sl]))
        t.partial_fit(X[sl], y[sl])
    assert t._t == j._t == 18
    _same_model(j, t, X)
