"""The port's Incremental and ParallelPostFit wrappers and the SGD
batched-trial protocol against dask_ml_tpu's, on the CPU.

dask_ml_tpu runs on one device (``stream_mesh=1`` and a one-device mesh,
as in tests/test_torch_sgd.py), so both packages cut the same blocks:
on host data ``fit_block_rows`` blocks through a BlockStream, on device
data the ``grid_partition`` blocks (dask_ml_tpu's ``_fused_epoch`` grid,
the port's views of X), in the order drawn from
``np.random.RandomState(random_state)``. The inner models agree to
COEF_ATOL (measured: 1e-6 or less) with equal step clocks.

The batched-trial step (``_batched_partial_fit``,
``_batched_fused_calls``: one launch of fused_sgd_many_block_grad with
``codes=False`` per step on the card) is held to N solo ``partial_fit``
chains over the same blocks (1e-6: the same per-row terms, summed in
another order) and to dask_ml_tpu's cohort scan (COEF_ATOL).
"""

import numpy as np
import pytest
import torch

import jax

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import wrappers as JW
from dask_ml_tpu.models import sgd as J
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu.parallel.sharded import ShardedArray as JShardedArray
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import wrappers as TW
from dask_ml_tpu_torch.models import sgd as T
from dask_ml_tpu_torch.parallel.sharded import ShardedArray

COEF_ATOL = 1e-5
N, D = 3000, 10


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
    with jconfig.set(stream_mesh=1), use_mesh(_mesh()):
        return fn()


def _data(kind, seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    if kind == "binary":
        return X, (X[:, 0] - X[:, 2] + 0.3 * rng.randn(n) > 0
                   ).astype(np.float32)
    if kind == "multi":
        return X, np.argmax(X[:, :3] + 0.5 * rng.randn(n, 3), 1
                            ).astype(np.float32)
    return X, (X @ rng.randn(D) + 0.1 * rng.randn(n)).astype(np.float32)


def _cls(kind):
    return "SGDRegressor" if kind == "regression" else "SGDClassifier"


def _same(j, t):
    np.testing.assert_allclose(t.coef_, j.coef_, rtol=0, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, rtol=0,
                               atol=COEF_ATOL)
    assert t._t == j._t


@pytest.mark.parametrize("kind", ["binary", "multi", "regression"])
@pytest.mark.parametrize("shuffle_blocks", [True, False])
@pytest.mark.parametrize("device", [False, True])
def test_incremental_matches(kind, shuffle_blocks, device):
    X, y = _data(kind, seed=1)
    kw = dict(alpha=1e-3, eta0=0.05, learning_rate="constant")
    inc = dict(shuffle_blocks=shuffle_blocks, random_state=2)
    if device:
        j = _jax(lambda: JW.Incremental(getattr(J, _cls(kind))(**kw), **inc)
                 .fit(JShardedArray.from_array(X, mesh=_mesh()),
                      JShardedArray.from_array(y, mesh=_mesh())))
        t = TW.Incremental(getattr(T, _cls(kind))(**kw), **inc).fit(
            ShardedArray.from_array(X), ShardedArray.from_array(y))
    else:
        j = _jax(lambda: JW.Incremental(getattr(J, _cls(kind))(**kw), **inc)
                 .fit(X, y))
        t = TW.Incremental(getattr(T, _cls(kind))(**kw), **inc).fit(X, y)
    _same(j.estimator_, t.estimator_)
    assert t.estimator_._t == 8
    if kind != "regression":
        np.testing.assert_array_equal(t.classes_, j.classes_)
        np.testing.assert_array_equal(t.predict(X),
                                      _jax(lambda: j.predict(X)))
    # a second pass continues the same inner model
    _jax(lambda: j.partial_fit(X, y))
    t.partial_fit(ShardedArray.from_array(X) if device else X,
                  ShardedArray.from_array(y) if device else y)
    _same(j.estimator_, t.estimator_)


def test_incremental_block_size_and_fused_epoch_order():
    X, y = _data("binary", seed=2, n=1001)
    assert TW.Incremental._block_size(X) == 126
    assert TW.Incremental._block_size(ShardedArray.from_array(X)) == 126
    # an explicit order on device data equals partial_fit on those blocks
    order = [7, 0, 7, 3]
    a = T.SGDClassifier(eta0=0.1)._fused_epoch(
        ShardedArray.from_array(X), y, order, n_blocks=8,
        classes=np.array([0.0, 1.0]))
    b = T.SGDClassifier(eta0=0.1)
    for blk in order:
        sl = slice(blk * 126, (blk + 1) * 126)
        b.partial_fit(X[sl], y[sl], classes=np.array([0.0, 1.0]))
    np.testing.assert_allclose(a.coef_, b.coef_, rtol=0, atol=1e-7)
    assert a._t == b._t == 4
    with pytest.raises(ValueError, match="partitioned into 5"):
        T.SGDClassifier()._fused_epoch(ShardedArray.from_array(X), y, [0],
                                       n_blocks=5, classes=[0.0, 1.0])


@pytest.mark.parametrize("device", [False, True])
def test_parallel_post_fit_matches(device):
    """Both packages fit the wrapped estimator on host data, device
    data copied there first (which decides the block orders of a
    shuffled fit over several epochs)."""
    X, y = _data("multi", seed=3)
    kw = dict(max_iter=3, random_state=0)
    if device:
        j = _jax(lambda: JW.ParallelPostFit(J.SGDClassifier(**kw)).fit(
            JShardedArray.from_array(X, mesh=_mesh()),
            JShardedArray.from_array(y, mesh=_mesh())))
        t = TW.ParallelPostFit(T.SGDClassifier(**kw)).fit(
            ShardedArray.from_array(X), ShardedArray.from_array(y))
        assert t.estimator_.solver_info_["streamed"]
    else:
        j = _jax(lambda: JW.ParallelPostFit(J.SGDClassifier(**kw)).fit(X, y))
        t = TW.ParallelPostFit(T.SGDClassifier(**kw)).fit(X, y)
    _same(j.estimator_, t.estimator_)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.predict(X), _jax(lambda: j.predict(X)))
    for method in ("predict_proba", "decision_function"):
        np.testing.assert_allclose(
            getattr(t, method)(X), _jax(lambda: getattr(j, method)(X)),
            rtol=0, atol=1e-5)
    # SGDClassifier has no predict_log_proba in either package: the
    # wrapper passes the estimator's AttributeError on
    with pytest.raises(AttributeError, match="predict_log_proba"):
        t.predict_log_proba(X)
    assert t.score(X, y) == pytest.approx(_jax(lambda: j.score(X, y)),
                                          rel=1e-6)
    pinned = TW.ParallelPostFit(T.SGDClassifier(**kw),
                                predict_meta=np.zeros(1, np.int32)).fit(X, y)
    assert pinned.predict(X).dtype == np.int32


@pytest.mark.parametrize("scoring", ["accuracy", "neg_log_loss",
                                     "roc_auc", "f1"])
def test_parallel_post_fit_scoring_matches(scoring):
    """score() through a named scorer of the metrics' table."""
    X, y = _data("binary", seed=4)
    kw = dict(max_iter=3, random_state=0)
    j = _jax(lambda: JW.ParallelPostFit(J.SGDClassifier(**kw),
                                        scoring=scoring).fit(X, y))
    t = TW.ParallelPostFit(T.SGDClassifier(**kw), scoring=scoring).fit(X, y)
    assert t.score(X, y) == pytest.approx(_jax(lambda: j.score(X, y)),
                                          rel=1e-5, abs=1e-6)


class _HostCenter:
    """A host estimator of another package (no port of its own): the
    wrappers run it block by block on host arrays."""

    def get_params(self, deep=True):
        return {}

    def fit(self, X, y=None):
        self.mean_ = np.asarray(X).mean(0)
        return self

    def transform(self, X):
        assert isinstance(X, np.ndarray)
        return X - self.mean_

    def predict(self, X):
        return (X.sum(1) > 0).astype(np.float32)


def test_parallel_post_fit_host_estimator():
    X, y = _data("binary", seed=4, n=250_001)
    p = TW.ParallelPostFit(_HostCenter()).fit(ShardedArray.from_array(X))
    np.testing.assert_allclose(p.transform(X), X - X.mean(0), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(p.predict(ShardedArray.from_array(X)),
                                  (X.sum(1) > 0).astype(np.float32))
    assert TW._is_device_estimator(T.SGDClassifier())
    assert not TW._is_device_estimator(_HostCenter())
    assert not TW._is_device_estimator(J.SGDClassifier())
    impostor = type("SGDClassifier", (), {"__module__":
                                          "dask_ml_tpu_torchx.models"})()
    assert not TW._is_device_estimator(impostor)


def _cohort(kind):
    """Four models of one batch key with their own alpha, eta0, penalty,
    schedule and intercept flag."""
    name = _cls(kind)
    settings = [dict(alpha=1e-4, eta0=0.05, penalty="l2"),
                dict(alpha=1e-2, eta0=0.02, penalty="l1",
                     learning_rate="constant"),
                dict(alpha=3e-3, eta0=0.1, penalty="elasticnet",
                     fit_intercept=False),
                dict(alpha=1e-3, penalty=None, learning_rate="optimal")]
    mods = []
    for pkg in (J, T):
        ms = [getattr(pkg, name)(**s) for s in settings]
        for m in ms:
            m._batch_prepare({"classes": np.array([0.0, 1.0])}
                             if kind == "binary" else {})
        mods.append(ms)
    return mods


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_batched_fused_calls_match_solo_chains(kind):
    X, y = _data(kind, seed=5, n=2000)
    blocks = [(X[lo:lo + 450], y[lo:lo + 450]) for lo in range(0, 2000, 450)]
    order = [0, 4, 1, 4, 2, 3]           # ragged block 4 visited twice
    jm, tm = _cohort(kind)
    assert len({m._batch_key() for m in tm}) == 1
    _jax(lambda: type(jm[0])._batched_fused_calls(jm, blocks, order))
    type(tm[0])._batched_fused_calls(tm, blocks, order)
    type(tm[0])._batch_publish(tm, D)
    solo = _cohort(kind)[1]
    for m in solo:
        for b in order:
            m.partial_fit(*blocks[b])
    for j, t, s in zip(jm, tm, solo):
        j._publish(D)
        _same(j, t)
        np.testing.assert_allclose(t.coef_, s.coef_, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.intercept_, s.intercept_, rtol=0,
                                   atol=1e-6)
        assert t._t == s._t == 6
    # the cohort's scores on a shared split, one product
    cls = type(tm[0])
    np.testing.assert_allclose(
        cls._batched_score_default(tm, X, y),
        _jax(lambda: type(jm[0])._batched_score_default(jm, X, y)),
        rtol=1e-5)
    np.testing.assert_allclose(cls._batched_score_default(tm, X, y),
                               [m.score(X, y) for m in tm], rtol=1e-5)


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_batched_partial_fit_matches(kind):
    X, y = _data(kind, seed=6, n=1500)
    jm, tm = _cohort(kind)
    for lo in (0, 700):
        _jax(lambda: type(jm[0])._batched_partial_fit(jm, X[lo:lo + 800],
                                                      y[lo:lo + 800]))
        type(tm[0])._batched_partial_fit(tm, X[lo:lo + 800], y[lo:lo + 800])
    for j, t in zip(jm, tm):
        j._publish(D)
        t._publish(D)
        _same(j, t)
        assert isinstance(t._last_loss, torch.Tensor)
        np.testing.assert_allclose(float(t._last_loss), float(j._last_loss),
                                   rtol=1e-5)


def test_batch_keys():
    a = T.SGDClassifier(alpha=1e-3)
    b = T.SGDClassifier(alpha=1e-1, penalty="l1", eta0=1.0)
    assert a._batch_key() is None                  # no classes yet
    for m in (a, b):
        m._batch_prepare({"classes": np.array([0, 1])})
    assert a._batch_key() == b._batch_key() is not None
    c = T.SGDClassifier()
    c._batch_prepare({"classes": np.array([0, 1, 2])})
    assert c._batch_key() is None                  # multiclass: solo
    assert T.SGDClassifier(penalty="l3")._batch_key() is None
    assert T.SGDRegressor()._batch_key() != T.SGDRegressor(
        fit_dtype="bfloat16")._batch_key()


def test_not_ported_paths_raise():
    X, y = _data("binary", seed=7, n=100)
    inc = TW.Incremental(T.SGDClassifier())
    # pass checkpoints are ported: with config.stream_checkpoint_path
    # unset there is nothing to resume (tests/test_torch_checkpoint.py
    # kills and resumes a pass loop)
    assert inc.resume_from_checkpoint(X, y) == 0
    assert not hasattr(inc, "estimator_")
    with pytest.raises(NotImplementedError,
                       match="queue 1, Execution and serving"):
        TW.compiled_batch_fn(inc)
    import scipy.sparse as sp

    # a sparse X is ported: the pass streams its nonzeros through the
    # same blocks and steps as the dense rows'
    s = TW.Incremental(T.SGDClassifier(), random_state=0).fit(
        sp.csr_matrix(X), y)
    d = TW.Incremental(T.SGDClassifier(), random_state=0).fit(X, y)
    np.testing.assert_allclose(s.estimator_.coef_, d.estimator_.coef_,
                               atol=1e-6)
    with pytest.raises(ValueError, match="no partial_fit"):
        TW.Incremental(_HostCenter()).fit(X, y)


def test_convert_incremental_then_continue():
    X, y = _data("binary", seed=8)
    kw = dict(alpha=1e-3, eta0=0.05)
    j = _jax(lambda: JW.Incremental(J.SGDClassifier(**kw), random_state=0)
             .fit(X, y))
    t = convert.convert(j)
    assert type(t) is TW.Incremental and type(t.estimator) is T.SGDClassifier
    assert t.estimator.get_params() == T.SGDClassifier(**kw).get_params()
    _same(j.estimator_, t.estimator_)
    _jax(lambda: j.partial_fit(X, y))
    t.partial_fit(X, y)
    _same(j.estimator_, t.estimator_)
    p = convert.convert(_jax(lambda: JW.ParallelPostFit(
        J.SGDRegressor(max_iter=1, random_state=0)).fit(X, y)))
    assert type(p) is TW.ParallelPostFit and p.estimator_._t == 8
