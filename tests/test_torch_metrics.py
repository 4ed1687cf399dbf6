"""The port's metrics and scorers against dask_ml_tpu's, on the CPU.

Both packages get the same seeded host arrays (and the port also its own
ShardedArray of them). The JAX package reduces in float32, the port in
float64, so values agree to RTOL; counts, labels and curve shapes agree
exactly. Single-class folds warn with each package's
UndefinedMetricWarning (the port's is a UserWarning of its own).
"""

import warnings

import numpy as np
import pytest
import torch

import dask_ml_tpu.metrics as JM
from dask_ml_tpu.metrics import scorer as JS
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import metrics as TM
from dask_ml_tpu_torch.metrics import scorer as TS
from dask_ml_tpu_torch.parallel.sharded import ShardedArray

RTOL = 1e-5
N = 600


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _binary(seed=0, n=N):
    rng = np.random.RandomState(seed)
    t = (rng.rand(n) > 0.4).astype(np.float32)
    score = (t + rng.randn(n)).astype(np.float32)
    # ties: a block of equal scores across both classes
    score[:40] = 0.25
    pred = (score > 0.5).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return t, pred, score, w


def _multi(seed=1, n=N, C=4):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, C, n).astype(np.float32)
    pred = np.where(rng.rand(n) < 0.6, t, rng.randint(0, C, n)).astype(
        np.float32)
    proba = rng.rand(n, C).astype(np.float32) + np.eye(C)[t.astype(int)]
    proba /= proba.sum(1, keepdims=True)
    return t, pred, proba


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=1e-7)


def _sharded(a):
    return ShardedArray.from_array(torch.from_numpy(np.asarray(a)))


@pytest.mark.parametrize("name", ["accuracy_score", "precision_score",
                                  "recall_score", "f1_score",
                                  "balanced_accuracy_score"])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_label_metrics_match_jax(name, weighted):
    t, pred, _, w = _binary()
    kw = {"sample_weight": w} if weighted else {}
    ref = getattr(JM, name)(t, pred, **kw)
    _close(getattr(TM, name)(t, pred, **kw), ref)
    _close(getattr(TM, name)(_sharded(t), pred, **kw), ref)


@pytest.mark.parametrize("name", ["precision_score", "recall_score",
                                  "f1_score"])
@pytest.mark.parametrize("average", ["macro", "micro", "weighted", None])
def test_multiclass_averages_match_jax(name, average):
    t, pred, _ = _multi()
    _close(getattr(TM, name)(t, pred, average=average),
           getattr(JM, name)(t, pred, average=average))


def test_confusion_matrix_and_labels_match_jax():
    t, pred, _ = _multi()
    cm = TM.confusion_matrix(t, pred)
    assert cm.dtype == np.int64
    np.testing.assert_array_equal(cm, JM.confusion_matrix(t, pred))
    w = np.linspace(0.1, 2.0, N).astype(np.float32)
    _close(TM.confusion_matrix(t, pred, sample_weight=w),
           JM.confusion_matrix(t, pred, sample_weight=w))
    labels = np.arange(5)
    np.testing.assert_array_equal(
        TM.confusion_matrix(t, pred, labels=labels),
        JM.confusion_matrix(t, pred, labels=labels))
    _close(TM.balanced_accuracy_score(t, pred),
           JM.balanced_accuracy_score(t, pred))
    with pytest.raises(ValueError, match="not in labels"):
        TM.confusion_matrix(t, pred, labels=[0, 1])
    with pytest.raises(ValueError, match="pos_label"):
        TM.precision_score(t % 2 + 2, pred % 2 + 2)
    with pytest.raises(ValueError, match="binary"):
        TM.f1_score(t, pred)


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_metrics_match_jax(weighted):
    t, _, score, w = _binary()
    kw = {"sample_weight": w} if weighted else {}
    _close(TM.roc_auc_score(t, score, **kw),
           JM.roc_auc_score(t, score, **kw))
    _close(TM.average_precision_score(t, score, **kw),
           JM.average_precision_score(t, score, **kw))
    for name in ("roc_curve", "precision_recall_curve"):
        got = getattr(TM, name)(t, score, **kw)
        ref = getattr(JM, name)(t, score, **kw)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            _close(g, r)
    # (n, 2) probability columns and explicit positional labels
    proba = np.stack([1 - score, score], 1)
    _close(TM.roc_auc_score(t * 3 + 1, proba),
           JM.roc_auc_score(t * 3 + 1, proba))
    _close(TM.average_precision_score(t * 3 + 1, score, labels=[1, 4]),
           JM.average_precision_score(t * 3 + 1, score, labels=[1, 4]))
    _close(TM.roc_auc_score(_sharded(t), _sharded(score)),
           JM.roc_auc_score(t, score))


def test_single_class_folds_warn_or_raise_like_jax():
    _, _, score, _ = _binary()
    zeros = np.zeros(N, np.float32)
    with pytest.warns(TM.UndefinedMetricWarning, match="No positive"):
        ap = TM.average_precision_score(zeros, score)
    assert ap == 0.0
    with pytest.warns(JM.UndefinedMetricWarning):
        assert JM.average_precision_score(zeros, score) == 0.0
    with pytest.warns(TM.UndefinedMetricWarning, match="No positive"):
        fpr, tpr, thr = TM.roc_curve(zeros, score)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfpr, jtpr, jthr = JM.roc_curve(zeros, score)
    assert np.isnan(tpr).all() and np.isnan(jtpr).all()
    _close(fpr, jfpr)
    _close(thr[1:], jthr[1:])
    with pytest.warns(TM.UndefinedMetricWarning, match="No positive"):
        prec, rec, _ = TM.precision_recall_curve(zeros, score)
    assert rec[0] == 1.0 and prec[-1] == 1.0
    assert issubclass(TM.UndefinedMetricWarning, UserWarning)
    with pytest.raises(ValueError, match="Only one class"):
        TM.roc_auc_score(zeros, score)
    with pytest.raises(ValueError, match="ambiguous"):
        TM.average_precision_score(zeros + 2, score)
    with pytest.raises(ValueError, match="single class"):
        TM.log_loss(zeros, np.clip(score, 0.01, 0.99))
    # a fold whose y_true misses a class the model predicts still scores
    t, pred, _ = _multi()
    keep = t != 3
    _close(TM.f1_score(t[keep], pred[keep], average="macro"),
           JM.f1_score(t[keep], pred[keep], average="macro"))


def test_log_loss_matches_jax():
    t, _, score, w = _binary()
    p = 1 / (1 + np.exp(-score))
    _close(TM.log_loss(t, p), JM.log_loss(t, p))
    _close(TM.log_loss(t, p, sample_weight=w),
           JM.log_loss(t, p, sample_weight=w))
    _close(TM.log_loss(t * 10 + 10, np.stack([1 - p, p], 1)),
           JM.log_loss(t * 10 + 10, np.stack([1 - p, p], 1)))
    tm, _, proba = _multi()
    _close(TM.log_loss(tm, proba), JM.log_loss(tm, proba))
    keep = tm != 3
    _close(TM.log_loss(tm[keep], proba[keep], labels=[0, 1, 2, 3]),
           JM.log_loss(tm[keep], proba[keep], labels=[0, 1, 2, 3]))
    with pytest.raises(ValueError, match="labels"):
        TM.log_loss(tm[keep], proba[keep])


@pytest.mark.parametrize("name", [
    "mean_squared_error", "mean_absolute_error", "r2_score",
    "mean_squared_log_error", "explained_variance_score",
    "median_absolute_error"])
@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(name, weighted):
    rng = np.random.RandomState(3)
    t = rng.rand(N).astype(np.float32) * 4
    p = (t + 0.3 * rng.randn(N)).clip(0).astype(np.float32)
    kw = {"sample_weight": rng.rand(N).astype(np.float32)} if weighted \
        else {}
    ref = getattr(JM, name)(t, p, **kw)
    _close(getattr(TM, name)(t, p, **kw), ref, rtol=1e-4)
    _close(getattr(TM, name)(_sharded(t), _sharded(p), **kw), ref,
           rtol=1e-4)


def test_regression_edge_cases_match_jax():
    rng = np.random.RandomState(4)
    t = rng.randn(N).astype(np.float32)
    p = t + rng.randn(N).astype(np.float32)
    _close(TM.max_error(t, p), JM.max_error(t, p))
    _close(TM.mean_squared_error(t, p, squared=False),
           JM.mean_squared_error(t, p, squared=False))
    const = np.ones(N, np.float32)
    assert TM.r2_score(const, const) == JM.r2_score(const, const) == 1.0
    assert TM.r2_score(const, p) == JM.r2_score(const, p) == 0.0
    assert TM.explained_variance_score(const, const) == 1.0


def test_pairwise_match_jax():
    rng = np.random.RandomState(5)
    X = rng.randn(50, 6).astype(np.float32)
    Y = rng.randn(7, 6).astype(np.float32)
    for name in ("euclidean_distances", "manhattan_distances",
                 "cosine_distances", "linear_kernel", "rbf_kernel",
                 "polynomial_kernel", "sigmoid_kernel"):
        _close(getattr(TM, name)(X, Y).numpy(),
               np.asarray(getattr(JM, name)(X, Y)), rtol=2e-4)
    for metric in ("euclidean", "sqeuclidean", "l1", "cosine"):
        _close(TM.pairwise_distances(X, Y, metric=metric).numpy(),
               np.asarray(JM.pairwise_distances(X, Y, metric=metric)),
               rtol=2e-4)
    _close(TM.pairwise_kernels(X, Y, metric="rbf", gamma=0.3).numpy(),
           np.asarray(JM.pairwise_kernels(X, Y, metric="rbf", gamma=0.3)),
           rtol=2e-4)
    lab, dist = TM.pairwise_distances_argmin_min(_sharded(X), Y)
    jlab, jdist = JM.pairwise_distances_argmin_min(X, Y)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    _close(dist.numpy(), np.asarray(jdist), rtol=2e-4)
    np.testing.assert_array_equal(TM.pairwise_distances_argmin(X, Y).numpy(),
                                  np.asarray(jlab))
    assert TM.euclidean_distances(X).shape == (50, 50)
    with pytest.raises(ValueError, match="unsupported metric"):
        TM.pairwise_distances(X, Y, metric="hamming")


class _Clf:
    """A fitted binary classifier of known outputs."""

    classes_ = np.array([0.0, 1.0])

    def __init__(self, score):
        self._score = score

    def decision_function(self, X):
        return self._score[: len(X)]

    def predict(self, X):
        return (self.decision_function(X) > 0.5).astype(np.float32)

    def predict_proba(self, X):
        p = 1 / (1 + np.exp(-self.decision_function(X)))
        return np.stack([1 - p, p], 1)

    def score(self, X, y):
        return TM.accuracy_score(y, self.predict(X))


def test_scorers_match_jax():
    t, _, score, _ = _binary()
    X = np.zeros((N, 2), np.float32)
    est = _Clf(score)
    assert set(TS.SCORERS) == set(JS.SCORERS)
    for name in sorted(TS.SCORERS):
        if name in ("neg_mean_squared_log_error",):
            continue  # log of negative decision values: NaN in both
        got = TM.get_scorer(name)(est, X, t)
        ref = JM.get_scorer(name)(est, X, t)
        _close(got, ref, rtol=1e-4)
    assert TM.check_scoring(est) is TS._default_scorer
    _close(TM.check_scoring(est)(est, X, t), est.score(X, t))
    with pytest.raises(ValueError, match="not a valid scoring"):
        TM.get_scorer("nope")
    with pytest.raises(TypeError, match="no score method"):
        TM.check_scoring(object())

    def host_only(estimator, Xh, yh):
        if not isinstance(yh, np.ndarray):
            raise TypeError("host arrays only")
        return float(np.mean(yh))

    wrapped = TM.get_scorer(host_only)
    assert wrapped(est, _sharded(X), _sharded(t)) == pytest.approx(t.mean())
    TS.clear_host_fold_cache()
    assert not TS._HOST_FOLD_CACHE
