"""Scorers: SCORERS, get_scorer, check_scoring. Counterpart of
``dask_ml_tpu/metrics/scorer.py``: the same names and scorer rules,
working on host arrays, tensors and ShardedArrays."""

from __future__ import annotations

import collections
import threading

import numpy as np

from .classification import (accuracy_score, average_precision_score,
                             balanced_accuracy_score, f1_score, log_loss,
                             precision_score, recall_score, roc_auc_score)
from .regression import (explained_variance_score, max_error,
                         mean_absolute_error, mean_squared_error,
                         mean_squared_log_error, median_absolute_error,
                         r2_score)


class _MetricScorer:
    """A picklable scorer (fitted searches keep ``scorer_``).

    ``needs_threshold``: score continuous outputs, ``decision_function``
    first and ``predict_proba`` as the fallback. ``forward_labels``: pass
    ``labels=estimator.classes_``, so a fold missing a class still
    scores."""

    def __init__(self, metric, sign, needs_proba, needs_threshold=False,
                 forward_labels=False, kwargs=None):
        self.metric = metric
        self.sign = sign
        self.needs_proba = needs_proba
        self.needs_threshold = needs_threshold
        self.forward_labels = forward_labels
        self.kwargs = kwargs or {}

    def __call__(self, estimator, X, y):
        kw = dict(self.kwargs)
        classes = getattr(estimator, "classes_", None)
        if (self.needs_proba or self.forward_labels) and classes is not None:
            kw["labels"] = np.asarray(classes)
        if self.needs_proba:
            pred = estimator.predict_proba(X)
        elif self.needs_threshold:
            try:
                pred = estimator.decision_function(X)
            except (AttributeError, NotImplementedError):
                pred = estimator.predict_proba(X)
        else:
            pred = estimator.predict(X)
        return self.sign * self.metric(y, pred, **kw)


def _make_scorer(metric, greater_is_better=True, needs_proba=False,
                 needs_threshold=False, forward_labels=False, **kwargs):
    return _MetricScorer(metric, 1.0 if greater_is_better else -1.0,
                         needs_proba, needs_threshold, forward_labels, kwargs)


SCORERS = {
    "accuracy": _make_scorer(accuracy_score),
    "neg_mean_squared_error": _make_scorer(mean_squared_error,
                                           greater_is_better=False),
    "neg_mean_absolute_error": _make_scorer(mean_absolute_error,
                                            greater_is_better=False),
    "neg_root_mean_squared_error": _make_scorer(
        mean_squared_error, greater_is_better=False, squared=False),
    "neg_mean_squared_log_error": _make_scorer(
        mean_squared_log_error, greater_is_better=False),
    "neg_median_absolute_error": _make_scorer(
        median_absolute_error, greater_is_better=False),
    "explained_variance": _make_scorer(explained_variance_score),
    "max_error": _make_scorer(max_error, greater_is_better=False),
    "neg_log_loss": _make_scorer(log_loss, greater_is_better=False,
                                 needs_proba=True),
    "r2": _make_scorer(r2_score),
    "roc_auc": _make_scorer(roc_auc_score, needs_threshold=True,
                            forward_labels=True),
    "average_precision": _make_scorer(average_precision_score,
                                      needs_threshold=True,
                                      forward_labels=True),
    "balanced_accuracy": _make_scorer(balanced_accuracy_score,
                                      forward_labels=True),
    "f1": _make_scorer(f1_score, forward_labels=True),
    "f1_macro": _make_scorer(f1_score, forward_labels=True,
                             average="macro"),
    "f1_micro": _make_scorer(f1_score, forward_labels=True,
                             average="micro"),
    "f1_weighted": _make_scorer(f1_score, forward_labels=True,
                                average="weighted"),
    "precision": _make_scorer(precision_score, forward_labels=True),
    "precision_macro": _make_scorer(precision_score, forward_labels=True,
                                    average="macro"),
    "precision_micro": _make_scorer(precision_score, forward_labels=True,
                                    average="micro"),
    "precision_weighted": _make_scorer(precision_score,
                                       forward_labels=True,
                                       average="weighted"),
    "recall": _make_scorer(recall_score, forward_labels=True),
    "recall_macro": _make_scorer(recall_score, forward_labels=True,
                                 average="macro"),
    "recall_micro": _make_scorer(recall_score, forward_labels=True,
                                 average="micro"),
    "recall_weighted": _make_scorer(recall_score, forward_labels=True,
                                    average="weighted"),
}


# host copies of recently scored device folds, keyed by id, the fold
# pinned in the value so a reused id cannot alias a stale copy; bounded
# by bytes and evicted oldest first. Searches score from worker threads.
_HOST_FOLD_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_HOST_FOLD_CACHE_MAX_BYTES = 256 * 1024 * 1024
_HOST_FOLD_CACHE_LOCK = threading.Lock()


def _on_device(a):
    import torch

    from ..parallel.sharded import ShardedArray

    return isinstance(a, (ShardedArray, torch.Tensor))


def _to_host_cached(a):
    from ..base import to_host

    key = id(a)
    with _HOST_FOLD_CACHE_LOCK:
        hit = _HOST_FOLD_CACHE.get(key)
        if hit is not None and hit[0] is a:
            _HOST_FOLD_CACHE.move_to_end(key)
            return hit[1]
    h = to_host(a)
    with _HOST_FOLD_CACHE_LOCK:
        _HOST_FOLD_CACHE[key] = (a, h)
        total = sum(v[1].nbytes for v in _HOST_FOLD_CACHE.values())
        while total > _HOST_FOLD_CACHE_MAX_BYTES and len(_HOST_FOLD_CACHE) > 1:
            _, (_, ev) = _HOST_FOLD_CACHE.popitem(last=False)
            total -= ev.nbytes
    return h


def clear_host_fold_cache():
    """Drop every pinned fold copy; a search calls this when it ends."""
    with _HOST_FOLD_CACHE_LOCK:
        _HOST_FOLD_CACHE.clear()


class _HostAdaptingScorer:
    """Wrap an external scorer callable: the raw call first; if it
    rejects device folds (a host-only scorer's validation raises), again
    with host copies of them."""

    def __init__(self, scorer):
        self.scorer = scorer

    def __call__(self, estimator, X, y=None, **kwargs):
        on_device = _on_device(X) or _on_device(y)
        try:
            return self.scorer(estimator, X, y, **kwargs)
        except (ValueError, TypeError, AttributeError):
            if not on_device:
                raise
        Xh = _to_host_cached(X) if _on_device(X) else X
        yh = _to_host_cached(y) if _on_device(y) else y
        return self.scorer(estimator, Xh, yh, **kwargs)


def get_scorer(scoring, compute=True):
    if callable(scoring):
        return _HostAdaptingScorer(scoring)
    try:
        return SCORERS[scoring]
    except KeyError:
        raise ValueError(
            f"{scoring!r} is not a valid scoring value; options: "
            f"{sorted(SCORERS)}"
        ) from None


def _default_scorer(estimator, X, y):
    """The estimator's own ``score`` (module level, so picklable)."""
    return estimator.score(X, y)


def check_scoring(estimator, scoring=None, **kwargs):
    if scoring is None:
        if not hasattr(estimator, "score"):
            raise TypeError(
                f"estimator {estimator!r} has no score method; pass scoring="
            )
        return _default_scorer
    return get_scorer(scoring)
