"""GaussianNB on the device.

Counterpart of ``dask_ml_tpu/naive_bayes.py``: the same parameters and
fitted attributes. The per-class count, sum and sum of squares are one
product pair with the one-hot class matrix (the order of the sums is
fixed, where a scatter-add on CUDA adds in another order on every run);
the variance is JAX's f32 ``E[x²] − mean²``, floored at 0, plus
``var_smoothing`` times the largest feature variance.

``partial_fit`` folds each block into device-resident running sums, one
product pair a block, and publishes ``theta_``, ``var_``,
``class_prior_`` and ``class_count_`` lazily on first read, so a stream
of blocks never waits on the host. The JAX package pads blocks up a
shape ladder to amortise XLA compiles (``plans``); nothing here
compiles, so blocks go in at their own height. A pickled estimator
carries its running sums as numpy and goes on with ``partial_fit``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseEstimator, ClassifierMixin, log_proba, to_host
from .config import resolve_device
from .metrics import accuracy_score
from .ops.reductions import masked_mean_var
from .parallel.sharded import ShardedArray
from .parallel.streaming import _is_sparse_source, _slice_dense
from .utils.validation import check_array, check_is_fitted, check_X_y

__all__ = ["GaussianNB"]

# the fitted attributes published lazily from the running sums
_NB_STAT_ATTRS = ("theta_", "var_", "class_prior_", "class_count_")


def _class_sums(X, codes, mask, k):
    """(count (k,), Σ x (k, d), Σ x² (k, d)) of the rows by class code:
    one product pair with the (k, n) one-hot matrix, padding masked."""
    cm = (codes[None, :] == torch.arange(k, dtype=X.dtype,
                                         device=X.device)[:, None]) \
        .to(X.dtype) * mask[None, :]
    return cm.sum(1), cm @ X, cm @ (X * X)


def _jll_math(X, theta, var, log_prior):
    """The joint log-likelihood (n, k): -0.5 Σ (x - μ)² / σ² - 0.5 Σ
    log 2πσ² + log prior, expanded into products as the JAX package
    does."""
    prec = 1.0 / var
    x2 = (X * X) @ prec.T
    xm = X @ (theta * prec).T
    m2 = (theta * theta * prec).sum(1)
    quad = x2 - 2.0 * xm + m2[None, :]
    logdet = torch.log(2.0 * np.pi * var).sum(1)
    return -0.5 * (quad + logdet[None, :]) + log_prior[None, :]


class GaussianNB(ClassifierMixin, BaseEstimator):
    """Ref: dask_ml/naive_bayes.py::GaussianNB."""

    def __init__(self, priors=None, var_smoothing=1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing

    def fit(self, X, y):
        X, y = check_X_y(X, y, dtype=np.float32)
        mask = X.row_mask(X.dtype)
        classes = np.unique(to_host(y))
        codes = torch.searchsorted(
            torch.as_tensor(classes, dtype=X.dtype, device=X.device), y.data)
        counts, sums, sq = _class_sums(X.data, codes.to(X.dtype), mask,
                                       len(classes))
        c = counts.clamp_min(1.0)[:, None]
        means = sums / c
        var = (sq / c - means ** 2).clamp_min(0.0)
        _, gvar = masked_mean_var(X.data, mask, X.n_rows)
        eps = self.var_smoothing * float(gvar.max())
        self.__dict__.pop("_stats_", None)
        self.classes_ = classes
        self.class_count_ = to_host(counts).astype(np.float64)
        self.theta_ = to_host(means).astype(np.float64)
        self.var_ = to_host(var).astype(np.float64) + eps
        if self.priors is not None:
            self.class_prior_ = np.asarray(self.priors, np.float64)
        else:
            self.class_prior_ = self.class_count_ / self.class_count_.sum()
        self.n_features_in_ = X.shape[1]
        return self

    def partial_fit(self, X, y, classes=None):
        """Fold one block of rows into the running per-class sums on the
        device (the streamed fit ``Incremental(GaussianNB())`` drives)."""
        if isinstance(X, ShardedArray):
            X = X.data[: X.n_rows]
        elif _is_sparse_source(X):
            # the one sparse/dense coercion point of a block (the JAX
            # package densifies it too)
            X = _slice_dense(X, 0, int(X.shape[0]), np.float32)
        if isinstance(X, torch.Tensor):
            Xd = X.to(torch.float32)
        else:
            Xd = torch.as_tensor(np.asarray(X, np.float32),
                                 device=resolve_device())
        if Xd.ndim == 1:
            Xd = Xd[None, :]
        yh = np.asarray(to_host(y)).ravel()
        if self.__dict__.get("_stats_") is None:
            if classes is None:
                raise ValueError(
                    "classes= is required on the first partial_fit"
                )
            self.classes_ = np.unique(np.asarray(classes))
            k, d = len(self.classes_), int(Xd.shape[1])
            self._stats_ = tuple(torch.zeros(s, device=Xd.device)
                                 for s in ((k,), (k, d), (k, d)))
            self.n_features_in_ = d
        if Xd.shape[1] != self.n_features_in_:
            raise ValueError(
                f"block has {Xd.shape[1]} features; this fit started "
                f"with {self.n_features_in_}"
            )
        k = len(self.classes_)
        idx = np.searchsorted(self.classes_, yh)
        ok = (idx < k) & (self.classes_[np.minimum(idx, k - 1)] == yh)
        if not np.all(ok):
            raise ValueError(
                f"y contains labels outside classes= "
                f"({np.asarray(yh)[~ok][:3]!r} ...)"
            )
        # running sums restored from a pickle come back as numpy
        self._stats_ = tuple(torch.as_tensor(a, device=Xd.device)
                             for a in self._stats_)
        dev = Xd.device
        codes = torch.as_tensor(idx.astype(np.float32), device=dev)
        ones = torch.ones(Xd.shape[0], device=dev)
        block = _class_sums(Xd, codes, ones, k)
        self._stats_ = tuple(a + b for a, b in zip(self._stats_, block))
        for a in _NB_STAT_ATTRS:
            self.__dict__.pop(a, None)
        return self

    def __getattr__(self, name):
        # fitted statistics publish on first read after a partial_fit
        if name in _NB_STAT_ATTRS \
                and self.__dict__.get("_stats_") is not None:
            self._publish_from_stats()
            return self.__dict__[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    def __getstate__(self):
        # the published view, and the running sums as host numpy (the
        # next partial_fit places them on its block's device)
        if self.__dict__.get("_stats_") is not None:
            self._publish_from_stats()
        state = dict(self.__dict__)
        st = state.get("_stats_")
        if st is not None:
            state["_stats_"] = tuple(to_host(a) for a in st)
        return state

    def _publish_from_stats(self):
        counts, sums, sqs = (to_host(a).astype(np.float64)
                             for a in self._stats_)
        tot = max(float(counts.sum()), 1.0)
        means = sums / np.maximum(counts[:, None], 1.0)
        var = np.maximum(
            sqs / np.maximum(counts[:, None], 1.0) - means ** 2, 0.0
        )
        gmean = sums.sum(axis=0) / tot
        gvar = np.maximum(sqs.sum(axis=0) / tot - gmean ** 2, 0.0)
        eps = self.var_smoothing * float(np.max(gvar)) \
            if gvar.size else 0.0
        self.class_count_ = counts
        self.theta_ = means
        self.var_ = var + eps
        if self.priors is not None:
            self.class_prior_ = np.asarray(self.priors, np.float64)
        else:
            self.class_prior_ = counts / tot

    def _jll(self, X):
        X = check_array(X, dtype=np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=X.dtype,
                                   device=X.device)

        return X, _jll_math(X.data, dev(self.theta_), dev(self.var_),
                            dev(np.log(self.class_prior_)))

    def predict(self, X):
        check_is_fitted(self, "theta_")
        X, jll = self._jll(X)
        return self.classes_[to_host(jll.argmax(1))[: X.n_rows]]

    def predict_proba(self, X):
        check_is_fitted(self, "theta_")
        X, jll = self._jll(X)
        return to_host(torch.softmax(jll, dim=1))[: X.n_rows]

    def predict_log_proba(self, X):
        return log_proba(self.predict_proba(X))

    def score(self, X, y):
        return accuracy_score(np.asarray(to_host(y)), self.predict(X))
