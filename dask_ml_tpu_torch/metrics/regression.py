"""Regression metrics. Counterpart of
``dask_ml_tpu/metrics/regression.py``: float64 reductions on the data's
device, host floats out."""

from __future__ import annotations

import numpy as np
import torch

from .classification import _canon, _f64


def _pair(y_true, y_pred, sample_weight=None):
    t, p, w, _ = _canon(y_true, y_pred, sample_weight)
    return _f64(t), _f64(p), w


def mean_squared_error(y_true, y_pred, sample_weight=None, squared=True):
    t, p, w = _pair(y_true, y_pred, sample_weight)
    mse = (((t - p) ** 2) * w).sum() / w.sum()
    return float(mse if squared else mse.sqrt())


def mean_absolute_error(y_true, y_pred, sample_weight=None):
    t, p, w = _pair(y_true, y_pred, sample_weight)
    return float(((t - p).abs() * w).sum() / w.sum())


def _force_finite_ratio(num, den):
    """1 - num/den with scikit-learn's force_finite rule: a constant
    target scores 1.0 for a perfect fit and 0.0 otherwise."""
    num, den = float(num), float(den)
    if den == 0.0:
        return 1.0 if num == 0.0 else 0.0
    return 1.0 - num / den


def r2_score(y_true, y_pred, sample_weight=None):
    t, p, w = _pair(y_true, y_pred, sample_weight)
    mean = (t * w).sum() / w.sum()
    ss_res = (((t - p) ** 2) * w).sum()
    ss_tot = (((t - mean) ** 2) * w).sum()
    return _force_finite_ratio(ss_res, ss_tot)


def mean_squared_log_error(y_true, y_pred, sample_weight=None):
    t, p, w = _pair(y_true, y_pred, sample_weight)
    err = (torch.log1p(t) - torch.log1p(p)) ** 2
    return float((err * w).sum() / w.sum())


def explained_variance_score(y_true, y_pred, sample_weight=None):
    t, p, w = _pair(y_true, y_pred, sample_weight)
    wsum = w.sum()
    err = t - p
    err_mean = (err * w).sum() / wsum
    var_err = (((err - err_mean) ** 2) * w).sum() / wsum
    t_mean = (t * w).sum() / wsum
    var_t = (((t - t_mean) ** 2) * w).sum() / wsum
    return _force_finite_ratio(var_err, var_t)


def max_error(y_true, y_pred):
    """Largest absolute residual (scikit-learn takes no sample_weight)."""
    t, p, _ = _pair(y_true, y_pred)
    return float((t - p).abs().max())


def median_absolute_error(y_true, y_pred, sample_weight=None):
    """Median of |err| by scikit-learn's two rules: unweighted, the
    middle-two average; weighted, the first sorted error whose cumulative
    weight reaches half the total. One device sort, host prefix sums."""
    t, p, w = _pair(y_true, y_pred, sample_weight)
    err = (t - p).abs()
    order = torch.argsort(err, stable=True)
    es = err[order].cpu().numpy()
    if sample_weight is None:
        return float(np.median(es))
    cw = np.cumsum(w[order].cpu().numpy())
    return float(es[int(np.argmax(cw >= 0.5 * cw[-1]))])
