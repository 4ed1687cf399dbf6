"""The metrics the estimators' ``score`` methods call.

Counterparts of ``dask_ml_tpu/metrics/classification.py::accuracy_score``
and ``regression.py::r2_score``, computed on the host: the predictions
they score are host arrays already.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import ShardedArray


def _host(a):
    if isinstance(a, ShardedArray):
        return a.to_numpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _canon(y_true, y_pred, sample_weight):
    t, p = _host(y_true), _host(y_pred)
    w = np.ones(t.shape[0]) if sample_weight is None \
        else _host(sample_weight).astype(np.float64)
    return t, p, w


def accuracy_score(y_true, y_pred, normalize=True, sample_weight=None):
    t, p, w = _canon(y_true, y_pred, sample_weight)
    hits = float(((t == p) * w).sum())
    return hits / float(w.sum()) if normalize else hits


def r2_score(y_true, y_pred, sample_weight=None):
    """1 - SS_res / SS_tot, with scikit-learn's force_finite rule for a
    constant target: 1.0 for a perfect fit, else 0.0."""
    t, p, w = _canon(y_true, y_pred, sample_weight)
    t, p = t.astype(np.float64), p.astype(np.float64)
    mean = (t * w).sum() / w.sum()
    ss_res = float((((t - p) ** 2) * w).sum())
    ss_tot = float((((t - mean) ** 2) * w).sum())
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


__all__ = ["accuracy_score", "r2_score"]
