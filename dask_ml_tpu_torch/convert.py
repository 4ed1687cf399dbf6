"""Carry fitted parameters across to the port.

A fitted estimator is described by its class name, its constructor
parameters and a dict of fitted attributes as plain numpy (``coef_``,
``intercept_``, ``classes_``, ``cluster_centers_``, ``n_iter_``, ...).
:func:`export_fitted` reads that description off any estimator with the
sklearn attribute contract — a fitted ``dask_ml_tpu`` estimator
included — by attribute access alone; :func:`from_fitted` builds the
fitted port estimator from it. Nothing here imports the JAX package, so
a model fitted there can be served here, and the tests can hand both
packages the same model.
"""

from __future__ import annotations

import numpy as np

from .models.glm import LinearRegression, LogisticRegression, PoissonRegression
from .models.kmeans import KMeans
from .parallel.sharded import ShardedArray

_GLM_FITTED = ("coef_", "intercept_", "n_iter_", "n_features_in_",
               "fit_dtype_")

ESTIMATORS = {
    "LogisticRegression": (LogisticRegression, _GLM_FITTED + ("classes_",)),
    "LinearRegression": (LinearRegression, _GLM_FITTED),
    "PoissonRegression": (PoissonRegression, _GLM_FITTED),
    "KMeans": (KMeans, ("cluster_centers_", "labels_", "inertia_",
                        "n_iter_", "n_features_in_", "fit_dtype_")),
}


def _plain(value):
    """A fitted attribute as numpy or a Python scalar: row containers
    (anything with ``to_numpy``) and arrays become numpy arrays."""
    if hasattr(value, "to_numpy"):
        return np.array(value.to_numpy())
    if isinstance(value, (str, int, float)) or value is None:
        return value
    return np.array(value)


def export_fitted(est) -> dict:
    """{"name", "params", "fitted"} of a fitted estimator, plain data."""
    name = type(est).__name__
    if name not in ESTIMATORS:
        raise ValueError(f"no port of {name}; ported: {sorted(ESTIMATORS)}")
    cls, attrs = ESTIMATORS[name]
    own = set(cls._get_param_names())
    params = {k: v for k, v in est.get_params(deep=False).items()
              if k in own}
    fitted = {a: _plain(getattr(est, a)) for a in attrs if hasattr(est, a)}
    return {"name": name, "params": params, "fitted": fitted}


def from_fitted(name, fitted, params=None):
    """The fitted port estimator of class ``name`` with the given
    constructor ``params`` and ``fitted`` attributes."""
    if name not in ESTIMATORS:
        raise ValueError(f"no port of {name}; ported: {sorted(ESTIMATORS)}")
    cls, attrs = ESTIMATORS[name]
    est = cls(**(params or {}))
    for a in attrs:
        if a not in fitted:
            continue
        v = fitted[a]
        if a == "labels_":
            v = ShardedArray.from_array(np.asarray(v, np.int32))
        elif isinstance(v, np.ndarray) and v.ndim == 0:
            v = v.item()
        setattr(est, a, v)
    return est


def convert(est):
    """A fitted port estimator holding ``est``'s parameters."""
    return from_fitted(**export_fitted(est))
