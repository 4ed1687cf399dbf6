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

The decomposition estimators carry their components, spectrum and mean;
an ``IncrementalPCA`` also carries ``n_samples_seen_``, and a
``partial_fit`` continued in the port rebuilds its device state from
them. The SGD estimators also carry their step clock ``_t``, and their weights
are rebuilt from ``coef_``/``intercept_`` on ``config.device``, so a
``partial_fit`` continued in the port takes the lr the JAX package would.
The wrappers (``Incremental``, ``ParallelPostFit``) carry their own
parameters, the wrapped estimator's class and parameters, and their
fitted ``estimator_``.
"""

from __future__ import annotations

import numpy as np

from .models.glm import LinearRegression, LogisticRegression, PoissonRegression
from .models.kmeans import KMeans
from .models.pca import PCA, IncrementalPCA, TruncatedSVD
from .models.sgd import SGDClassifier, SGDRegressor
from .parallel.sharded import ShardedArray
from .wrappers import Incremental, ParallelPostFit

_GLM_FITTED = ("coef_", "intercept_", "n_iter_", "n_features_in_",
               "fit_dtype_")
_SGD_FITTED = _GLM_FITTED + ("_t",)
_SVD_FITTED = ("components_", "explained_variance_",
               "explained_variance_ratio_", "singular_values_",
               "n_features_in_")
_PCA_FITTED = _SVD_FITTED + ("mean_", "noise_variance_", "n_components_",
                             "n_samples_", "fit_dtype_")

ESTIMATORS = {
    "LogisticRegression": (LogisticRegression, _GLM_FITTED + ("classes_",)),
    "LinearRegression": (LinearRegression, _GLM_FITTED),
    "PoissonRegression": (PoissonRegression, _GLM_FITTED),
    "KMeans": (KMeans, ("cluster_centers_", "labels_", "inertia_",
                        "n_iter_", "n_features_in_", "fit_dtype_")),
    "SGDClassifier": (SGDClassifier, _SGD_FITTED + ("classes_",)),
    "SGDRegressor": (SGDRegressor, _SGD_FITTED),
    "PCA": (PCA, _PCA_FITTED),
    "TruncatedSVD": (TruncatedSVD, _SVD_FITTED),
    "IncrementalPCA": (IncrementalPCA, _PCA_FITTED + ("n_samples_seen_",)),
}
WRAPPERS = {"Incremental": Incremental, "ParallelPostFit": ParallelPostFit}


def _plain(value):
    """A fitted attribute as numpy or a Python scalar: row containers
    (anything with ``to_numpy``) and arrays become numpy arrays."""
    if hasattr(value, "to_numpy"):
        return np.array(value.to_numpy())
    if isinstance(value, (str, int, float)) or value is None:
        return value
    return np.array(value)


def _ported(name):
    if name not in ESTIMATORS and name not in WRAPPERS:
        raise ValueError(f"no port of {name}; ported: "
                         f"{sorted(ESTIMATORS) + sorted(WRAPPERS)}")


def _own_params(est, cls):
    own = set(cls._get_param_names())
    return {k: v for k, v in est.get_params(deep=False).items() if k in own}


def export_fitted(est) -> dict:
    """{"name", "params", "fitted"} of a fitted estimator, plain data.
    A wrapper's ``params["estimator"]`` is the wrapped estimator's
    {"name", "params"} and its ``fitted["estimator_"]`` the export of its
    fitted estimator."""
    name = type(est).__name__
    _ported(name)
    if name in WRAPPERS:
        params = _own_params(est, WRAPPERS[name])
        inner = params.pop("estimator")
        _ported(type(inner).__name__)
        params["estimator"] = {
            "name": type(inner).__name__,
            "params": _own_params(inner, ESTIMATORS[type(inner).__name__][0])}
        fitted = ({"estimator_": export_fitted(est.estimator_)}
                  if hasattr(est, "estimator_") else {})
        return {"name": name, "params": params, "fitted": fitted}
    cls, attrs = ESTIMATORS[name]
    fitted = {a: _plain(getattr(est, a)) for a in attrs if hasattr(est, a)}
    return {"name": name, "params": _own_params(est, cls), "fitted": fitted}


def from_fitted(name, fitted, params=None):
    """The fitted port estimator of class ``name`` with the given
    constructor ``params`` and ``fitted`` attributes."""
    _ported(name)
    if name in WRAPPERS:
        params = dict(params or {})
        spec = params.pop("estimator")
        inner = ESTIMATORS[spec["name"]][0](**spec["params"])
        est = WRAPPERS[name](estimator=inner, **params)
        if "estimator_" in fitted:
            est.estimator_ = from_fitted(**fitted["estimator_"])
        return est
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
    if hasattr(est, "_restore_weights") and "coef_" in fitted:
        est._restore_weights()
    return est


def convert(est):
    """A fitted port estimator holding ``est``'s parameters."""
    return from_fitted(**export_fitted(est))
