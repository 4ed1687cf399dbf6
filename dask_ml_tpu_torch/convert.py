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

A streamed fit's ``training_profile_`` (a JSON-safe dict) travels with
the GLM, SGD, KMeans and PCA-family estimators, and KMeans's
``checkpoint_path`` and ``checkpoint_every`` with its parameters.

The decomposition estimators carry their components, spectrum and mean;
an ``IncrementalPCA`` also carries ``n_samples_seen_``, and a
``partial_fit`` continued in the port rebuilds its device state from
them. The SGD estimators also carry their step clock ``_t``, and their weights
are rebuilt from ``coef_``/``intercept_`` on ``config.device``, so a
``partial_fit`` continued in the port takes the lr the JAX package would.
The wrappers (``Incremental``, ``ParallelPostFit``) carry their own
parameters, the wrapped estimator's class and parameters, and their
fitted ``estimator_``.

The preprocessing estimators, ``SimpleImputer`` and ``GaussianNB`` carry
their fitted arrays (a list of arrays, such as an encoder's
``categories_``, as a list of numpy arrays); ``SpectralClustering``
carries ``labels_``, ``eigenvalues_`` and its fitted ``assign_labels_``
KMeans; ``ColumnTransformer`` and the blockwise ensembles carry their
members one by one. An estimator among the parameters travels as
``{"name", "params"}``, a fitted one among the fitted attributes as the
full ``{"name", "params", "fitted"}`` export.

The text vectorizers: ``CountVectorizer`` carries ``vocabulary_`` (a
dict of term -> column) and ``stop_words_`` (the pruned terms, a set,
carried as a sorted list); ``HashingVectorizer`` and ``FeatureHasher``
are stateless and carry their parameters.
"""

from __future__ import annotations

import numpy as np

from .compose import ColumnTransformer
from .ensemble import BlockwiseVotingClassifier, BlockwiseVotingRegressor
from .feature_extraction.text import (CountVectorizer, FeatureHasher,
                                      HashingVectorizer)
from .impute import SimpleImputer
from .models.glm import LinearRegression, LogisticRegression, PoissonRegression
from .models.kmeans import KMeans
from .models.pca import PCA, IncrementalPCA, TruncatedSVD
from .models.sgd import SGDClassifier, SGDRegressor
from .models.spectral import SpectralClustering
from .naive_bayes import GaussianNB
from .parallel.sharded import ShardedArray
from .preprocessing import (LabelEncoder, MinMaxScaler, OneHotEncoder,
                            OrdinalEncoder, PolynomialFeatures,
                            QuantileTransformer, RobustScaler, StandardScaler)
from .wrappers import Incremental, ParallelPostFit

_GLM_FITTED = ("coef_", "intercept_", "n_iter_", "n_features_in_",
               "fit_dtype_", "training_profile_")
_SGD_FITTED = _GLM_FITTED + ("_t",)
_SVD_FITTED = ("components_", "explained_variance_",
               "explained_variance_ratio_", "singular_values_",
               "n_features_in_")
_PCA_FITTED = _SVD_FITTED + ("mean_", "noise_variance_", "n_components_",
                             "n_samples_", "fit_dtype_", "training_profile_")
_NAMES_IN = ("n_features_in_", "feature_names_in_")

ESTIMATORS = {
    "LogisticRegression": (LogisticRegression, _GLM_FITTED + ("classes_",)),
    "LinearRegression": (LinearRegression, _GLM_FITTED),
    "PoissonRegression": (PoissonRegression, _GLM_FITTED),
    "KMeans": (KMeans, ("cluster_centers_", "labels_", "inertia_",
                        "n_iter_", "n_features_in_", "fit_dtype_",
                        "training_profile_")),
    "SGDClassifier": (SGDClassifier, _SGD_FITTED + ("classes_",)),
    "SGDRegressor": (SGDRegressor, _SGD_FITTED),
    "PCA": (PCA, _PCA_FITTED),
    "TruncatedSVD": (TruncatedSVD, _SVD_FITTED),
    "IncrementalPCA": (IncrementalPCA, _PCA_FITTED + ("n_samples_seen_",)),
    "StandardScaler": (StandardScaler, ("mean_", "var_", "scale_",
                                        "n_samples_seen_") + _NAMES_IN),
    "MinMaxScaler": (MinMaxScaler, ("data_min_", "data_max_", "data_range_",
                                    "scale_", "min_") + _NAMES_IN),
    "RobustScaler": (RobustScaler, ("center_", "scale_") + _NAMES_IN),
    "QuantileTransformer": (QuantileTransformer, (
        "quantiles_", "references_", "n_quantiles_") + _NAMES_IN),
    "PolynomialFeatures": (PolynomialFeatures, ("n_output_features_",)
                           + _NAMES_IN),
    "OneHotEncoder": (OneHotEncoder, ("categories_", "drop_idx_")
                      + _NAMES_IN),
    "OrdinalEncoder": (OrdinalEncoder, ("categories_", "n_features_in_",
                                        "categorical_columns_", "columns_")),
    "LabelEncoder": (LabelEncoder, ("classes_", "dtype_")),
    "SimpleImputer": (SimpleImputer, ("statistics_", "n_features_in_")),
    "GaussianNB": (GaussianNB, ("classes_", "class_count_", "theta_", "var_",
                                "class_prior_", "n_features_in_")),
    "SpectralClustering": (SpectralClustering, (
        "labels_", "eigenvalues_", "assign_labels_", "n_features_in_")),
    "ColumnTransformer": (ColumnTransformer, ("transformers_", "_rem_cols")),
    "BlockwiseVotingClassifier": (BlockwiseVotingClassifier,
                                  ("estimators_", "classes_")),
    "BlockwiseVotingRegressor": (BlockwiseVotingRegressor, ("estimators_",)),
    "CountVectorizer": (CountVectorizer, ("vocabulary_", "stop_words_")),
    "HashingVectorizer": (HashingVectorizer, ()),
    "FeatureHasher": (FeatureHasher, ()),
    "Incremental": (Incremental, ("estimator_",)),
    "ParallelPostFit": (ParallelPostFit, ("estimator_",)),
}


def _is_estimator(v):
    return hasattr(v, "get_params") and not isinstance(v, type)


def _ported(name):
    if name not in ESTIMATORS:
        raise ValueError(f"no port of {name}; ported: {sorted(ESTIMATORS)}")


def _spec(v):
    """A parameter value as plain data: an estimator as {"name",
    "params"}, lists and tuples element by element."""
    if _is_estimator(v):
        return {"name": type(v).__name__, "params": _own_params(v)}
    if isinstance(v, (list, tuple)):
        return type(v)(_spec(e) for e in v)
    return v


def _own_params(est):
    name = type(est).__name__
    _ported(name)
    own = set(ESTIMATORS[name][0]._get_param_names())
    return {k: _spec(v) for k, v in est.get_params(deep=False).items()
            if k in own}


def _plain(value):
    """A fitted attribute as plain data: a fitted estimator as its export,
    row containers (anything with ``to_numpy``) and arrays as numpy
    arrays, lists and tuples element by element."""
    if _is_estimator(value):
        return export_fitted(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (set, frozenset)):
        return sorted(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(e) for e in value)
    if hasattr(value, "to_numpy"):
        return np.array(value.to_numpy())
    if isinstance(value, (str, int, float)) or value is None:
        return value
    return np.array(value)


def export_fitted(est) -> dict:
    """{"name", "params", "fitted"} of a fitted estimator, plain data."""
    name = type(est).__name__
    _ported(name)
    fitted = {a: _plain(getattr(est, a)) for a in ESTIMATORS[name][1]
              if hasattr(est, a)}
    return {"name": name, "params": _own_params(est), "fitted": fitted}


def _build(v):
    """Parameters back from plain data: {"name", "params"} specs become
    unfitted port estimators."""
    if isinstance(v, dict) and set(v) == {"name", "params"}:
        return ESTIMATORS[v["name"]][0](**{k: _build(p) for k, p in
                                           v["params"].items()})
    if isinstance(v, (list, tuple)):
        return type(v)(_build(e) for e in v)
    return v


def _restore(attr, v):
    """A fitted attribute back from plain data."""
    if isinstance(v, dict) and set(v) == {"name", "params", "fitted"}:
        return from_fitted(**v)
    if attr == "stop_words_":
        return set(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_restore(None, e) for e in v)
    if attr == "labels_":
        return ShardedArray.from_array(np.asarray(v, np.int32))

    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


def from_fitted(name, fitted, params=None):
    """The fitted port estimator of class ``name`` with the given
    constructor ``params`` and ``fitted`` attributes."""
    _ported(name)
    cls, attrs = ESTIMATORS[name]
    est = cls(**{k: _build(v) for k, v in (params or {}).items()})
    for a in attrs:
        if a in fitted:
            setattr(est, a, _restore(a, fitted[a]))
    if hasattr(est, "_restore_weights") and "coef_" in fitted:
        est._restore_weights()
    if hasattr(est, "_restore_fitted"):
        est._restore_fitted()
    return est


def convert(est):
    """A fitted port estimator holding ``est``'s parameters."""
    return from_fitted(**export_fitted(est))
