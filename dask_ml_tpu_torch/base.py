"""Estimator base: the scikit-learn parameter contract, without sklearn.

Counterpart of ``dask_ml_tpu/base.py``, which re-exports sklearn's bases.
The machine with the card has no scikit-learn, so the port keeps its own
small copy of the contract: ``get_params``/``set_params`` by ``__init__``
signature introspection, ``clone``, a readable ``__repr__`` and the
mixins. Fitted state is host numpy (coefficients, centers), so fitted
estimators pickle and clone cleanly.
"""

from __future__ import annotations

import copy
import inspect

import numpy as np
import torch

__all__ = [
    "BaseEstimator",
    "ClassifierMixin",
    "RegressorMixin",
    "TransformerMixin",
    "ClusterMixin",
    "clone",
    "to_host",
    "log_proba",
]


class BaseEstimator:
    @classmethod
    def _get_param_names(cls):
        init = cls.__init__
        if init is object.__init__:
            return []
        params = inspect.signature(init).parameters.values()
        for p in params:
            if p.kind == p.VAR_POSITIONAL:
                raise RuntimeError(
                    f"{cls.__name__} must not take *args in __init__"
                )
        return sorted(p.name for p in params
                      if p.name != "self" and p.kind != p.VAR_KEYWORD)

    def get_params(self, deep=True):
        out = {}
        for name in self._get_param_names():
            value = getattr(self, name)
            if deep and hasattr(value, "get_params") \
                    and not isinstance(value, type):
                for k, v in value.get_params().items():
                    out[f"{name}__{k}"] = v
            out[name] = value
        return out

    def set_params(self, **params):
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            name, delim, sub = key.partition("__")
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator {self!r}. "
                    f"Valid parameters are: {sorted(self._get_param_names())}"
                )
            if delim:
                nested.setdefault(name, {})[sub] = value
            else:
                setattr(self, name, value)
                valid[name] = value
        for name, sub in nested.items():
            valid[name].set_params(**sub)
        return self

    def __repr__(self):
        defaults = {
            p.name: p.default
            for p in inspect.signature(type(self).__init__).parameters.values()
            if p.default is not p.empty
        }
        changed = []
        for k, v in self.get_params(deep=False).items():
            d = defaults.get(k, inspect.Parameter.empty)
            same = d is v or (
                not isinstance(v, (np.ndarray, torch.Tensor))
                and not isinstance(d, (np.ndarray, torch.Tensor))
                and d == v
            )
            if not same:
                changed.append(f"{k}={v!r}")
        return f"{type(self).__name__}({', '.join(changed)})"


def clone(estimator, *, safe=True):
    """Unfitted copy with the same parameters (sklearn.base.clone). An
    object without ``get_params`` (or a class) raises ``TypeError`` when
    ``safe``, and is deep-copied otherwise; parameters are cloned with
    ``safe=False``, as scikit-learn 1.9 does."""
    if isinstance(estimator, dict):
        return {k: clone(v, safe=safe) for k, v in estimator.items()}
    if isinstance(estimator, (list, tuple, set, frozenset)):
        return type(estimator)(clone(e, safe=safe) for e in estimator)
    if not hasattr(estimator, "get_params") or isinstance(estimator, type):
        if not safe:
            return copy.deepcopy(estimator)
        if isinstance(estimator, type):
            raise TypeError(
                "Cannot clone object. You should provide an instance of "
                "scikit-learn estimator instead of a class.")
        raise TypeError(
            f"Cannot clone object '{estimator!r}' (type {type(estimator)}): "
            "it does not seem to be a scikit-learn estimator as it does not "
            "implement a 'get_params' method.")
    params = {k: clone(v, safe=False)
              for k, v in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


class ClassifierMixin:
    _estimator_type = "classifier"


class RegressorMixin:
    _estimator_type = "regressor"


class ClusterMixin:
    _estimator_type = "clusterer"


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)


def log_proba(p):
    """log of a probability matrix with sklearn's ``predict_log_proba``
    semantics: zero probabilities map to -inf without a warning."""
    with np.errstate(divide="ignore"):
        return np.log(p)


def to_host(x):
    """A tensor, a ShardedArray (its logical rows) or an array-like as
    host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    return np.asarray(x)
