"""SimpleImputer on the device.

Counterpart of ``dask_ml_tpu/impute.py``: mean and constant as masked
reductions, the median by the exact sort-based quantiles of
``preprocessing/data.py::nan_quantiles`` (at any row count, as the JAX
package's ``nanquantile``), most_frequent by one host pass, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseEstimator, TransformerMixin, to_host
from .parallel.sharded import ShardedArray
from .preprocessing.data import nan_quantiles
from .utils.validation import check_array, check_is_fitted

__all__ = ["SimpleImputer"]

_STRATEGIES = ("mean", "median", "most_frequent", "constant")


class SimpleImputer(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/impute.py::SimpleImputer."""

    def __init__(self, missing_values=np.nan, strategy="mean",
                 fill_value=None, copy=True, add_indicator=False):
        self.missing_values = missing_values
        self.strategy = strategy
        self.fill_value = fill_value
        self.copy = copy
        self.add_indicator = add_indicator

    def _missing_mask(self, data):
        if isinstance(self.missing_values, float) and np.isnan(
            self.missing_values
        ):
            return torch.isnan(data)
        return data == self.missing_values

    def fit(self, X, y=None):
        if self.strategy not in _STRATEGIES:
            raise ValueError(
                f"strategy must be one of {_STRATEGIES}, got "
                f"{self.strategy!r}"
            )
        X = check_array(X, dtype=np.float32, allow_nan=True)
        mask = X.row_mask(X.dtype)
        missing = self._missing_mask(X.data) | (mask[:, None] == 0)
        if self.strategy == "constant":
            fv = 0.0 if self.fill_value is None else self.fill_value
            stats = np.full(X.shape[1], fv, np.float64)
        elif self.strategy == "mean":
            sums = torch.where(missing, 0.0, X.data).sum(0)
            counts = (~missing).to(X.dtype).sum(0)
            stats = to_host(sums / counts.clamp_min(1.0)).astype(np.float64)
        elif self.strategy == "median":
            data = torch.where(missing, torch.nan, X.data)
            stats = to_host(nan_quantiles(data, [0.5])[0]).astype(np.float64)
        else:  # most_frequent: a host pass (no device mode primitive)
            host = X.to_numpy()
            stats = np.empty(host.shape[1], np.float64)
            for j in range(host.shape[1]):
                col = host[:, j]
                col = col[~np.isnan(col)] if np.isnan(
                    self.missing_values
                ) else col[col != self.missing_values]
                if len(col) == 0:
                    stats[j] = np.nan
                else:
                    vals, cnt = np.unique(col, return_counts=True)
                    stats[j] = vals[np.argmax(cnt)]
        self.statistics_ = stats
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        check_is_fitted(self, "statistics_")
        X = check_array(X, dtype=np.float32, allow_nan=True)
        fill = torch.as_tensor(self.statistics_, dtype=X.dtype,
                               device=X.device)
        out = torch.where(self._missing_mask(X.data), fill[None, :], X.data)
        out = out * X.row_mask(out.dtype)[:, None]
        return ShardedArray(out, X.n_rows)
