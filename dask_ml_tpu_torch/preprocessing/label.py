"""LabelEncoder.

Counterpart of ``dask_ml_tpu/preprocessing/label.py``: classes from the
data (or a pandas categorical's categories), values to their codes. A
ShardedArray's codes are one ``searchsorted`` on the device, with the
check for unseen labels there too (one flag pulled). pandas is imported
on no path: a Series is told by its type's module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin
from ..parallel.sharded import ShardedArray
from ..utils.validation import check_is_fitted, is_pandas


def _categorical_series(y):
    return is_pandas(y, "Series") and \
        type(y.dtype).__name__ == "CategoricalDtype"


class LabelEncoder(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/preprocessing/label.py::LabelEncoder."""

    def __init__(self, use_categorical=True):
        self.use_categorical = use_categorical

    def fit(self, y):
        if self.use_categorical and _categorical_series(y):
            self.classes_ = np.asarray(y.cat.categories)
            self.dtype_ = y.dtype
            return self
        if isinstance(y, ShardedArray):
            self.classes_ = np.unique(
                torch.unique(y.data[: y.n_rows]).cpu().numpy())
        else:
            self.classes_ = np.unique(np.asarray(y))
        self.dtype_ = None
        return self

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def transform(self, y):
        check_is_fitted(self, "classes_")
        if self.dtype_ is not None and _categorical_series(y) and \
                y.dtype == self.dtype_:
            return np.asarray(y.cat.codes)
        if isinstance(y, ShardedArray):
            classes = torch.as_tensor(self.classes_, dtype=y.dtype,
                                      device=y.device)
            valid = y.data[: y.n_rows]
            if not bool(torch.isin(valid, classes).all()):
                self._check_membership(valid.cpu().numpy())
            return ShardedArray(torch.searchsorted(classes, y.data), y.n_rows)
        yh = np.asarray(y)
        self._check_membership(yh)
        return np.searchsorted(self.classes_, yh)

    def _check_membership(self, yh):
        extra = np.setdiff1d(yh, self.classes_)
        if len(extra):
            raise ValueError(f"y contains previously unseen labels: {extra}")

    def inverse_transform(self, y):
        check_is_fitted(self, "classes_")
        if isinstance(y, ShardedArray):
            y = y.to_numpy()
        return self.classes_[np.asarray(y).astype(int)]
