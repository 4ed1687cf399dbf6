"""OneHotEncoder, OrdinalEncoder, Categorizer and DummyEncoder.

Counterpart of ``dask_ml_tpu/preprocessing/_encoders.py``, with the same
parameters and fitted attributes:

- array path: the categories of each column are given or found in one
  pass (``torch.unique`` on the device for a ShardedArray, ``np.unique``
  on the host otherwise); a ShardedArray's one-hot is one comparison a
  column on the device, and the check for unknown categories sums each
  column's segment there and pulls one flag (the JAX package pulls the
  whole one-hot to the host);
- frame path (Categorizer, DummyEncoder, and the encoders on a pandas
  DataFrame): pandas categorical semantics on the host. pandas is
  imported on that path only; Categorizer and DummyEncoder raise an
  ``ImportError`` naming pandas without it. PartitionedFrames
  (``parallel/frames.py``) as in the JAX package: Categorizer fits the
  GLOBAL category union (``global_categories``: every partition's, and
  every process's under several processes); OrdinalEncoder and
  DummyEncoder fit on the first partition (a Categorizer's output shares
  the global dtypes) and transform partition-wise
  (``map_partitions``). OneHotEncoder takes no PartitionedFrame, as in
  the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin
from ..parallel.sharded import ShardedArray
from ..parallel.frames import is_partitioned
from ..utils.validation import check_is_fitted, is_pandas, require_pandas


def _reject_partitioned(X, what):
    if is_partitioned(X):
        raise TypeError(f"{what} takes no PartitionedFrame (as in the JAX "
                        "package): use OrdinalEncoder or DummyEncoder")


def _categories_of(X):
    """The sorted distinct values of each column of a 2-D input."""
    if isinstance(X, ShardedArray):
        # distinct values on the device; np.unique folds NaNs into one,
        # as the JAX package's host pass does
        return [np.unique(torch.unique(X.data[: X.n_rows, j]).cpu().numpy())
                for j in range(X.shape[1])]
    Xh = np.asarray(X)
    return [np.unique(Xh[:, j]) for j in range(Xh.shape[1])]


def _is_categorical(dtype):
    return type(dtype).__name__ == "CategoricalDtype"


class OneHotEncoder(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/preprocessing/_encoders.py::OneHotEncoder. Dense
    output only (``sparse_output=True`` raises)."""

    def __init__(self, categories="auto", drop=None, sparse_output=False,
                 dtype=np.float32, handle_unknown="error"):
        self.categories = categories
        self.drop = drop
        self.sparse_output = sparse_output
        self.dtype = dtype
        self.handle_unknown = handle_unknown

    def fit(self, X, y=None):
        if self.sparse_output:
            raise ValueError(
                "sparse_output=True is not supported on TPU; dense one-hot "
                "only (reference requires scipy.sparse here)"
            )
        _reject_partitioned(X, "OneHotEncoder")
        if is_pandas(X):
            self.categories_ = [
                np.asarray(X[c].cat.categories)
                if _is_categorical(X[c].dtype)
                else np.unique(X[c].to_numpy())
                for c in X.columns
            ]
            self.feature_names_in_ = np.asarray(X.columns, dtype=object)
        else:
            if self.categories == "auto":
                self.categories_ = _categories_of(X)
            else:
                self.categories_ = [np.asarray(c) for c in self.categories]
        self.n_features_in_ = len(self.categories_)
        self.drop_idx_ = self._compute_drop_idx()
        return self

    def _compute_drop_idx(self):
        """sklearn's ``drop`` contract: None, 'first', 'if_binary', or an
        array of one category per feature (entries may be None)."""
        if self.drop is None:
            return None
        if isinstance(self.drop, str) and self.drop == "first":
            return np.zeros(len(self.categories_), dtype=object)
        if isinstance(self.drop, str) and self.drop == "if_binary":
            return np.asarray(
                [0 if len(c) == 2 else None for c in self.categories_],
                dtype=object,
            )
        drop = np.asarray(self.drop, dtype=object)
        if drop.shape != (len(self.categories_),):
            raise ValueError(
                f"drop should be of shape ({len(self.categories_)},), "
                f"got {drop.shape}"
            )
        idx = []
        for j, (d, cats) in enumerate(zip(drop, self.categories_)):
            if d is None:
                idx.append(None)
                continue
            where = np.flatnonzero(cats == d)
            if len(where) == 0:
                raise ValueError(
                    f"drop[{j}]={d!r} is not a category of feature {j}: "
                    f"{list(cats)}"
                )
            idx.append(int(where[0]))
        return np.asarray(idx, dtype=object)

    def _keep_indices(self):
        """Output columns kept after ``drop``, or None when nothing is
        dropped."""
        if getattr(self, "drop_idx_", None) is None:
            return None
        keep, start = [], 0
        for j, cats in enumerate(self.categories_):
            di = self.drop_idx_[j]
            keep.extend(
                start + k for k in range(len(cats))
                if di is None or k != di
            )
            start += len(cats)
        return np.asarray(keep, dtype=np.int64)

    def transform(self, X):
        check_is_fitted(self, "categories_")
        _reject_partitioned(X, "OneHotEncoder")
        keep = self._keep_indices()
        if isinstance(X, torch.Tensor):
            X = ShardedArray.from_array(X)
        if not isinstance(X, ShardedArray):  # host path
            if is_pandas(X):
                cols = [X[c].to_numpy() for c in X.columns]
            else:
                X = np.asarray(X)
                cols = [X[:, j] for j in range(X.shape[1])]
            outs = []
            for col, cats in zip(cols, self.categories_):
                unknown = ~np.isin(col, cats)
                if unknown.any() and self.handle_unknown == "error":
                    raise ValueError(
                        f"found unknown categories {np.unique(col[unknown])}"
                    )
                outs.append((col[:, None] == cats[None, :]).astype(self.dtype))
            full = np.concatenate(outs, axis=1)
            return full if keep is None else full[:, keep]

        # device path: one comparison a column; the unknown check runs on
        # the full one-hot (a dropped category's all-zero row is
        # legitimate), the drop gather after it
        data = X.data
        mask = X.row_mask(data.dtype)
        outs, unknown = [], torch.zeros((), dtype=torch.bool,
                                        device=data.device)
        for j, cats in enumerate(self.categories_):
            cats_d = torch.as_tensor(np.asarray(cats, np.float32),
                                     dtype=data.dtype, device=data.device)
            onehot = (data[:, j, None] == cats_d[None, :]).to(data.dtype)
            if self.handle_unknown == "error":
                unknown |= ((onehot.sum(1) == 0) & (mask > 0)).any()
            outs.append(onehot)
        if self.handle_unknown == "error" and bool(unknown):
            raise ValueError("found unknown categories in input")
        out = torch.cat(outs, dim=1) * mask[:, None]
        if keep is not None:
            out = out[:, torch.as_tensor(keep, device=data.device)]
        return ShardedArray(out, X.n_rows)

    def get_feature_names_out(self, input_features=None):
        check_is_fitted(self, "categories_")
        if input_features is None:
            input_features = getattr(
                self, "feature_names_in_",
                [f"x{i}" for i in range(self.n_features_in_)],
            )
        names = []
        for j, (f, cats) in enumerate(zip(input_features, self.categories_)):
            di = (None if getattr(self, "drop_idx_", None) is None
                  else self.drop_idx_[j])
            names.extend(
                f"{f}_{c}" for k, c in enumerate(cats)
                if di is None or k != di
            )
        return np.asarray(names, dtype=object)

    def inverse_transform(self, X):
        """One-hot columns back to the categories: the argmax of each
        feature's segment; an all-zero segment is the dropped category,
        or None (unknown) when none was dropped, as in sklearn."""
        check_is_fitted(self, "categories_")
        Xh = X.to_numpy() if isinstance(X, ShardedArray) else np.asarray(X)
        drop_idx = getattr(self, "drop_idx_", None)
        seg_cats = []  # per feature: (kept categories, dropped cat or None)
        for j, cats in enumerate(self.categories_):
            di = None if drop_idx is None else drop_idx[j]
            if di is None:
                seg_cats.append((np.asarray(cats), None))
            else:
                kept = np.asarray(
                    [c for k, c in enumerate(cats) if k != di], dtype=cats.dtype
                )
                seg_cats.append((kept, cats[di]))
        n_out = sum(len(kept) for kept, _ in seg_cats)
        if Xh.shape[1] != n_out:
            raise ValueError(
                f"Expected {n_out} one-hot columns, got {Xh.shape[1]}"
            )
        cols, start, any_unknown = [], 0, False
        for kept, dropped in seg_cats:
            if len(kept) == 0:
                cols.append(np.full(Xh.shape[0], dropped))
                continue
            seg = Xh[:, start:start + len(kept)]
            vals = kept[np.argmax(seg, axis=1)]
            zero = seg.max(axis=1) == 0
            if zero.any():
                if dropped is not None:
                    vals = vals.copy()
                    vals[zero] = dropped
                else:
                    any_unknown = True
                    vals = vals.astype(object)
                    vals[zero] = None
            cols.append(vals)
            start += len(kept)
        dtypes = {c.dtype for c in cols}
        if any_unknown or len(dtypes) > 1:
            # object output keeps each column's own type, as sklearn does
            out = np.empty((Xh.shape[0], len(cols)), dtype=object)
            for j, c in enumerate(cols):
                out[:, j] = c
            return out
        return np.stack(cols, axis=1)


class OrdinalEncoder(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/preprocessing/data.py::OrdinalEncoder: the
    categorical columns of a DataFrame by their codes; an array's columns
    through their sorted categories."""

    def __init__(self, categories="auto", dtype=np.float32):
        self.categories = categories
        self.dtype = dtype

    def fit(self, X, y=None):
        if is_partitioned(X):
            # a Categorizer's partitions share the GLOBAL categorical
            # dtypes: the first carries all fit needs
            return self.fit(X.partitions[0])
        if is_pandas(X):
            self.categorical_columns_ = [
                c for c in X.columns if _is_categorical(X[c].dtype)
            ]
            self.categories_ = [
                np.asarray(X[c].cat.categories)
                for c in self.categorical_columns_
            ]
            self.columns_ = np.asarray(X.columns, dtype=object)
        else:
            if self.categories == "auto":
                self.categories_ = _categories_of(X)
            else:
                self.categories_ = [np.asarray(c) for c in self.categories]
        self.n_features_in_ = (
            len(self.columns_) if hasattr(self, "columns_")
            else len(self.categories_)
        )
        return self

    def transform(self, X):
        check_is_fitted(self, "categories_")
        if is_partitioned(X):
            return X.map_partitions(self.transform)
        if is_pandas(X):
            out = X.copy()
            for c in self.categorical_columns_:
                out[c] = X[c].cat.codes
            return out
        Xh = X.to_numpy() if isinstance(X, ShardedArray) else np.asarray(X)
        out = np.stack([np.searchsorted(cats, Xh[:, j]).astype(self.dtype)
                        for j, cats in enumerate(self.categories_)], axis=1)
        if isinstance(X, ShardedArray):
            return ShardedArray.from_array(out, device=X.device)
        return out


class Categorizer(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/preprocessing/data.py::Categorizer: object and string
    columns of a DataFrame to pandas categorical dtypes (the dtypes
    DummyEncoder and OrdinalEncoder read)."""

    def __init__(self, categories=None, columns=None):
        self.categories = categories
        self.columns = columns

    def fit(self, X, y=None):
        pd = require_pandas("Categorizer")
        if is_partitioned(X):
            return self._fit_partitioned(X, pd)
        if not is_pandas(X):
            raise TypeError(
                "Categorizer requires a pandas DataFrame or PartitionedFrame"
            )
        columns = self.columns
        if columns is None:
            columns = [
                c for c in X.columns
                if pd.api.types.is_object_dtype(X[c].dtype)
                or pd.api.types.is_string_dtype(X[c].dtype)
                or isinstance(X[c].dtype, pd.CategoricalDtype)
            ]
        categories = {}
        for c in columns:
            if self.categories is not None and c in self.categories:
                categories[c] = self.categories[c]
            elif isinstance(X[c].dtype, pd.CategoricalDtype):
                categories[c] = X[c].dtype
            else:
                categories[c] = pd.CategoricalDtype(pd.unique(X[c].dropna()))
        self.categories_ = categories
        self.columns_ = pd.Index(columns)
        return self

    def _fit_partitioned(self, X, pd):
        """The global category union across partitions (and processes):
        the reference's distributed known-categories build."""
        columns = self.columns
        if columns is None:
            columns = [
                c for c in X.columns
                if pd.api.types.is_object_dtype(X.dtypes[c])
                or pd.api.types.is_string_dtype(X.dtypes[c])
                or isinstance(X.dtypes[c], pd.CategoricalDtype)
            ]
        fixed = {c: (self.categories[c] if self.categories is not None
                     and c in self.categories else None) for c in columns}
        need_global = [c for c in columns if fixed[c] is None and not
                       isinstance(X.dtypes[c], pd.CategoricalDtype)]
        global_cats = X.global_categories(need_global) if need_global \
            else {}
        categories = {}
        for c in columns:
            if fixed[c] is not None:
                categories[c] = fixed[c]
            elif isinstance(X.dtypes[c], pd.CategoricalDtype):
                categories[c] = X.dtypes[c]
            else:
                categories[c] = global_cats[c]
        self.categories_ = categories
        self.columns_ = pd.Index(columns)
        return self

    def transform(self, X, y=None):
        check_is_fitted(self, "categories_")
        if is_partitioned(X):
            return X.map_partitions(self.transform)
        X = X.copy()
        for c, dtype in self.categories_.items():
            X[c] = X[c].astype(dtype)
        return X


class DummyEncoder(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/preprocessing/data.py::DummyEncoder: pd.get_dummies
    of the categorical columns, in a stable column order."""

    def __init__(self, columns=None, drop_first=False):
        self.columns = columns
        self.drop_first = drop_first

    def fit(self, X, y=None):
        pd = require_pandas("DummyEncoder")
        if is_partitioned(X):
            # a Categorizer's partitions share the GLOBAL dtypes
            return self.fit(X.partitions[0])
        if not is_pandas(X):
            raise TypeError(
                "DummyEncoder requires a pandas DataFrame or "
                "PartitionedFrame"
            )
        columns = self.columns
        if columns is None:
            columns = [c for c in X.columns
                       if isinstance(X[c].dtype, pd.CategoricalDtype)]
        for c in columns:
            if not isinstance(X[c].dtype, pd.CategoricalDtype):
                raise ValueError(
                    f"column {c!r} is not categorical; run Categorizer first"
                )
        self.columns_ = pd.Index(columns)
        self.categorical_columns_ = self.columns_
        self.non_categorical_columns_ = X.columns.drop(self.columns_)
        self.transformed_columns_ = pd.Index(
            list(self.non_categorical_columns_) + [
                f"{c}_{cat}" for c in self.columns_
                for cat in (
                    X[c].cat.categories[1:] if self.drop_first
                    else X[c].cat.categories
                )
            ]
        )
        return self

    def transform(self, X, y=None):
        check_is_fitted(self, "columns_")
        if is_partitioned(X):
            return X.map_partitions(self.transform)
        pd = require_pandas("DummyEncoder")
        out = pd.get_dummies(X, columns=list(self.columns_),
                             drop_first=self.drop_first)
        return out.reindex(columns=self.transformed_columns_, fill_value=0)

    def inverse_transform(self, X):
        check_is_fitted(self, "columns_")
        pd = require_pandas("DummyEncoder")
        out = X[list(self.non_categorical_columns_)].copy()
        for c in self.columns_:
            prefix = f"{c}_"
            dummy_cols = [
                col for col in X.columns if str(col).startswith(prefix)
            ]
            cats = [str(col)[len(prefix):] for col in dummy_cols]
            out[c] = pd.Categorical.from_codes(
                np.argmax(X[dummy_cols].to_numpy(), axis=1), cats
            )
        return out
