"""ColumnTransformer / make_column_transformer.

Counterpart of ``dask_ml_tpu/compose/_column_transformer.py``. Columns
are names (pandas DataFrame) or integer indices (arrays, tensors and
ShardedArrays); the branches' outputs are concatenated side by side:
- on the device when any branch's output is there, host outputs placed
  on the device first (the JAX package pulls every device output to the
  host as soon as one branch's is there); the same values;
- as a frame when the input and every output are pandas frames and
  ``preserve_dataframe``;
- on the host when every output is.
The result is a ShardedArray when the input is one or every output is,
else host numpy. pandas is imported on the frame path only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin, clone, to_host
from ..parallel.sharded import ShardedArray, as_sharded
from ..utils.validation import check_is_fitted, is_pandas, reject_partitioned


def _concat_positional(frames, index):
    """hstack frames by position onto ``index``: pd.concat(axis=1)
    aligns on the index, and rows here correspond by position."""
    import pandas as pd

    out = []
    for f in frames:
        if len(f) != len(index):
            raise ValueError(
                f"transformer output has {len(f)} rows, expected "
                f"{len(index)}"
            )
        if not f.index.equals(index):
            f = f.set_axis(index, axis=0)
        out.append(f)
    return pd.concat(out, axis=1)


def _select(X, cols):
    if is_pandas(X):
        return X[cols] if isinstance(cols, list) else X[[cols]]
    idx = np.atleast_1d(np.asarray(cols, dtype=np.int64))
    if isinstance(X, torch.Tensor):
        X = ShardedArray.from_array(X)
    if isinstance(X, ShardedArray):
        return ShardedArray(
            X.data[:, torch.as_tensor(idx, device=X.device)], X.n_rows)
    return np.asarray(X)[:, idx]


def _to_stackable(out):
    if isinstance(out, ShardedArray) or is_pandas(out):
        return out
    if isinstance(out, torch.Tensor):
        return ShardedArray.from_array(out)
    return np.asarray(out)


class ColumnTransformer(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/compose::ColumnTransformer."""

    def __init__(self, transformers, remainder="drop", sparse_threshold=0.3,
                 n_jobs=None, transformer_weights=None, preserve_dataframe=True):
        self.transformers = transformers
        self.remainder = remainder
        self.sparse_threshold = sparse_threshold
        self.n_jobs = n_jobs
        self.transformer_weights = transformer_weights
        self.preserve_dataframe = preserve_dataframe

    def _all_columns(self, X):
        if is_pandas(X):
            return list(X.columns)
        return list(range(X.shape[1]))

    def _remainder_cols(self, X):
        used = []
        for _, _, cols in self.transformers:
            used.extend(cols if isinstance(cols, list) else [cols])
        return [c for c in self._all_columns(X) if c not in used]

    def fit(self, X, y=None):
        self.fit_transform(X, y)
        return self

    def fit_transform(self, X, y=None):
        reject_partitioned(X)
        if self.remainder not in ("drop", "passthrough"):
            raise ValueError("remainder must be 'drop' or 'passthrough'")
        self.transformers_ = []
        outs = []
        for name, trans, cols in self.transformers:
            sub = _select(X, cols)
            if isinstance(trans, str) and trans == "drop":
                self.transformers_.append((name, "drop", cols))
                continue
            if isinstance(trans, str) and trans == "passthrough":
                outs.append(_to_stackable(sub))
                self.transformers_.append((name, "passthrough", cols))
                continue
            t = clone(trans)
            out = t.fit_transform(sub, y) if hasattr(t, "fit_transform") \
                else t.fit(sub, y).transform(sub)
            outs.append(_to_stackable(out))
            self.transformers_.append((name, t, cols))
        self._rem_cols = (
            self._remainder_cols(X) if self.remainder == "passthrough" else []
        )
        if self._rem_cols:
            outs.append(_to_stackable(_select(X, self._rem_cols)))
        return self._hstack(outs, X)

    def transform(self, X):
        check_is_fitted(self, "transformers_")
        reject_partitioned(X)
        outs = []
        for name, t, cols in self.transformers_:
            if isinstance(t, str) and t == "drop":
                continue
            sub = _select(X, cols)
            if isinstance(t, str) and t == "passthrough":
                outs.append(_to_stackable(sub))
            else:
                outs.append(_to_stackable(t.transform(sub)))
        if self._rem_cols:
            outs.append(_to_stackable(_select(X, self._rem_cols)))
        return self._hstack(outs, X)

    def _hstack(self, outs, X):
        if not outs:
            raise ValueError("no transformer outputs")
        device = [o for o in outs if isinstance(o, ShardedArray)]
        if is_pandas(X) and self.preserve_dataframe and all(
                is_pandas(o) for o in outs):
            return _concat_positional(outs, X.index)
        parts = [o.to_numpy() if is_pandas(o) else o for o in outs]
        if not device:
            out = np.concatenate(parts, axis=1)
            if isinstance(X, (ShardedArray, torch.Tensor)):
                return as_sharded(out, dtype=np.float32, device=X.device)
            return out
        dev = device[0].device
        data = torch.cat([
            o.data[: o.n_rows].to(torch.float32)
            if isinstance(o, ShardedArray)
            else torch.as_tensor(np.asarray(o, np.float32), device=dev)
            for o in parts], dim=1)
        out = ShardedArray(data, device[0].n_rows)
        if len(device) == len(outs) or isinstance(X, (ShardedArray,
                                                      torch.Tensor)):
            return out
        return to_host(out)

    @property
    def named_transformers_(self):
        return {name: t for name, t, _ in self.transformers_}


def make_column_transformer(*transformers, remainder="drop",
                            sparse_threshold=0.3, n_jobs=None,
                            preserve_dataframe=True):
    """Ref: dask_ml/compose::make_column_transformer."""
    named = [
        (f"{type(t).__name__.lower()}-{i}" if not isinstance(t, str)
         else f"{t}-{i}", t, cols)
        for i, (t, cols) in enumerate(transformers, 1)
    ]
    return ColumnTransformer(named, remainder=remainder,
                             sparse_threshold=sparse_threshold, n_jobs=n_jobs,
                             preserve_dataframe=preserve_dataframe)
