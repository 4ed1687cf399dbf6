"""Data splitting: train_test_split, ShuffleSplit, KFold.

Counterpart of ``dask_ml_tpu/model_selection/_split.py``. Splitters draw
host index arrays from ``np.random.RandomState(random_state)`` exactly
as the JAX package does, so both packages pick the same rows, index for
index; a ShardedArray's folds are gathered on its device
(``take_rows``). On one device ``blockwise=True`` has a single block, the
whole array, and draws what ``blockwise=False`` draws.

Not ported: PartitionedFrame inputs, which raise naming ROADMAP.md
queue 1, Multi-GPU (the frames module comes with the mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import ShardedArray
from ..parallel.streaming import reject_sparse


def _validate_sizes(n, test_size, train_size):
    if test_size is None and train_size is None:
        test_size = 0.25
    if test_size is None:
        test_size = 1.0 - (
            train_size if isinstance(train_size, float) else train_size / n
        )
    n_test = (int(np.ceil(n * test_size)) if isinstance(test_size, float)
              else int(test_size))
    if train_size is None:
        n_train = n - n_test
    else:
        n_train = (int(np.floor(n * train_size))
                   if isinstance(train_size, float) else int(train_size))
    if n_test + n_train > n:
        raise ValueError(
            f"train_size + test_size = {n_train + n_test} > n_samples = {n}"
        )
    if n_test < 1 or n_train < 1:
        raise ValueError("resulting train/test sets would be empty")
    return n_train, n_test


def _reject_frames(a):
    if type(a).__name__ == "PartitionedFrame":
        raise NotImplementedError(
            "PartitionedFrame inputs are not ported yet: ROADMAP.md queue 1, "
            "Multi-GPU (parallel/frames.py)")


def _n_rows(a):
    if isinstance(a, ShardedArray):
        return a.n_rows
    return int(a.shape[0]) if hasattr(a, "shape") else len(a)


def take_rows(a, idx):
    """Rows ``idx`` of ``a``: a gather on the device for a ShardedArray or
    tensor, numpy indexing for host arrays."""
    if isinstance(a, ShardedArray):
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
        return ShardedArray(a.data.index_select(0, sel), len(idx))
    if isinstance(a, torch.Tensor):
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
        return a.index_select(0, sel)
    reject_sparse(a)
    return np.asarray(a)[idx]


def train_test_split(*arrays, test_size=None, train_size=None,
                     random_state=None, shuffle=True, blockwise=True,
                     **kwargs):
    """Ref: dask_ml/model_selection/_split.py::train_test_split."""
    if not arrays:
        raise ValueError("at least one array required")
    _reject_frames(arrays[0])
    rng = np.random.RandomState(random_state)
    n = _n_rows(arrays[0])
    for a in arrays:
        if _n_rows(a) != n:
            raise ValueError("arrays have inconsistent lengths")
    n_train, n_test = _validate_sizes(n, test_size, train_size)
    if shuffle:
        idx = rng.permutation(n)
        test_idx, train_idx = idx[:n_test], idx[n_test:n_test + n_train]
    else:
        # scikit-learn's rule: train = the leading rows, test = the rest
        idx = np.arange(n)
        train_idx = idx[:n_train]
        test_idx = idx[n_train:n_train + n_test]
    out = []
    for a in arrays:
        out.extend([take_rows(a, train_idx), take_rows(a, test_idx)])
    return out


class ShuffleSplit:
    """Ref: dask_ml/model_selection/_split.py::ShuffleSplit."""

    def __init__(self, n_splits=10, test_size=0.1, train_size=None,
                 blockwise=True, random_state=None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.train_size = train_size
        self.blockwise = blockwise
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        _reject_frames(X)
        rng = np.random.RandomState(self.random_state)
        n = _n_rows(X)
        for _ in range(self.n_splits):
            n_train, n_test = _validate_sizes(n, self.test_size,
                                              self.train_size)
            idx = rng.permutation(n)
            yield idx[n_test:n_test + n_train], idx[:n_test]

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits


class KFold:
    """Ref: dask_ml/model_selection/_split.py::KFold."""

    def __init__(self, n_splits=5, shuffle=False, random_state=None):
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        _reject_frames(X)
        n = _n_rows(X)
        if self.n_splits > n:
            raise ValueError(f"n_splits={self.n_splits} > n_samples={n}")
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(idx)
        sizes = np.full(self.n_splits, n // self.n_splits)
        sizes[: n % self.n_splits] += 1
        stops = np.cumsum(sizes)
        starts = stops - sizes
        for lo, hi in zip(starts, stops):
            yield np.concatenate([idx[:lo], idx[hi:]]), idx[lo:hi]

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits
