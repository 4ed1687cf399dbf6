"""Data splitting: train_test_split, ShuffleSplit, KFold.

Counterpart of ``dask_ml_tpu/model_selection/_split.py``. Splitters draw
host index arrays from ``np.random.RandomState(random_state)`` exactly
as the JAX package does, so both packages pick the same rows, index for
index; a ShardedArray's folds are gathered on its device
(``take_rows``). On one device ``blockwise=True`` has a single block, the
whole array, and draws what ``blockwise=False`` draws.

A sparse X (scipy sparse or ``SparseBlocks``) splits by rows into CSR
folds, gathered by row index and never densified.

PartitionedFrames (``parallel/frames.py``) split as in the JAX package:
``blockwise=True`` splits each partition's own rows (no shuffle crosses
partitions), ``blockwise=False`` draws one permutation of the whole
frame and re-partitions; ``ShuffleSplit`` and ``KFold`` index a frame's
rows like any array's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import ShardedArray
from ..parallel.streaming import _is_sparse_source, as_row_indexable
from ..parallel.frames import is_partitioned


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


def _n_rows(a):
    if isinstance(a, ShardedArray):
        return a.n_rows
    if is_partitioned(a):
        return len(a)
    return int(a.shape[0]) if hasattr(a, "shape") else len(a)


def take_rows(a, idx):
    """Rows ``idx`` of ``a``: a gather on the device for a ShardedArray or
    tensor, numpy indexing for host arrays, a CSR row gather for a sparse
    source."""
    if isinstance(a, ShardedArray):
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
        return ShardedArray(a.data.index_select(0, sel), len(idx))
    if isinstance(a, torch.Tensor):
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
        return a.index_select(0, sel)
    if _is_sparse_source(a):
        # sparse folds stay sparse: a CSR row gather
        return as_row_indexable(a)[np.asarray(idx)]
    return np.asarray(a)[idx]


def train_test_split(*arrays, test_size=None, train_size=None,
                     random_state=None, shuffle=True, blockwise=True,
                     **kwargs):
    """Ref: dask_ml/model_selection/_split.py::train_test_split."""
    if not arrays:
        raise ValueError("at least one array required")
    rng = np.random.RandomState(random_state)
    if is_partitioned(arrays[0]):
        if not shuffle:
            blockwise = False  # a contiguous split needs no blocks
        return _split_frames(arrays, test_size, train_size, rng, shuffle,
                             blockwise)
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


def _split_frames(arrays, test_size, train_size, rng, shuffle, blockwise):
    """train_test_split over PartitionedFrames (the JAX
    ``_split_frames``): ``blockwise=True`` splits each partition's own
    rows; ``blockwise=False`` permutes the concatenated frame and
    re-partitions it."""
    from ..parallel.frames import PartitionedFrame

    part_lens = [len(p) for p in arrays[0].partitions]
    for a in arrays:
        if not is_partitioned(a) or [len(p) for p in a.partitions] \
                != part_lens:
            raise ValueError("all arrays must be PartitionedFrames with "
                             "identical partition lengths")
    if blockwise:
        train_ix, test_ix = [], []
        for m in part_lens:
            if m == 0:  # an empty partition adds nothing to either
                train_ix.append(np.arange(0))
                test_ix.append(np.arange(0))
                continue
            n_train, n_test = _validate_sizes(m, test_size, train_size)
            if shuffle:
                idx = rng.permutation(m)
                test_ix.append(idx[:n_test])
                train_ix.append(idx[n_test:n_test + n_train])
            else:
                idx = np.arange(m)
                train_ix.append(idx[:n_train])
                test_ix.append(idx[n_train:n_train + n_test])
        out = []
        for a in arrays:
            out.append(PartitionedFrame([p.iloc[ix] for p, ix in
                                         zip(a.partitions, train_ix)]))
            out.append(PartitionedFrame([p.iloc[ix] for p, ix in
                                         zip(a.partitions, test_ix)]))
        return out
    n = sum(part_lens)
    n_train, n_test = _validate_sizes(n, test_size, train_size)
    if shuffle:
        idx = rng.permutation(n)
        test_idx, train_idx = idx[:n_test], idx[n_test:n_test + n_train]
    else:
        idx = np.arange(n)
        train_idx, test_idx = idx[:n_train], idx[n_train:n_train + n_test]
    out = []
    for a in arrays:
        host = a.compute()
        out.append(PartitionedFrame.from_pandas(host.iloc[train_idx],
                                                a.npartitions))
        out.append(PartitionedFrame.from_pandas(host.iloc[test_idx],
                                                a.npartitions))
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
