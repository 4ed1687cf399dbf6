"""Row-partitioned DataFrames: the host-side frame substrate.

Counterpart of ``dask_ml_tpu/parallel/frames.py``. A
:class:`PartitionedFrame` is a list of pandas partitions (the reference's
``dask.dataframe`` without a scheduler) with

- ``map_partitions`` fanned over a thread pool (pandas' C kernels
  release the GIL, so partitions overlap);
- host-side reductions for global statistics: ``global_categories``, the
  per-column category union over every partition and, under several
  processes, over every process's partitions (``allgather_object``);
- ``to_sharded``, the bridge to the device: the numeric columns as a
  ``ShardedArray`` on ``config.device``; under several processes (or in
  a virtual world) each process contributes ITS partitions through
  ``distributed.array_from_process_local`` (column sets must agree), and
  the result is process-local with the global row count.

Categorizer, DummyEncoder and OrdinalEncoder consume frames
partition-wise with global categories; the scalers, ColumnTransformer
and the splitters take them too. pandas is imported on these paths only
(the class itself needs it only once built from pandas partitions).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.validation import require_pandas

__all__ = ["PartitionedFrame", "from_pandas"]

_MAX_WORKERS = 8


class PartitionedFrame:
    """A logically concatenated DataFrame stored as row partitions."""

    def __init__(self, partitions):
        partitions = list(partitions)
        if not partitions:
            raise ValueError("PartitionedFrame needs >= 1 partition")
        cols = partitions[0].columns
        for p in partitions[1:]:
            if not p.columns.equals(cols):
                raise ValueError("partitions have mismatched columns")
        self.partitions = partitions

    # -- construction ------------------------------------------------------
    @classmethod
    def from_pandas(cls, df, npartitions: int = 8):
        n = len(df)
        npartitions = max(1, min(npartitions, n or 1))
        bounds = np.linspace(0, n, npartitions + 1, dtype=int)
        return cls([df.iloc[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])
                    if hi > lo] or [df])

    # -- metadata ----------------------------------------------------------
    @property
    def npartitions(self):
        return len(self.partitions)

    @property
    def columns(self):
        return self.partitions[0].columns

    @property
    def dtypes(self):
        return self.partitions[0].dtypes

    def __len__(self):
        return sum(len(p) for p in self.partitions)

    def __repr__(self):
        return (f"PartitionedFrame(npartitions={self.npartitions}, "
                f"n_rows={len(self)}, columns={list(self.columns)})")

    # -- partition-parallel ops -------------------------------------------
    def map_partitions(self, fn, *args, **kwargs):
        """``fn(partition, *args, **kwargs)`` on every partition at once
        (the caller's configuration in every worker). DataFrame results
        re-wrap as a PartitionedFrame; anything else returns the list of
        per-partition results."""
        pd = require_pandas("PartitionedFrame")
        from ..config import in_caller_config

        if len(self.partitions) == 1:
            results = [fn(self.partitions[0], *args, **kwargs)]
        else:
            one = in_caller_config(lambda p: fn(p, *args, **kwargs))
            with ThreadPoolExecutor(
                    max_workers=min(_MAX_WORKERS,
                                    len(self.partitions))) as pool:
                results = list(pool.map(one, self.partitions))
        if all(isinstance(r, pd.DataFrame) for r in results):
            return PartitionedFrame(results)
        return results

    def reduce_partitions(self, map_fn, reduce_fn):
        """map over partitions, then a host reduce: the dd tree-reduce
        shape for global statistics."""
        return reduce_fn(self.map_partitions(map_fn))

    # -- pandas-surface subset --------------------------------------------
    def __getitem__(self, key):
        pd = require_pandas("PartitionedFrame")
        if isinstance(key, (list, pd.Index)):
            return PartitionedFrame([p[list(key)] for p in self.partitions])
        return pd.concat([p[key] for p in self.partitions])  # one Series

    def assign(self, **kwargs):
        return self.map_partitions(lambda p: p.assign(**kwargs))

    def compute(self):
        """The one concatenated pandas DataFrame."""
        pd = require_pandas("PartitionedFrame")
        return pd.concat(self.partitions, axis=0)

    # -- global categorical support ---------------------------------------
    def global_categories(self, columns):
        """Per-column category union across ALL partitions, and across
        every process's partitions under several processes (the
        reference's distributed known-categories build), in order of
        first appearance (rank order)."""
        pd = require_pandas("PartitionedFrame")
        from . import distributed as dist

        def part_cats(p):
            return {c: pd.unique(p[c].dropna()) for c in columns}

        parts = self.map_partitions(part_cats)
        local = {c: (pd.unique(np.concatenate([
            np.asarray(d[c], dtype=object) for d in parts]))
            if parts else np.asarray([], dtype=object)) for c in columns}
        if dist.process_count() > 1:
            gathered = dist.allgather_object(local)
            local = {c: pd.unique(np.concatenate([
                np.asarray(g[c], dtype=object) for g in gathered]))
                for c in columns}
        return {c: pd.CategoricalDtype(local[c]) for c in columns}

    # -- device bridge -----------------------------------------------------
    def to_sharded(self, mesh=None, dtype=np.float32, columns=None,
                   shard_features=False, device=None):
        """The numeric (and boolean) columns as a ``ShardedArray`` on
        ``device`` (default ``config.device``); categorical columns must
        be encoded first. Under several processes, or in a virtual world,
        each process contributes its own partitions
        (``distributed.array_from_process_local``: global row order is
        rank order, column sets must agree): the array is process-local
        and knows the global row count. ``mesh`` is accepted for the JAX
        signature (the port's data axis is the process world);
        ``shard_features`` raises: feature sharding is not ported."""
        pd = require_pandas("PartitionedFrame")
        if shard_features:
            raise NotImplementedError(
                "to_sharded(shard_features=True) tiles the columns over a "
                "model axis, which is not ported (ROADMAP.md queue 1, "
                "Multi-GPU (feature sharding))")
        from . import distributed as dist
        from .sharded import ShardedArray

        cols = list(columns) if columns is not None else [
            c for c in self.columns
            if pd.api.types.is_numeric_dtype(self.dtypes[c])
            or pd.api.types.is_bool_dtype(self.dtypes[c])]
        if dist.process_count() > 1:
            # gather BEFORE any raise: a process raising before the
            # collective would leave its peers in it forever
            col_sets = dist.allgather_object([str(c) for c in cols])
            if any(cs != col_sets[0] for cs in col_sets):
                raise ValueError(
                    "cross-process to_sharded requires identical numeric "
                    f"column sets on every process; got {col_sets}")
            if not cols:
                raise ValueError("no numeric columns to place on device")
            host = np.concatenate([p[cols].to_numpy(dtype=dtype)
                                   for p in self.partitions], axis=0)
            return dist.array_from_process_local(host, dtype=dtype,
                                                 device=device)
        if not cols:
            raise ValueError("no numeric columns to place on device")
        host = np.concatenate([p[cols].to_numpy(dtype=dtype)
                               for p in self.partitions], axis=0)
        return ShardedArray.from_array(host, dtype=dtype, device=device)


def from_pandas(df, npartitions: int = 8) -> PartitionedFrame:
    return PartitionedFrame.from_pandas(df, npartitions)


def is_partitioned(X) -> bool:
    """``X`` is a PartitionedFrame (no pandas import)."""
    return isinstance(X, PartitionedFrame)
