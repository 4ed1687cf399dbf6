"""Single-device row container.

Counterpart of ``dask_ml_tpu/parallel/sharded.py::ShardedArray``. The JAX
container pads rows to a multiple of the mesh's data axis and carries the
logical ``n_rows`` plus a row mask; on one device no padding is needed,
but the ``n_rows``/``row_mask`` contract is kept, so code ported from the
JAX estimators reads the same: ``data`` may hold more rows than
``n_rows`` (a caller's padded buffer), and every statistic is masked.

A process-local array (``distributed.array_from_process_local``) holds
THIS rank's rows of a global array: ``process_local`` is set,
``global_rows`` counts every rank's rows and ``row_offset`` is where this
rank's start (rank order). ``n_rows``, ``shape`` and ``row_mask`` stay
local; the resident GLM and KMeans fits merge their sums across ranks.

A feature-sharded array (``from_array(..., shard_features=True)`` under a
``"DxM"`` mesh with M > 1, ``parallel/mesh.py``) holds THIS rank's column
tile of its row group's rows: ``model_sharded`` is set, ``data`` is the
(rows, d/M) tile, ``n_features`` the global width and ``col_offset``
where the tile starts. ``shape`` reports the global width, as the JAX
array's logical shape does; ``to_numpy`` gathers the tile's row group at
that width over the "model" collective (so every rank of the row group
must call it). With D > 1 the array is process-local over the row
groups as well.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def torch_dtype(dtype):
    """A numpy or torch dtype (or None) as a torch dtype (or None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


class ShardedArray:
    """A logically (n_rows, *feature_dims) array on one device.

    Parameters
    ----------
    data : torch.Tensor
        Device tensor; its leading axis holds at least ``n_rows`` rows.
    n_rows : int
        Logical number of rows (rows past it are padding).
    """

    __slots__ = ("data", "n_rows", "process_local", "global_rows",
                 "row_offset", "model_sharded", "n_features", "col_offset")

    def __init__(self, data: torch.Tensor, n_rows: int,
                 process_local: bool = False, global_rows=None,
                 row_offset: int = 0, model_sharded: bool = False,
                 n_features=None, col_offset: int = 0):
        self.data = data
        self.n_rows = int(n_rows)
        self.process_local = bool(process_local)
        self.global_rows = self.n_rows if global_rows is None \
            else int(global_rows)
        self.row_offset = int(row_offset)
        self.model_sharded = bool(model_sharded)
        self.n_features = (None if n_features is None
                           else int(n_features))
        self.col_offset = int(col_offset)

    def _layout(self):
        """The keyword arguments that carry this array's layout."""
        return dict(process_local=self.process_local,
                    global_rows=self.global_rows,
                    row_offset=self.row_offset,
                    model_sharded=self.model_sharded,
                    n_features=self.n_features, col_offset=self.col_offset)

    @classmethod
    def from_array(cls, x, dtype=None, device=None,
                   shard_features=False) -> "ShardedArray":
        """Place a host (numpy) array or a tensor on the device; a tensor
        already there (and of the dtype) is used as it is, not copied.

        ``shard_features=True`` under a ``"DxM"`` mesh with M > 1 keeps
        this rank's column tile of ``x`` (the M ranks of a row group pass
        the same rows; a ``ValueError`` on every rank when their row
        counts differ) and, with D > 1, makes the array process-local
        over the row groups. A 2-D ``x`` whose width does not divide
        over M, or any other ``x``, keeps its full width (the
        model-replicated layout, as JAX stages such an X data-only). In
        one process, or on a 1-D mesh, it places ``x`` whole, as JAX's
        "feature" rule degrades on a mesh without a model axis. A
        collective of the world when M > 1."""
        if isinstance(x, ShardedArray):
            if dtype is None and device is None:
                return x
            return cls(_place(x.data, dtype, device), x.n_rows,
                       **x._layout())
        if shard_features:
            from .mesh import model_shards

            if model_shards() > 1:
                return _from_feature_tiles(cls, x, dtype, device)
        data = _place(x, dtype, device)
        return cls(data, data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def shape(self):
        if self.model_sharded:
            return (self.n_rows, self.n_features) + tuple(
                self.data.shape[2:])
        return (self.n_rows,) + tuple(self.data.shape[1:])

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def __len__(self):
        return self.n_rows

    def __repr__(self):
        local = (f", process_local, global_rows={self.global_rows}"
                 if self.process_local else "")
        if self.model_sharded:
            local += (f", columns [{self.col_offset}, "
                      f"{self.col_offset + self.data.shape[1]})")
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device}{local})")

    def row_mask(self, dtype=torch.float32) -> torch.Tensor:
        """(n_padded,) mask: 1 for logical rows, 0 for padding."""
        idx = torch.arange(self.data.shape[0], device=self.device)
        return (idx < self.n_rows).to(dtype)

    def to_numpy(self) -> np.ndarray:
        """This rank's rows on the host; a feature-sharded array's at the
        global width, its row group's tiles gathered in column order
        over the "model" collective."""
        host = self.data[: self.n_rows].detach().cpu().numpy()
        if not self.model_sharded:
            return host
        from .distributed import allgather_host

        return np.concatenate(list(allgather_host(host, "model")), axis=1)


def _place(x, dtype, device):
    dev = resolve_device(device) if device is not None or \
        not isinstance(x, torch.Tensor) else x.device
    dt = torch_dtype(dtype)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dt if dt is not None else x.dtype)
    from .streaming import _is_sparse_source, _slice_dense

    if _is_sparse_source(x):
        # densified on placement: right for block-sized sparse inputs (a
        # partial_fit block); whole-corpus fits route sparse X through
        # stream_plan and BlockStream, a block at a time
        x = _slice_dense(x, 0, int(x.shape[0]),
                         x.dtype if dtype is None
                         or isinstance(dtype, torch.dtype) else dtype)
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.to(device=dev, dtype=dt if dt is not None else t.dtype)


def _from_feature_tiles(cls, x, dtype, device):
    """``from_array(x, shard_features=True)`` under a mesh with a model
    axis: the rank's column tile (or the whole width when it does not
    tile), the global row count over the row groups."""
    from . import distributed as dist
    from .mesh import feature_tile, process_mesh

    D, M = process_mesh()
    n = int(x.shape[0])
    d = int(x.shape[1]) if getattr(x, "ndim", len(x.shape)) >= 2 else 0
    ndim = len(x.shape)
    # one gather of every rank's (rows, width, ndim) BEFORE any raise, so
    # no rank is left in a collective
    seen = dist.allgather_object((n, d, ndim))
    groups = [seen[i * M:(i + 1) * M] for i in range(D)]
    if any(len(set(g)) != 1 for g in groups) \
            or len({s[1:] for s in seen}) != 1:
        raise ValueError(
            "from_array(shard_features=True): the ranks of a row group "
            "must pass the same rows, and every rank the same width; got "
            f"(rows, width, ndim) by rank {seen}")
    me = dist.process_index() // M
    counts = [g[0][0] for g in groups]
    tile = feature_tile(d, M) if ndim == 2 else None
    if tile is not None:
        if isinstance(x, torch.Tensor):
            x = x[:, tile[0]:tile[1]]
        else:
            x = np.asarray(x)[:, tile[0]:tile[1]]
    data = _place(x, dtype, device)
    return cls(data, n, process_local=D > 1, global_rows=int(sum(counts)),
               row_offset=int(sum(counts[:me])),
               model_sharded=tile is not None,
               n_features=d if tile is not None else None,
               col_offset=tile[0] if tile is not None else 0)


def as_sharded(x, dtype=None, device=None) -> ShardedArray:
    """Canonicalize numpy / tensor / ShardedArray input to ShardedArray."""
    return ShardedArray.from_array(x, dtype=dtype, device=device)
