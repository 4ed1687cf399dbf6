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
                 "row_offset")

    def __init__(self, data: torch.Tensor, n_rows: int,
                 process_local: bool = False, global_rows=None,
                 row_offset: int = 0):
        self.data = data
        self.n_rows = int(n_rows)
        self.process_local = bool(process_local)
        self.global_rows = self.n_rows if global_rows is None \
            else int(global_rows)
        self.row_offset = int(row_offset)

    @classmethod
    def from_array(cls, x, dtype=None, device=None) -> "ShardedArray":
        """Place a host (numpy) array or a tensor on the device; a tensor
        already there (and of the dtype) is used as it is, not copied."""
        if isinstance(x, ShardedArray):
            if dtype is None and device is None:
                return x
            return cls(_place(x.data, dtype, device), x.n_rows,
                       x.process_local, x.global_rows, x.row_offset)
        data = _place(x, dtype, device)
        return cls(data, data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def shape(self):
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
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device}{local})")

    def row_mask(self, dtype=torch.float32) -> torch.Tensor:
        """(n_padded,) mask: 1 for logical rows, 0 for padding."""
        idx = torch.arange(self.data.shape[0], device=self.device)
        return (idx < self.n_rows).to(dtype)

    def to_numpy(self) -> np.ndarray:
        return self.data[: self.n_rows].detach().cpu().numpy()


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


def as_sharded(x, dtype=None, device=None) -> ShardedArray:
    """Canonicalize numpy / tensor / ShardedArray input to ShardedArray."""
    return ShardedArray.from_array(x, dtype=dtype, device=device)
