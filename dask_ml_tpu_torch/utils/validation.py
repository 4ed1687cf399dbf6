"""Input validation / canonicalization.

Counterpart of ``dask_ml_tpu/utils/validation.py``: accept numpy arrays,
tensors or a ShardedArray and end with a ShardedArray on the configured
device (``config.device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_config
from ..parallel.sharded import ShardedArray, as_sharded
from ..parallel.streaming import _is_sparse_source, _slice_dense


def _assert_all_finite(arr, name="Input", allow_nan=False):
    """sklearn-parity finiteness gate for HOST float arrays; ``allow_nan``
    lets NaN through, never inf. Tensors skip it, as device arrays do in
    the JAX package: the solvers' sanitizers guard those without an
    extra pass over the data."""
    if not (isinstance(arr, np.ndarray)
            and np.issubdtype(arr.dtype, np.floating)):
        return
    if allow_nan:
        if np.isinf(arr).any():
            raise ValueError(f"{name} contains infinity.")
    elif not np.isfinite(arr).all():
        raise ValueError(f"{name} contains NaN or infinity.")


def _host_checked(x, name, dtype, ensure_2d, allow_nan):
    """numpy input: shape rules, cast, then the finiteness gate (after
    the cast: a finite float64 can overflow to inf in float32)."""
    arr = np.asarray(x)
    if arr.ndim == 1 and ensure_2d:
        raise ValueError(
            f"Expected 2D array, got 1D array instead: shape {arr.shape}."
        )
    if arr.ndim > 2:
        raise ValueError(f"Expected <=2D array, got shape {arr.shape}.")
    if dtype is not None and np.issubdtype(np.dtype(dtype), np.floating):
        arr = arr.astype(dtype, copy=False)
    _assert_all_finite(arr, name, allow_nan=allow_nan)
    return arr


def check_array(x, dtype=None, ensure_2d=True, allow_nan=False,
                device=None) -> ShardedArray:
    if _is_sparse_source(x):
        # a sparse X densified on placement (the JAX package's rule)
        x = _slice_dense(x, 0, int(x.shape[0]), dtype or np.float32)
    if not isinstance(x, (ShardedArray, torch.Tensor)):
        x = _host_checked(x, "X", dtype, ensure_2d, allow_nan)
    elif ensure_2d and (x.ndim != 2):
        raise ValueError(f"Expected 2D array, got shape {tuple(x.shape)}.")
    return as_sharded(x, dtype=dtype,
                      device=device or get_config().device)


def check_X_y(X, y, dtype=None, device=None):
    n_X = X.n_rows if isinstance(X, ShardedArray) else (
        int(X.shape[0]) if _is_sparse_source(X) else len(X))
    n_y = y.n_rows if isinstance(y, ShardedArray) else len(y)
    if n_X != n_y:
        raise ValueError(f"X and y have inconsistent lengths: {n_X} vs {n_y}")
    device = device or get_config().device
    X = check_array(X, dtype=dtype, device=device)
    if not isinstance(y, (ShardedArray, torch.Tensor)):
        y = _host_checked(y, "y", dtype, False, False)
    return X, as_sharded(y, dtype=dtype, device=device)


def check_is_fitted(est, attr: str):
    if not hasattr(est, attr):
        raise AttributeError(
            f"This {type(est).__name__} instance is not fitted yet; call "
            "'fit' first."
        )


def is_pandas(obj, kind="DataFrame") -> bool:
    """``obj`` is a pandas ``kind`` ("DataFrame" or "Series"), told by
    its type's module, so that no array path imports pandas (the machine
    with the card may not have it)."""
    return any(c.__name__ == kind and c.__module__.split(".")[0] == "pandas"
               for c in type(obj).__mro__)


def require_pandas(what):
    """The pandas module, for the paths that need it; ``ImportError``
    naming ``what`` when it is not installed."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError(f"{what} needs pandas, which is not installed"
                          ) from e
    return pandas


def data_fingerprint(a, n_sample=96) -> str:
    """Content fingerprint of an array for checkpoint identity: the SHA-1
    of its head, evenly strided middle and tail rows, so same-shape data
    of other content does not resume another fit's state. The JAX
    package's function, with the same digest for numpy, memmap and
    sparse inputs (sparse rows densify one at a time, in float32). A
    device tensor or ``ShardedArray`` takes one ``index_select`` of the
    sampled rows on the device and moves only those to the host."""
    import hashlib

    if a is None:
        return "none"
    n = a.n_rows if isinstance(a, ShardedArray) else (
        a.shape[0] if hasattr(a, "shape") else len(a))
    n = int(n)
    k = max(n_sample // 3, 1)
    idx = np.unique(np.concatenate([
        np.arange(min(k, n)),
        np.linspace(0, n - 1, num=min(k, n), dtype=np.int64),
        np.arange(max(n - k, 0), n),
    ]))
    if isinstance(a, (ShardedArray, torch.Tensor)):
        data = a.data if isinstance(a, ShardedArray) else a
        rows = torch.as_tensor(idx, dtype=torch.long, device=data.device)
        sample = data.index_select(0, rows).cpu().numpy()
    elif _is_sparse_source(a):
        from ..parallel.streaming import as_row_sliceable

        a = as_row_sliceable(a)
        sample = np.concatenate([
            _slice_dense(a, int(i), int(i) + 1, np.float32) for i in idx
        ]) if len(idx) else np.empty((0,) + a.shape[1:], np.float32)
    else:
        sample = np.asarray(a)[idx]
    return hashlib.sha1(np.ascontiguousarray(sample).tobytes()).hexdigest()
