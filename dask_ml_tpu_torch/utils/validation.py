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
    if not isinstance(x, (ShardedArray, torch.Tensor)):
        x = _host_checked(x, "X", dtype, ensure_2d, allow_nan)
    elif ensure_2d and (x.ndim != 2):
        raise ValueError(f"Expected 2D array, got shape {tuple(x.shape)}.")
    return as_sharded(x, dtype=dtype,
                      device=device or get_config().device)


def check_X_y(X, y, dtype=None, device=None):
    n_X = X.n_rows if isinstance(X, ShardedArray) else len(X)
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
