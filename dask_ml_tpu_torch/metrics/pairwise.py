"""Public pairwise metrics (counterpart of
``dask_ml_tpu/metrics/pairwise.py``): the primitives of
``ops/pairwise.py`` on host arrays, tensors or ShardedArrays. Inputs are
placed on ``config.device`` as float32 (a ShardedArray or tensor keeps
its device); the result is a tensor there with exactly ``len(X)`` rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..ops import pairwise as _ops
from ..ops.pairwise import PAIRWISE_KERNEL_FUNCTIONS  # noqa: F401
from ..parallel.sharded import ShardedArray


def _operand(a, device=None):
    if isinstance(a, ShardedArray):
        a = a.data[: a.n_rows]
    if isinstance(a, torch.Tensor):
        return a.to(device or a.device, torch.float32)
    arr = np.ascontiguousarray(a, dtype=np.float32)
    return torch.from_numpy(arr.copy() if not arr.flags.writeable
                            else arr).to(device or resolve_device())


def _public(fn):
    @functools.wraps(fn)
    def wrapped(X, Y=None, *args, **kwargs):
        x = _operand(X)
        y = x if Y is None else _operand(Y, x.device)
        return fn(x, y, *args, **kwargs)

    return wrapped


pairwise_distances = _public(_ops.pairwise_distances)
pairwise_kernels = _public(_ops.pairwise_kernels)
euclidean_distances = _public(_ops.euclidean_distances)
manhattan_distances = _public(_ops.manhattan_distances)
cosine_distances = _public(_ops.cosine_distances)
linear_kernel = _public(_ops.linear_kernel)
rbf_kernel = _public(_ops.rbf_kernel)
polynomial_kernel = _public(_ops.polynomial_kernel)
sigmoid_kernel = _public(_ops.sigmoid_kernel)
pairwise_distances_argmin_min = _public(_ops.pairwise_distances_argmin_min)


def pairwise_distances_argmin(X, Y=None):
    """The labels half of pairwise_distances_argmin_min (euclidean)."""
    return pairwise_distances_argmin_min(X, Y)[0]


__all__ = [
    "cosine_distances", "euclidean_distances", "linear_kernel",
    "manhattan_distances", "pairwise_distances",
    "pairwise_distances_argmin", "pairwise_distances_argmin_min",
    "pairwise_kernels", "polynomial_kernel", "rbf_kernel",
    "sigmoid_kernel",
]
