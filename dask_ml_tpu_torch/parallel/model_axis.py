"""The "model" collective on device tensors: the feature tiles' merge.

Under a ``"DxM"`` mesh (``parallel/mesh.py``) the M ranks of a row group
hold the same rows, each its column tile ``[lo, hi)`` of X. Wherever the
math contracts over features the tiles meet here, on the host, as
``distributed.psum_host``/``allgather_host`` over ``group="model"``:
float64 sums in column order, so every rank of the row group holds
bit-equal results (its peers' line searches then take the same steps).
The JAX package runs the same merges as ``lax.psum`` over its "model"
mesh axis on the devices (``dask_ml_tpu/models/solvers/streamed.py``,
``_sb_reducer_feature_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the row group's tiles of ``t`` (each rank's float32
    partial, e.g. ``X_j @ w_j``), back on ``t``'s device as float32. The
    partials travel as float32 (half the bytes of ``psum_host``'s
    float64 payload) and add in float64 in column order: the same bits
    as ``psum_host``, since a float32 widens to float64 exactly."""
    from .distributed import allgather_host

    parts = allgather_host(t.detach().to(torch.float32).cpu().numpy(),
                           group="model")
    out = parts.astype(np.float64).sum(axis=0).astype(np.float32)
    return torch.as_tensor(out, device=t.device).reshape(t.shape)


def tile_matmul(x: torch.Tensor, W: torch.Tensor, lo: int) -> torch.Tensor:
    """``X @ W`` from this rank's column tile ``x`` (rows, hi - lo) of
    X, which starts at column ``lo``: the tile meets its rows
    ``W[lo:hi]`` of ``W`` (d, ...) and the row group's partials sum by
    :func:`model_sum` (every rank of the row group must call it)."""
    return model_sum(x @ W[lo:lo + x.shape[1]])


def gather_features(t, axis: int = -1):
    """The row group's tiles of ``t`` concatenated along ``axis`` in
    column order (each rank's slice of a per-feature array, or its
    columns of a block): a tensor back on ``t``'s device, a host array
    as a host array."""
    from .distributed import allgather_host

    host = t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()
    out = np.concatenate(list(allgather_host(np.ascontiguousarray(host),
                                             group="model")), axis=axis)
    return out if isinstance(t, np.ndarray) else torch.as_tensor(
        out, device=t.device)
