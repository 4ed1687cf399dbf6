"""Masked reductions over the rows of one device's array.

Counterpart of ``dask_ml_tpu/ops/reductions.py``. Every function takes the
(possibly padded) data plus a row mask (1 = logical row, 0 = padding), so
padding never biases a statistic.
"""

from __future__ import annotations

import torch


def masked_sum(x, mask):
    """Sum over rows, ignoring masked rows. x: (n, ...), mask: (n,)."""
    return torch.tensordot(mask.to(x.dtype), x, dims=([0], [0]))


def masked_mean(x, mask, n_rows):
    return masked_sum(x, mask) / n_rows


def masked_mean_var(x, mask, n_rows, ddof=0):
    """Mean and variance per column, centered in a second pass."""
    mean = masked_mean(x, mask, n_rows)
    centered = (x - mean) * _expand(mask, x)
    var = (centered * centered).sum(0) / max(n_rows - ddof, 1)
    return mean, var


def _expand(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1)).to(x.dtype)
