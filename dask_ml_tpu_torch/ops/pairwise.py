"""Pairwise distances in plain torch.

Counterpart of ``dask_ml_tpu/ops/pairwise.py:19-60``: the expansion
``||x||^2 - 2 x.y + ||y||^2`` clamped at 0, with the cross term as one
matrix product. Used by ``KMeans.transform``, the init helpers and the
plain versions of the Lloyd kernels (``ops/fused.py``).
"""

from __future__ import annotations

def row_norms_sq(x):
    return (x * x).sum(-1)


def euclidean_distances_sq(x, y, mxu_dtype=None):
    """Squared euclidean distances (n, m). ``mxu_dtype=torch.bfloat16``
    runs only the cross term on bf16 operands with f32 results (the
    JAX package's ``mxu_dtype`` contract: operands rounded to bf16,
    products and sums in f32); norms stay at x's dtype."""
    if mxu_dtype is not None:
        xy = x.to(mxu_dtype).float() @ y.to(mxu_dtype).float().T
    else:
        xy = x @ y.T
    d2 = row_norms_sq(x)[:, None] - 2.0 * xy + row_norms_sq(y)[None, :]
    return d2.clamp_min(0.0)


def euclidean_distances(x, y):
    return euclidean_distances_sq(x, y).sqrt()
