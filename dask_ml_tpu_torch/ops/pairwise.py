"""Pairwise distances in plain torch.

Counterpart of ``dask_ml_tpu/ops/pairwise.py:19-60``: the expansion
``||x||^2 - 2 x.y + ||y||^2`` clamped at 0, with the cross term as one
matrix product. Used by ``KMeans.transform``, the init helpers and the
plain versions of the Lloyd kernels (``ops/fused.py``); the rest of the
module (L1, cosine, the kernels, the name tables) serves
``metrics/pairwise.py``.
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


def pairwise_distances_argmin_min(x, y):
    """(labels, distances) of the nearest row of y for each row of x:
    the first minimum of the squared distances, then its root."""
    d2 = euclidean_distances_sq(x, y)
    mn, labels = d2.min(1)
    return labels, mn.sqrt()


def manhattan_distances(x, y):
    """L1 distances (n, m), broadcast: y (the anchors) is small."""
    return (x[:, None, :] - y[None, :, :]).abs().sum(-1)


def cosine_distances(x, y):
    xn = x / row_norms_sq(x).sqrt().clamp_min(1e-12)[:, None]
    yn = y / row_norms_sq(y).sqrt().clamp_min(1e-12)[:, None]
    return (1.0 - xn @ yn.T).clamp(0.0, 2.0)


def linear_kernel(x, y):
    return x @ y.T


def _gamma(x, gamma):
    return 1.0 / x.shape[-1] if gamma is None else gamma


def rbf_kernel(x, y, gamma=None):
    return (-_gamma(x, gamma) * euclidean_distances_sq(x, y)).exp()


def polynomial_kernel(x, y, degree=3, gamma=None, coef0=1.0):
    return (_gamma(x, gamma) * (x @ y.T) + coef0) ** degree


def sigmoid_kernel(x, y, gamma=None, coef0=1.0):
    return (_gamma(x, gamma) * (x @ y.T) + coef0).tanh()


_PAIRWISE_METRICS = {
    "euclidean": euclidean_distances,
    "l2": euclidean_distances,
    "sqeuclidean": euclidean_distances_sq,
    "manhattan": manhattan_distances,
    "l1": manhattan_distances,
    "cityblock": manhattan_distances,
    "cosine": cosine_distances,
}

PAIRWISE_KERNEL_FUNCTIONS = {
    "linear": linear_kernel,
    "rbf": rbf_kernel,
    "polynomial": polynomial_kernel,
    "sigmoid": sigmoid_kernel,
}


def _named(table, metric, what):
    try:
        return table[metric]
    except KeyError:
        raise ValueError(
            f"unsupported {what} {metric!r}; one of {sorted(table)} or a "
            "callable") from None


def pairwise_distances(x, y, metric="euclidean", **kwargs):
    """Distance matrix (n, m) by name or callable ``f(x, y, **kwargs)``."""
    if callable(metric):
        return metric(x, y, **kwargs)
    return _named(_PAIRWISE_METRICS, metric, "metric")(x, y, **kwargs)


def pairwise_kernels(x, y, metric="linear", **kwargs):
    """Kernel matrix by name or callable."""
    if callable(metric):
        return metric(x, y, **kwargs)
    return _named(PAIRWISE_KERNEL_FUNCTIONS, metric, "kernel")(x, y,
                                                               **kwargs)
