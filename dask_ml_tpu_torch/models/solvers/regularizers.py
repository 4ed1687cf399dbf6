"""Regularizers with proximal operators: L1, L2, ElasticNet.

Counterpart of ``dask_ml_tpu/models/solvers/regularizers.py``: ``value``
is the penalty of smooth objectives and ``prox`` the proximal map of
proximal gradient. ``pmask`` is 1 on penalized coordinates and 0 on the
intercept, which is never penalized (sklearn's objective).
"""

from __future__ import annotations

import torch


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def value(reg: str, beta, lam, pmask, l1_ratio=0.5):
    b = beta * pmask
    if reg == "l2":
        return 0.5 * lam * torch.sum(b * b)
    if reg == "l1":
        return lam * torch.sum(torch.abs(b))
    if reg == "elastic_net":
        return lam * (
            l1_ratio * torch.sum(torch.abs(b))
            + 0.5 * (1.0 - l1_ratio) * torch.sum(b * b)
        )
    if reg == "none":
        return torch.zeros((), dtype=beta.dtype, device=beta.device)
    raise ValueError(f"Unknown regularizer {reg!r}")


def prox(reg: str, beta, lam, t, pmask, l1_ratio=0.5):
    """prox_{t * lam * r}(beta), identity on unpenalized coordinates."""
    if reg == "l2":
        out = beta / (1.0 + t * lam)
    elif reg == "l1":
        out = _soft_threshold(beta, t * lam)
    elif reg == "elastic_net":
        out = _soft_threshold(beta, t * lam * l1_ratio) / (
            1.0 + t * lam * (1.0 - l1_ratio)
        )
    elif reg == "none":
        return beta
    else:
        raise ValueError(f"Unknown regularizer {reg!r}")
    return torch.where(pmask > 0, out, beta)


SMOOTH = {"l2", "none"}
KNOWN = {"l1", "l2", "elastic_net", "none"}
