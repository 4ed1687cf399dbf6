"""GLM families: Normal, Logistic, Poisson.

Counterpart of ``dask_ml_tpu/models/solvers/families.py``. Each family is
a pointwise loss plus an inverse link as torch functions; gradients come
from autograd (plain loss) or the fused kernel (``ops/fused.py``), whose
CUDA source carries the same formulas. ``pointwise(eta, y)`` is the
per-row negative log-likelihood up to a y-only constant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Normal:
    name = "normal"

    @staticmethod
    def pointwise(eta, y):
        return 0.5 * (eta - y) ** 2

    @staticmethod
    def mean(eta):  # inverse link
        return eta

    @staticmethod
    def hess_weight(eta, y):
        return torch.ones_like(eta)


class Logistic:
    name = "logistic"

    @staticmethod
    def pointwise(eta, y):
        # log(1 + e^eta) - y*eta; softplus is the stable form
        return F.softplus(eta) - y * eta

    @staticmethod
    def mean(eta):
        return torch.sigmoid(eta)

    @staticmethod
    def hess_weight(eta, y):
        p = torch.sigmoid(eta)
        return p * (1.0 - p)


class Poisson:
    name = "poisson"

    @staticmethod
    def pointwise(eta, y):
        return torch.exp(eta) - y * eta

    @staticmethod
    def mean(eta):
        return torch.exp(eta)

    @staticmethod
    def hess_weight(eta, y):
        return torch.exp(eta)


FAMILIES = {f.name: f for f in (Normal, Logistic, Poisson)}


def get_family(name: str):
    if name not in FAMILIES:
        raise ValueError(f"Unknown family {name!r}; options: {sorted(FAMILIES)}")
    return FAMILIES[name]
