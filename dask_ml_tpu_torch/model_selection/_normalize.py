"""Deterministic estimator tokens for the search's prefix memo.

Counterpart of ``dask_ml_tpu/model_selection/_normalize.py``: a stable
string token keyed on (class, sorted params), so a pipeline prefix
shared by several candidates is fitted once per fold."""

from __future__ import annotations

import hashlib

import numpy as np


def _token_piece(v):
    if isinstance(v, np.ndarray):
        digest = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
        return f"ndarray:{v.shape}:{v.dtype}:{digest[:16]}"
    if isinstance(v, (list, tuple)):
        return f"{type(v).__name__}({','.join(_token_piece(i) for i in v)})"
    if isinstance(v, dict):
        inner = ",".join(f"{k}={_token_piece(v[k])}"
                         for k in sorted(v, key=str))
        return f"dict({inner})"
    if hasattr(v, "get_params"):
        return estimator_token(v)
    return f"{type(v).__name__}:{v!r}"


def estimator_token(est) -> str:
    """Stable token for an (unfitted) estimator's identity and params."""
    params = est.get_params(deep=False)
    inner = ",".join(f"{k}={_token_piece(params[k])}" for k in sorted(params))
    raw = f"{type(est).__module__}.{type(est).__qualname__}({inner})"
    return hashlib.sha1(raw.encode()).hexdigest()
