"""BlockTransformer: a stateless function applied to the data.

Counterpart of ``dask_ml_tpu/preprocessing/_block_transformer.py``. A
ShardedArray's tensor goes to ``func`` as it is; a numpy-only function
that refuses the tensor with a ``TypeError`` (as numpy does with a CUDA
tensor) runs on the host rows instead. Every other error propagates:
the JAX package reruns ``func`` on the host after any exception, which
on the card would hide a failure of the device path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin
from ..parallel.sharded import ShardedArray, as_sharded


class BlockTransformer(TransformerMixin, BaseEstimator):
    """Ref: _block_transformer.py::BlockTransformer."""

    def __init__(self, func, validate=False, **kw_args):
        self.func = func
        self.validate = validate
        self.kw_args = kw_args

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        kwargs = self.kw_args or {}
        if not isinstance(X, ShardedArray):
            return self.func(X, **kwargs)
        try:
            out = self.func(X.data, **kwargs)
        except TypeError:
            out = self.func(X.to_numpy(), **kwargs)
            return as_sharded(np.asarray(out), device=X.device)
        if isinstance(out, torch.Tensor):
            return ShardedArray(out, X.n_rows)
        return as_sharded(np.asarray(out)[: X.n_rows], device=X.device)
