"""Shape-bucket ladder for the online serving path.

Counterpart of ``dask_ml_tpu/serving/_buckets.py``. A captured CUDA
graph is shape-specialized: a server that ran each micro-batch at its
exact row count would capture a fresh graph per novel size. The ladder
fixes a small geometric set of batch heights (min, min*g, min*g^2, ...,
max); every batch is padded UP to the smallest rung that fits, so
steady-state serving replays at most ``len(ladder)`` graphs per method,
all of which ``ModelServer.warmup()`` captures before the first request.
The policy is the plans' :class:`~dask_ml_tpu_torch.plans.GeometricLadder`;
``BucketLadder`` is its serving-configured instance.
"""

from __future__ import annotations

from ..plans.ladders import GeometricLadder

__all__ = ["BucketLadder"]


class BucketLadder(GeometricLadder):
    """The geometric sequence of padded batch heights.

    ``bucket_for(n)`` returns the smallest rung >= n; callers chunk
    requests taller than the top rung (``max_rows``) before asking.
    """

    __slots__ = ()

    @classmethod
    def from_config(cls):
        from ..config import get_config

        cfg = get_config()
        return cls(
            min_rows=cfg.serving_min_batch,
            max_rows=cfg.serving_max_batch,
            growth=cfg.serving_bucket_growth,
        )

    def __repr__(self):
        return f"BucketLadder{self.buckets}"
