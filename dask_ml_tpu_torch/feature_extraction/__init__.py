"""Text feature extraction (ref: dask_ml/feature_extraction/__init__.py)."""
from . import text
from .text import (CountVectorizer, DenseBudgetExceeded, FeatureHasher,
                   HashingVectorizer, to_sharded_dense)

__all__ = ["text", "HashingVectorizer", "FeatureHasher", "CountVectorizer",
           "to_sharded_dense", "DenseBudgetExceeded"]
