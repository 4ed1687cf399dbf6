"""Ref: dask_ml/decomposition/__init__.py."""
from ..models.pca import PCA, IncrementalPCA, TruncatedSVD

__all__ = ["PCA", "IncrementalPCA", "TruncatedSVD"]
