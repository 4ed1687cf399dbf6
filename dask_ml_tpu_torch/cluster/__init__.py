"""Ref: dask_ml/cluster/__init__.py."""
from ..models.kmeans import KMeans, k_means

__all__ = ["KMeans", "k_means"]
