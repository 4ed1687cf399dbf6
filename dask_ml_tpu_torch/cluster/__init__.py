"""Ref: dask_ml/cluster/__init__.py."""
from ..models.kmeans import KMeans, k_means
from ..models.spectral import SpectralClustering

__all__ = ["KMeans", "SpectralClustering", "k_means"]
