"""sklearn-parity namespace. Ref: dask_ml/linear_model/__init__.py."""
from ..models.glm import LinearRegression, LogisticRegression, PoissonRegression

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression"]
