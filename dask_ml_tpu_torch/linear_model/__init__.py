"""sklearn-parity namespace. Ref: dask_ml/linear_model/__init__.py."""
from ..models.glm import (LinearRegression, LogisticRegression,
                          PoissonRegression, add_intercept)
from ..models.sgd import SGDClassifier, SGDRegressor

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression",
           "SGDClassifier", "SGDRegressor", "add_intercept"]
