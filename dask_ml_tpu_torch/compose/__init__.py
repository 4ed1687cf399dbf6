"""Ref: dask_ml/compose/__init__.py."""
from ._column_transformer import ColumnTransformer, make_column_transformer

__all__ = ["ColumnTransformer", "make_column_transformer"]
