"""Ref: dask_ml/preprocessing/__init__.py."""
from ._block_transformer import BlockTransformer
from ._encoders import Categorizer, DummyEncoder, OneHotEncoder, OrdinalEncoder
from .data import (MinMaxScaler, PolynomialFeatures, QuantileTransformer,
                   RobustScaler, StandardScaler)
from .label import LabelEncoder

__all__ = [
    "BlockTransformer", "Categorizer", "DummyEncoder", "LabelEncoder",
    "MinMaxScaler", "OneHotEncoder", "OrdinalEncoder", "PolynomialFeatures",
    "QuantileTransformer", "RobustScaler", "StandardScaler",
]
