"""Ref: dask_ml/ensemble/__init__.py."""
from ._blockwise import BlockwiseVotingClassifier, BlockwiseVotingRegressor

__all__ = ["BlockwiseVotingClassifier", "BlockwiseVotingRegressor"]
