"""Blockwise ensembles: one member estimator per block of rows, voting or
averaging to predict.

Counterpart of ``dask_ml_tpu/ensemble/_blockwise.py``. A host array is
cut into 8 blocks, as in the JAX package; a ShardedArray is one block,
its one device's rows (JAX cuts it into its mesh's data shards). Members
are clones of the given estimator (a port estimator fits its block on
the device, and X goes to the device once for all members' predictions,
where the JAX package hands each member the host rows); their votes and
averages are host reductions over the (small) per-member outputs.
"""

from __future__ import annotations

import numpy as np

from ..base import BaseEstimator, ClassifierMixin, RegressorMixin, clone, \
    to_host
from ..metrics import accuracy_score, r2_score
from ..parallel.sharded import ShardedArray, as_sharded
from ..utils.validation import check_array
from ..wrappers import _is_device_estimator

# blocks of a host array (the JAX package's count)
_HOST_BLOCKS = 8


class _BlockwiseBase(BaseEstimator):
    def __init__(self, estimator):
        self.estimator = estimator

    def _shard_blocks(self, X, y):
        n_blocks = 1 if isinstance(X, ShardedArray) else _HOST_BLOCKS
        Xh, yh = to_host(X), to_host(y)
        bs = int(np.ceil(len(Xh) / n_blocks))
        for i in range(0, len(Xh), bs):
            yield Xh[i:i + bs], yh[i:i + bs]

    def _fit(self, X, y, **kwargs):
        self.estimators_ = []
        for Xb, yb in self._shard_blocks(X, y):
            if len(Xb) == 0:
                continue
            est = clone(self.estimator)
            est.fit(Xb, yb, **kwargs)
            self.estimators_.append(est)
        if not self.estimators_:
            raise ValueError("no non-empty blocks to fit on")
        return self

    def _member_predictions(self, X, method="predict"):
        # members of this package take X placed on the device once; any
        # other estimator predicts on the host rows
        if all(_is_device_estimator(est) for est in self.estimators_):
            X = check_array(X, dtype=np.float32)
        else:
            X = to_host(X)
        return np.stack([to_host(getattr(est, method)(X))
                         for est in self.estimators_], axis=0)

    def _wrap_like(self, out, X):
        if isinstance(X, ShardedArray):
            return as_sharded(out, device=X.device)
        return out


class BlockwiseVotingClassifier(ClassifierMixin, _BlockwiseBase):
    """Ref: dask_ml/ensemble/_blockwise.py::BlockwiseVotingClassifier."""

    def __init__(self, estimator, voting="hard", classes=None):
        self.estimator = estimator
        self.voting = voting
        self.classes = classes

    def fit(self, X, y, **kwargs):
        if self.voting not in ("hard", "soft"):
            raise ValueError(f"voting must be 'hard' or 'soft', got "
                             f"{self.voting!r}")
        self._fit(X, y, **kwargs)
        if self.classes is not None:
            self.classes_ = np.asarray(self.classes)
        else:
            self.classes_ = np.unique(to_host(y))
        return self

    def predict(self, X):
        if self.voting == "soft":
            proba = self._member_predictions(X, "predict_proba").mean(axis=0)
            out = self.classes_[np.argmax(proba, axis=1)]
        else:
            preds = self._member_predictions(X)  # (members, n)
            votes = np.stack(
                [(preds == c).sum(axis=0) for c in self.classes_], axis=1
            )
            out = self.classes_[np.argmax(votes, axis=1)]
        return self._wrap_like(out, X)

    def predict_proba(self, X):
        if self.voting != "soft":
            raise AttributeError(
                "predict_proba is only available when voting='soft'"
            )
        proba = self._member_predictions(X, "predict_proba").mean(axis=0)
        return self._wrap_like(proba, X)

    def score(self, X, y):
        return accuracy_score(to_host(y), to_host(self.predict(X)))


class BlockwiseVotingRegressor(RegressorMixin, _BlockwiseBase):
    """Ref: dask_ml/ensemble/_blockwise.py::BlockwiseVotingRegressor."""

    def fit(self, X, y, **kwargs):
        return self._fit(X, y, **kwargs)

    def predict(self, X):
        return self._wrap_like(self._member_predictions(X).mean(axis=0), X)

    def score(self, X, y):
        return r2_score(to_host(y), to_host(self.predict(X)))
