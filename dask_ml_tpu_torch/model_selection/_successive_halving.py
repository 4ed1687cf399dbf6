"""SuccessiveHalvingSearchCV. Counterpart of
``dask_ml_tpu/model_selection/_successive_halving.py``: rungs of
training after each of which only the top ``1/aggressiveness`` of the
models survive and train ``aggressiveness`` times longer, on the
incremental controller's ``additional_calls`` protocol."""

from __future__ import annotations

import math

from ._incremental import BaseIncrementalSearchCV


class SuccessiveHalvingSearchCV(BaseIncrementalSearchCV):
    """Ref: _successive_halving.py::SuccessiveHalvingSearchCV."""

    def __init__(self, estimator, parameters, n_initial_parameters=10,
                 n_initial_iter=None, max_iter=None, aggressiveness=3,
                 test_size=None, patience=False, tol=1e-3,
                 random_state=None, scoring=None, verbose=False, prefix=""):
        super().__init__(estimator, parameters,
                         n_initial_parameters=n_initial_parameters,
                         test_size=test_size, patience=patience, tol=tol,
                         max_iter=max_iter, random_state=random_state,
                         scoring=scoring, verbose=verbose, prefix=prefix)
        self.n_initial_iter = n_initial_iter
        self.aggressiveness = aggressiveness

    def fit(self, X, y=None, **fit_params):
        if self.n_initial_iter is None:
            raise ValueError("n_initial_iter must be specified")
        return super().fit(X, y, **fit_params)

    def _reset_hook(self):
        self._rung = 0

    def _additional_calls(self, info):
        eta = self.aggressiveness
        scores = {mid: recs[-1]["score"] for mid, recs in info.items()}
        calls = {mid: recs[-1]["partial_fit_calls"]
                 for mid, recs in info.items()}
        # first bring everyone to this rung's budget
        target = self.n_initial_iter * (eta ** self._rung)
        pending = {mid: target - calls[mid] for mid in scores
                   if calls[mid] < target}
        if pending:
            return {mid: max(c, 0) for mid, c in pending.items()}
        # rung complete: keep the top 1/eta, raise their budget eta times
        n_keep = max(1, math.floor(len(scores) / eta))
        keep = sorted(scores, key=scores.get, reverse=True)[:n_keep]
        self._rung += 1
        next_target = self.n_initial_iter * (eta ** self._rung)
        if self.max_iter is not None:
            next_target = min(next_target, self.max_iter)
        out = {mid: next_target - calls[mid] for mid in keep}
        return {mid: c for mid, c in out.items() if c > 0}
