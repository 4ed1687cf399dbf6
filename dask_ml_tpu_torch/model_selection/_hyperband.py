"""HyperbandSearchCV. Counterpart of
``dask_ml_tpu/model_selection/_hyperband.py``: brackets computed from
(max_iter, aggressiveness), each a successive-halving schedule, all
interleaved through one controller fit: every adaptive round advances
the union of the live candidates of every bracket, so on the streamed
cohort plane one ``BlockStream`` pass trains the whole union (the
brackets' heterogeneous ``n_calls`` fold onto one block-step timeline).

Not ported: striping brackets across processes (ROADMAP.md queue 1,
Multi-GPU); the port runs one process, and its brackets interleave."""

from __future__ import annotations

import math

import numpy as np

from ._incremental import BaseIncrementalSearchCV
from ._params import ParameterSampler


def _brackets(max_iter, eta):
    """Hyperband's bracket table: [(bracket, n_models, n_initial_iter)]."""
    s_max = int(math.floor(math.log(max_iter, eta)))
    B = (s_max + 1) * max_iter
    out = []
    for s in range(s_max, -1, -1):
        n = int(math.ceil(B / max_iter * (eta ** s) / (s + 1)))
        r = max(1, int(max_iter * (eta ** -s)))
        out.append((s, n, r))
    return out


class HyperbandSearchCV(BaseIncrementalSearchCV):
    """Ref: _hyperband.py::HyperbandSearchCV."""

    def __init__(self, estimator, parameters, max_iter=81, aggressiveness=3,
                 patience=False, tol=1e-3, test_size=None, random_state=None,
                 scoring=None, verbose=False, prefix=""):
        super().__init__(estimator, parameters,
                         test_size=test_size, patience=patience, tol=tol,
                         max_iter=max_iter, random_state=random_state,
                         scoring=scoring, verbose=verbose, prefix=prefix)
        self.max_iter = max_iter
        self.aggressiveness = aggressiveness

    def metadata(self):
        """The expected work before fitting."""
        bracket_info = []
        for s, n, r in _brackets(self.max_iter, self.aggressiveness):
            bracket_info.append({"bracket": s, "n_models": n,
                                 "partial_fit_calls": self._bracket_calls(
                                     n, r)})
        return {
            "n_models": sum(b["n_models"] for b in bracket_info),
            "partial_fit_calls": sum(b["partial_fit_calls"]
                                     for b in bracket_info),
            "brackets": bracket_info,
        }

    def _bracket_calls(self, n, r):
        eta = self.aggressiveness
        calls = n * r
        while True:
            # each rung: the top n/eta train to min(r * eta, max_iter),
            # the successive-halving controller's cap
            nk = max(1, math.floor(n / eta))
            rk = min(r * eta, self.max_iter)
            if rk == r:
                break
            calls += nk * (rk - r)
            n, r = nk, rk
        return calls

    # -- the interleaved schedule (controller hooks) ----------------------
    def _n_initial(self):
        return sum(n for _, n, _ in _brackets(self.max_iter,
                                              self.aggressiveness))

    def _sample_params(self, n):
        # per-bracket draws seeded random_state + s, as the JAX package
        # draws; ParameterSampler truncates small discrete spaces, so the
        # drawn counts set the brackets' model-id ranges
        out = []
        self._sampled_counts = []
        for s, nb, _r in _brackets(self.max_iter, self.aggressiveness):
            seed = None if self.random_state is None \
                else self.random_state + s
            drawn = list(ParameterSampler(self.parameters, nb,
                                          random_state=seed))
            self._sampled_counts.append(len(drawn))
            out.extend(drawn)
        return out

    def _reset_hook(self):
        self._bounds = []
        self._rungs = {}
        off = 0
        counts = getattr(self, "_sampled_counts", None)
        for i, (s, nb, r) in enumerate(_brackets(self.max_iter,
                                                 self.aggressiveness)):
            size = counts[i] if counts is not None else nb
            self._bounds.append((s, off, off + size, r))
            self._rungs[s] = 0
            off += size

    def _bracket_of(self, mid):
        for s, lo, hi, _r in self._bounds:
            if lo <= mid < hi:
                return s
        return None

    def _additional_calls(self, info):
        """One successive-halving step per bracket over its live
        candidates, merged into one round."""
        eta = self.aggressiveness
        out = {}
        for s, lo, hi, r in self._bounds:
            binfo = {mid: recs for mid, recs in info.items()
                     if lo <= mid < hi}
            if not binfo:
                continue
            scores = {mid: recs[-1]["score"] for mid, recs in binfo.items()}
            calls = {mid: recs[-1]["partial_fit_calls"]
                     for mid, recs in binfo.items()}
            target = min(r * (eta ** self._rungs[s]), self.max_iter)
            pending = {mid: target - calls[mid] for mid in scores
                       if calls[mid] < target}
            if pending:
                out.update(pending)
                continue
            n_keep = max(1, math.floor(len(scores) / eta))
            keep = sorted(scores, key=scores.get, reverse=True)[:n_keep]
            self._rungs[s] += 1
            next_target = min(r * (eta ** self._rungs[s]), self.max_iter)
            promote = {mid: next_target - calls[mid] for mid in keep}
            out.update({mid: c for mid, c in promote.items() if c > 0})
        return out

    def fit(self, X, y=None, **fit_params):
        super().fit(X, y, **fit_params)
        for rec in self.history_:
            rec["bracket"] = self._bracket_of(rec["model_id"])
        res = self.cv_results_
        res["bracket"] = np.asarray([self._bracket_of(mid)
                                     for mid in res["model_id"]])
        meta_brackets = []
        for s, lo, hi, _r in self._bounds:
            sel = (res["model_id"] >= lo) & (res["model_id"] < hi)
            meta_brackets.append({
                "bracket": s, "n_models": int(sel.sum()),
                "partial_fit_calls": int(res["partial_fit_calls"][sel].sum()),
            })
        self.metadata_["brackets"] = meta_brackets
        return self
