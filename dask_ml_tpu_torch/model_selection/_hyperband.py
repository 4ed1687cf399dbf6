"""HyperbandSearchCV. Counterpart of
``dask_ml_tpu/model_selection/_hyperband.py``: brackets computed from
(max_iter, aggressiveness), each a successive-halving schedule, all
interleaved through one controller fit: every adaptive round advances
the union of the live candidates of every bracket, so on the streamed
cohort plane one ``BlockStream`` pass trains the whole union (the
brackets' heterogeneous ``n_calls`` fold onto one block-step timeline).

Several processes (JAX ``_hyperband.py:208-273``): brackets are
independent successive-halving sweeps, so process p runs brackets
``bi % process_count() == p``, each as a ``SuccessiveHalvingSearchCV``
under ``disable_process_distribution`` (sampling with ``random_state +
s``, splitting with ``random_state`` like the interleaved search), and
one ``allgather_object`` merges the brackets' histories, results and
best models into identical attributes on every process. A failure in
any bracket fails every process at that exchange."""

from __future__ import annotations

import math

import numpy as np

from ..base import clone
from ._incremental import (BaseIncrementalSearchCV, _host_model,
                           _on_device, disable_process_distribution)
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

    def _hook_state(self):
        return {"_rungs": dict(self._rungs)}

    def _bracket_of(self, mid):
        for s, lo, hi, _r in self._bounds:
            if lo <= mid < hi:
                return s
        return None

    def _trial_tags(self, mid):
        """The JSONL tag of model ``mid``: its bracket (``_bounds`` is set
        once ``_reset_hook`` ran)."""
        if getattr(self, "_bounds", None):
            return {"bracket": self._bracket_of(mid)}
        return {}

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
        from ..parallel import distributed as dist

        if dist.process_count() > 1:
            return self._fit_striped(X, y, **fit_params)
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

    def _fit_striped(self, X, y=None, **fit_params):
        """The brackets striped across processes, merged by one
        ``allgather_object``."""
        from ..metrics.scorer import check_scoring
        from ..parallel import distributed as dist
        from ._successive_halving import SuccessiveHalvingSearchCV

        if _on_device(X) or _on_device(y):
            raise ValueError(
                "multi-process Hyperband requires host-resident X/y (each "
                "process loads its copy and runs a disjoint share of the "
                "brackets)")
        seed = self.random_state
        n_proc, pid = dist.process_count(), dist.process_index()
        self._dist_stats = (pid, n_proc)
        brackets = _brackets(self.max_iter, self.aggressiveness)
        payloads, local_exc = {}, None
        for bi, (s, n, r) in enumerate(brackets):
            if bi % n_proc != pid:
                continue
            sha = SuccessiveHalvingSearchCV(
                clone(self.estimator), self.parameters,
                n_initial_parameters=n, n_initial_iter=r,
                max_iter=self.max_iter, aggressiveness=self.aggressiveness,
                test_size=self.test_size, patience=self.patience,
                tol=self.tol, random_state=None if seed is None else seed + s,
                scoring=self.scoring, verbose=self.verbose,
                prefix=f"{self.prefix}bracket={s}")
            # the split of the single-process search, whatever the bracket
            sha._split_random_state = seed
            try:
                with disable_process_distribution():
                    sha.fit(X, y, **fit_params)
            except Exception as e:
                # held: the peers learn of it at the gather below
                local_exc = e
                break
            payloads[bi] = {
                "s": s, "history": sha.history_,
                "model_history": sha.model_history_,
                "results": dict(sha.cv_results_),
                "best_score": sha.best_score_,
                "best_params": sha.best_params_,
                "best_estimator": _host_model(sha.best_estimator_),
            }
        parts = dist.allgather_object({
            "payloads": {} if local_exc is not None else payloads,
            "error": None if local_exc is None else repr(local_exc)})
        if local_exc is not None:
            raise local_exc
        bad = [p["error"] for p in parts if p["error"] is not None]
        if bad:
            raise RuntimeError(
                f"peer process failed during distributed Hyperband: {bad}")
        payloads = {}
        for part in parts:
            payloads.update(part["payloads"])
        self.history_, self.model_history_ = [], {}
        all_results, meta_brackets = [], []
        best = (-np.inf, None, None)
        offset = 0
        for bi in range(len(brackets)):
            p = payloads[bi]
            s = p["s"]
            for rec in p["history"]:
                rec = dict(rec)
                rec["bracket"] = s
                rec["model_id"] = rec["model_id"] + offset
                self.history_.append(rec)
            for mid, recs in p["model_history"].items():
                self.model_history_[mid + offset] = recs
            res = p["results"]
            n_models = len(res["params"])
            res["bracket"] = np.full(n_models, s)
            res["model_id"] = res["model_id"] + offset
            all_results.append(res)
            meta_brackets.append({
                "bracket": s, "n_models": n_models,
                "partial_fit_calls": int(res["partial_fit_calls"].sum())})
            if p["best_score"] > best[0]:
                best = (p["best_score"], p["best_params"],
                        p["best_estimator"])
            offset += n_models
        keys = set().union(*(r.keys() for r in all_results))
        merged = {}
        for k in keys:
            vals = [r.get(k, np.ma.masked_all(len(r["params"]),
                                              dtype=object))
                    for r in all_results]
            if k == "params":
                merged[k] = [p for r in all_results for p in r["params"]]
            elif isinstance(vals[0], np.ma.MaskedArray):
                merged[k] = np.ma.concatenate(vals)
            else:
                merged[k] = np.concatenate(vals)
        scores = merged["test_score"]
        order = np.argsort(-scores, kind="stable")
        ranks = np.empty(len(scores), np.int32)
        ranks[order] = np.arange(1, len(scores) + 1)
        merged["rank_test_score"] = ranks
        merged["mean_test_score"] = scores
        self.cv_results_ = merged
        self.best_score_ = float(best[0])
        self.best_params_ = best[1]
        self.best_estimator_ = best[2]
        self.best_index_ = int(np.argmax(scores))
        self.scorer_ = check_scoring(self.estimator, self.scoring)
        self.n_splits_ = 1
        self.multimetric_ = False
        self.metadata_ = {
            "n_models": sum(b["n_models"] for b in meta_brackets),
            "partial_fit_calls": sum(b["partial_fit_calls"]
                                     for b in meta_brackets),
            "brackets": meta_brackets,
        }
        return self
