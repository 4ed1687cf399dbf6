"""Drop-in CV search: GridSearchCV / RandomizedSearchCV.

Counterpart of ``dask_ml_tpu/model_selection/_search.py``:

1. ``_CVCache``: each fold's train/test arrays extracted once and shared
   by every candidate (a device gather for a ShardedArray).
2. ``_PrefixMemo``: a duck-typed pipeline's fitted transformer prefixes,
   and their outputs, cached per (fold, token chain) and shared.
3. The C-grid fast path: a grid varying only a GLM's ``C`` (bare, or as
   a pipeline's last step) solves all candidates in one stacked L-BFGS
   solve per fold (``_GLMBase._fit_C_grid``).

Execution: ``scheduler``/``n_jobs`` keep their meaning. Threads (the
default) run the (candidate, fold) tasks in a pool, each task under the
caller's configuration (``config.in_caller_config``: the configuration
is thread-local, and a worker would otherwise place data on the default
device); ``"synchronous"`` runs them in order. Pipelines run in order.

Several processes (``parallel/distributed.py``): every process loads its
copy of the host X and y, takes the (candidate, fold) tasks
``tasks[process_index()::process_count()]`` and fits them inside
``distributed.local_section`` on its own card (a trial's fit never
enters a collective its peers would not join); an exception is
exchanged before the merge, so every process fails fast; the score
grids merge by one ``allgather_host`` (each cell filled by exactly one
process) into identical ``cv_results_``, and every process refits the
same best candidate. The C-grid fast path stays off. A device array
(``ShardedArray``) is refused: its rows cannot be split into
per-process trials.

Not ported: the JAX package's submesh placement of concurrent trials
(``_submeshes``) has no counterpart on one device.
"""

from __future__ import annotations

import numbers
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..base import BaseEstimator, clone
from ..config import in_caller_config
from ..parallel.sharded import ShardedArray
from ..metrics.scorer import (_default_scorer, _MetricScorer, check_scoring,
                              clear_host_fold_cache, get_scorer)
from ._normalize import estimator_token
from ._params import ParameterGrid, ParameterSampler
from ._split import KFold, take_rows


def _is_pipeline(est):
    return hasattr(est, "steps") and hasattr(est, "named_steps")


def _resolve_scorers(estimator, scoring, refit):
    """({name: scorer}, multimetric): a list or dict of scorers gives
    ``mean_test_<name>`` columns, ``refit`` naming the selection metric."""
    if scoring is None or callable(scoring) or isinstance(scoring, str):
        return {"score": check_scoring(estimator, scoring)}, False
    if isinstance(scoring, (list, tuple, set)):
        scoring = {name: name for name in scoring}
    if not isinstance(scoring, dict) or not scoring:
        raise ValueError(f"cannot interpret scoring={scoring!r}")
    scorers = {name: get_scorer(sc) for name, sc in scoring.items()}
    if refit not in (False, None) and refit not in scorers:
        raise ValueError(
            f"multimetric scoring requires refit to name one of "
            f"{sorted(scorers)} (or refit=False); got {refit!r}"
        )
    return scorers, True


def check_cv(cv=None):
    if cv is None:
        return KFold(n_splits=5)
    if isinstance(cv, numbers.Integral):
        return KFold(n_splits=int(cv))
    if hasattr(cv, "split"):
        return cv
    raise ValueError(f"cannot interpret cv={cv!r}")


class _CVCache:
    """Fold extraction. ``cache=True`` keeps each fold's arrays for every
    candidate; ``cache=False`` extracts them again at each use."""

    def __init__(self, X, y, cv, cache=True):
        self._X, self._y = X, y
        self._splits = list(cv.split(X, y))
        self._cache = {} if cache else None
        self.n_folds = len(self._splits)

    def fold(self, fi):
        if self._cache is not None and fi in self._cache:
            return self._cache[fi]
        train_idx, test_idx = self._splits[fi]
        out = (take_rows(self._X, train_idx), take_rows(self._y, train_idx),
               take_rows(self._X, test_idx), take_rows(self._y, test_idx))
        if self._cache is not None:
            self._cache[fi] = out
        return out


class _PrefixMemo:
    """Fitted-pipeline-prefix cache; pipelines run in order, so no lock."""

    def __init__(self):
        self._memo = {}
        self.hits = 0
        self.misses = 0

    def _get_or_compute(self, key, compute):
        cached = self._memo.get(key)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        value = self._memo[key] = compute()
        return value

    def fit_prefix(self, steps, fold_id, X, y):
        """Fit-transform the transformer steps, sharing cached fitted
        prefixes and outputs; returns ([(name, step)], Xt, key)."""
        key = (fold_id,)
        Xt = X
        fitted_steps = []
        for name, step in steps:
            key = key + (estimator_token(step),)

            def fit_one(step=step, Xt_in=Xt):
                est = clone(step)
                if hasattr(est, "fit_transform"):
                    return est, est.fit_transform(Xt_in, y)
                return est, est.fit(Xt_in, y).transform(Xt_in)

            est, Xt = self._get_or_compute(key, fit_one)
            fitted_steps.append((name, est))
        return fitted_steps, Xt, key

    def fit_pipeline(self, pipe, fold_id, X, y):
        fitted_steps, Xt, key = self.fit_prefix(pipe.steps[:-1], fold_id,
                                                X, y)
        name, step = pipe.steps[-1]
        key = key + (estimator_token(step),)

        def fit_last(step=step, Xt_in=Xt):
            est = clone(step)
            est.fit(Xt_in, y)
            return est

        fitted = clone(pipe)
        fitted.steps = fitted_steps + [(name,
                                        self._get_or_compute(key, fit_last))]
        return fitted


class _BaseSearchCV(BaseEstimator):
    # candidates whose mean selection score lies within tie_tol of the
    # best are tied and the earliest in grid order wins, so the stacked
    # C-grid solve and per-candidate fits (which agree to the solver's
    # tolerance) pick the same winner; set 0.0 for an exact argmax
    tie_tol = 1e-3

    def __init__(self, estimator, scoring=None, cv=None, refit=True,
                 error_score="raise", return_train_score=False,
                 cache_cv=True, scheduler=None, n_jobs=-1):
        self.estimator = estimator
        self.scoring = scoring
        self.cv = cv
        self.refit = refit
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.cache_cv = cache_cv
        self.scheduler = scheduler
        self.n_jobs = n_jobs

    def _candidates(self):
        raise NotImplementedError

    def _resolve_execution(self, n_tasks):
        """Workers: 'threads'/None a thread pool (``n_jobs``, -1 = up to
        8), 'sync'/'synchronous' the sequential loop."""
        scheduler = self.scheduler
        if scheduler in (None, "threads", "threading"):
            n_jobs = self.n_jobs
            if n_jobs in (None, -1):
                return min(8, n_tasks) or 1
            if n_jobs < 1:
                raise ValueError(f"n_jobs must be -1 or >=1, got {n_jobs}")
            return min(int(n_jobs), n_tasks) or 1
        if scheduler in ("sync", "synchronous", "single-threaded"):
            return 1
        raise ValueError(
            f"scheduler={scheduler!r} not supported; use None, 'threads' "
            f"or 'synchronous'"
        )

    def fit(self, X, y=None, **fit_params):
        try:
            return self._fit(X, y, **fit_params)
        finally:
            # fold copies must not outlive the search, even a failed one
            clear_host_fold_cache()

    def _try_C_grid_fast(self, candidates, cache, scorers, scores,
                         train_scores, n_folds, fit_params, memo):
        """True iff every (candidate, fold) score came from the stacked
        C-grid solve; False leaves the grids NaN for the general path.

        Eligible: a bare GLM with a pure-``C`` grid, or a pipeline whose
        last step is a GLM with a pure ``<last>__C`` grid (its prefix
        fitted once per fold through ``memo``, the GLM scored on the
        transformed folds, which only prediction-only scorers allow).
        The stacked L-BFGS advances all candidates until the slowest
        converges; each clone reports its own ``n_iter_``."""
        from ..models.glm import _GLMBase

        est = self.estimator
        pipeline_mode = (_is_pipeline(est) and len(est.steps) >= 2
                         and isinstance(est.steps[-1][1], _GLMBase))
        if pipeline_mode:
            if not all(isinstance(sc, _MetricScorer)
                       or sc is _default_scorer for sc in scorers.values()):
                return False
            c_key = f"{est.steps[-1][0]}__C"
            glm = est.steps[-1][1]
        elif isinstance(est, _GLMBase):
            c_key = "C"
            glm = est
        else:
            return False
        from ..parallel.distributed import process_count

        if (fit_params or process_count() > 1 or len(candidates) < 2
                or any(set(p) != {c_key} for p in candidates)):
            return False
        Cs = [p[c_key] for p in candidates]
        if not all(isinstance(c, numbers.Real) and c > 0 for c in Cs):
            return False

        def reset():
            for grid in (scores, train_scores or {}):
                for arr in grid.values():
                    arr[:] = np.nan

        try:
            for fi in range(n_folds):
                Xtr, ytr, Xte, yte = cache.fold(fi)
                if pipeline_mode:
                    prefix, Xtr, _ = memo.fit_prefix(est.steps[:-1], fi,
                                                     Xtr, ytr)
                    for _, t in prefix:
                        Xte = t.transform(Xte)
                models = glm._fit_C_grid(Xtr, ytr, Cs)
                if models is None:
                    # a later fold can be ineligible (a single-class
                    # train split): no partial cells may leak
                    reset()
                    return False
                for ci, m in enumerate(models):
                    for name, sc in scorers.items():
                        scores[name][ci, fi] = sc(m, Xte, yte)
                    if train_scores is not None:
                        for name, sc in scorers.items():
                            train_scores[name][ci, fi] = sc(m, Xtr, ytr)
        except Exception as exc:
            # fall back, but loudly: a fast-path defect must show
            warnings.warn(
                f"C-grid fast path failed ({type(exc).__name__}: {exc}); "
                "falling back to per-candidate fits", RuntimeWarning,
            )
            self._c_grid_fallback_ = repr(exc)
            reset()
            return False
        self._c_grid_vmapped_ = len(Cs)
        return True

    def _fit(self, X, y=None, **fit_params):
        for attr in ("_c_grid_vmapped_", "_c_grid_fallback_"):
            if hasattr(self, attr):
                delattr(self, attr)
        candidates = list(self._candidates())
        if not candidates:
            raise ValueError("no parameter candidates")
        cv = check_cv(self.cv)
        scorers, multimetric = _resolve_scorers(self.estimator, self.scoring,
                                                self.refit)
        cache = _CVCache(X, y, cv, cache=self.cache_cv)
        memo = _PrefixMemo()
        n_folds = cache.n_folds
        scores = {name: np.full((len(candidates), n_folds), np.nan)
                  for name in scorers}
        train_scores = (
            {name: np.full((len(candidates), n_folds), np.nan)
             for name in scorers}
            if self.return_train_score else None
        )

        def run_task(ci, fi):
            Xtr, ytr, Xte, yte = cache.fold(fi)
            est = clone(self.estimator).set_params(**candidates[ci])
            try:
                if _is_pipeline(est):
                    est = memo.fit_pipeline(est, fi, Xtr, ytr)
                else:
                    est.fit(Xtr, ytr, **fit_params)
                for name, sc in scorers.items():
                    scores[name][ci, fi] = sc(est, Xte, yte)
                if self.return_train_score:
                    for name, sc in scorers.items():
                        train_scores[name][ci, fi] = sc(est, Xtr, ytr)
            except Exception:
                if self.error_score == "raise":
                    raise
                for name in scorers:
                    scores[name][ci, fi] = self.error_score

        tasks = [(ci, fi) for ci in range(len(candidates))
                 for fi in range(n_folds)]
        if self._try_C_grid_fast(candidates, cache, scorers, scores,
                                 train_scores, n_folds, fit_params, memo):
            tasks = []
        from ..parallel import distributed as dist

        n_proc = dist.process_count()
        if n_proc > 1:
            if isinstance(X, ShardedArray) or isinstance(y, ShardedArray):
                raise ValueError(
                    "a multi-process search requires host-resident X/y "
                    "(each process loads its copy and fits a disjoint "
                    "share of the trials); a ShardedArray cannot be split "
                    "into per-process trials")
            tasks = tasks[dist.process_index()::n_proc]
            self._dist_stats = (len(tasks), len(candidates) * n_folds,
                                dist.process_index(), n_proc)

        def local_task(ci, fi):
            with dist.local_section():
                run_task(ci, fi)

        local_exc = None
        try:
            # pipelines run in order: the prefix memo's outputs are shared
            workers = 1 if _is_pipeline(self.estimator) \
                else self._resolve_execution(len(tasks))
            if workers == 1:
                for ci, fi in tasks:
                    local_task(ci, fi)
            else:
                # folds are extracted before the pool starts, so no worker
                # races another to fill the cache
                for fi in range(n_folds):
                    cache.fold(fi)
                task = in_caller_config(local_task)
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    futures = [pool.submit(task, ci, fi)
                               for ci, fi in tasks]
                    for f in futures:
                        f.result()  # the first error_score='raise'
        except Exception as exc:
            if n_proc == 1:
                raise
            local_exc = exc
        if n_proc > 1:
            # the failure exchange: a process that raised fails every
            # process before the merge, so none waits in it forever
            errs = dist.allgather_object(
                None if local_exc is None else repr(local_exc))
            if local_exc is not None:
                raise local_exc
            bad = [e for e in errs if e is not None]
            if bad:
                raise RuntimeError(
                    f"peer process failed during distributed search: {bad}")

            def merge(local):
                stacked = dist.allgather_host(local)  # (P, C, F)
                filled = ~np.isnan(stacked)
                return np.where(filled.any(axis=0),
                                np.nansum(np.where(filled, stacked, 0.0),
                                          axis=0), np.nan)

            scores = {name: merge(a) for name, a in scores.items()}
            if train_scores is not None:
                train_scores = {name: merge(a)
                                for name, a in train_scores.items()}

        results = {"params": candidates}
        means = {}
        for name, arr in scores.items():
            suffix = name if multimetric else "score"
            mean = arr.mean(axis=1)
            means[name] = mean
            order = np.argsort(-mean, kind="stable")
            ranks = np.empty(len(candidates), np.int32)
            ranks[order] = np.arange(1, len(candidates) + 1)
            results[f"mean_test_{suffix}"] = mean
            results[f"std_test_{suffix}"] = arr.std(axis=1)
            results[f"rank_test_{suffix}"] = ranks
            for fi in range(n_folds):
                results[f"split{fi}_test_{suffix}"] = arr[:, fi]
            if self.return_train_score:
                tarr = train_scores[name]
                results[f"mean_train_{suffix}"] = tarr.mean(axis=1)
                results[f"std_train_{suffix}"] = tarr.std(axis=1)
                for fi in range(n_folds):
                    results[f"split{fi}_train_{suffix}"] = tarr[:, fi]
        for key in sorted({k for p in candidates for k in p}):
            results[f"param_{key}"] = np.ma.masked_all(len(candidates),
                                                       dtype=object)
            for ci, p in enumerate(candidates):
                if key in p:
                    results[f"param_{key}"][ci] = p[key]
        self.cv_results_ = results
        # the selection metric: the one scorer, or the one refit names
        # (multimetric with refit=False sets no best_*)
        sel = self.refit if multimetric else "score"
        if sel in means:
            sel_mean = means[sel]
            best = np.nanmax(sel_mean) if np.isfinite(sel_mean).any() \
                else np.nan
            tied = np.flatnonzero(sel_mean >= best - float(self.tie_tol))
            self.best_index_ = (int(tied[0]) if tied.size
                                else int(np.argmax(sel_mean)))
            self.best_score_ = float(sel_mean[self.best_index_])
            self.best_params_ = candidates[self.best_index_]
        self.n_splits_ = n_folds
        self.scorer_ = scorers if multimetric else scorers["score"]
        self.multimetric_ = multimetric
        self._memo_stats = (memo.hits, memo.misses)
        if self.refit:
            # several processes: every process refits the same candidate
            # on its own card (identical cv_results_, identical choice)
            with dist.local_section():
                est = clone(self.estimator).set_params(**self.best_params_)
                est.fit(X, y, **fit_params)
            self.best_estimator_ = est
        return self

    # -- delegation to best_estimator_ ------------------------------------
    def _check_refit(self, method):
        if not self.refit:
            raise AttributeError(f"{method} is only available when "
                                 "refit=True")

    def predict(self, X):
        self._check_refit("predict")
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        self._check_refit("predict_proba")
        return self.best_estimator_.predict_proba(X)

    def transform(self, X):
        self._check_refit("transform")
        return self.best_estimator_.transform(X)

    def decision_function(self, X):
        self._check_refit("decision_function")
        return self.best_estimator_.decision_function(X)

    def score(self, X, y=None):
        if hasattr(self, "scorer_") and self.scoring is not None:
            if getattr(self, "multimetric_", False):
                self._check_refit("score")  # refit names the metric
                return self.scorer_[self.refit](self.best_estimator_, X, y)
            return self.scorer_(self.best_estimator_, X, y)
        self._check_refit("score")
        return self.best_estimator_.score(X, y)

    @property
    def classes_(self):
        return self.best_estimator_.classes_


class GridSearchCV(_BaseSearchCV):
    """Ref: dask_ml/model_selection/_search.py::GridSearchCV."""

    def __init__(self, estimator, param_grid, scoring=None, cv=None,
                 refit=True, error_score="raise", return_train_score=False,
                 cache_cv=True, scheduler=None, n_jobs=-1):
        super().__init__(estimator, scoring=scoring, cv=cv, refit=refit,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         cache_cv=cache_cv, scheduler=scheduler,
                         n_jobs=n_jobs)
        self.param_grid = param_grid

    def _candidates(self):
        return ParameterGrid(self.param_grid)


class RandomizedSearchCV(_BaseSearchCV):
    """Ref: dask_ml/model_selection/_search.py::RandomizedSearchCV."""

    def __init__(self, estimator, param_distributions, n_iter=10,
                 random_state=None, scoring=None, cv=None, refit=True,
                 error_score="raise", return_train_score=False,
                 cache_cv=True, scheduler=None, n_jobs=-1):
        super().__init__(estimator, scoring=scoring, cv=cv, refit=refit,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         cache_cv=cache_cv, scheduler=scheduler,
                         n_jobs=n_jobs)
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _candidates(self):
        return ParameterSampler(self.param_distributions, self.n_iter,
                                random_state=self.random_state)
