"""The port's splits, parameter grids and CV searches against the
reference, on the CPU.

- Splits draw from ``np.random.RandomState`` as dask_ml_tpu's do: the
  same indices, index for index.
- ParameterGrid and ParameterSampler against scikit-learn 1.9's (the JAX
  package's): the same sequence for the same random_state, over lists,
  scipy.stats distributions, and all-list grids at ratios n_iter / size
  that reach each of sample_without_replacement's three methods.
- GridSearchCV and RandomizedSearchCV against dask_ml_tpu's on one
  device (a one-device mesh: no submesh placement): the same params,
  mean_test_score within SCORE_ATOL, equal best_params_; the C-grid fast
  path against dask_ml_tpu's fast path (scores 2e-3 and coef 1e-3, the
  tolerances of tests/model_selection/test_search.py) and its fallbacks.
"""

import warnings

import numpy as np
import pytest
import scipy.stats as st

import jax
from sklearn.model_selection import ParameterGrid as SkGrid
from sklearn.model_selection import ParameterSampler as SkSampler

import dask_ml_tpu.model_selection as JMS
from dask_ml_tpu.linear_model import LogisticRegression as JLogistic
from dask_ml_tpu.linear_model import LinearRegression as JLinear
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import model_selection as TMS
from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.linear_model import LinearRegression as TLinear
from dask_ml_tpu_torch.linear_model import LogisticRegression as TLogistic
from dask_ml_tpu_torch.model_selection import _params
from dask_ml_tpu_torch.parallel.sharded import ShardedArray

SCORE_ATOL = 1e-4
N, D = 1500, 8
CS = [0.01, 0.1, 1.0, 10.0]


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _jax(fn):
    with use_mesh(device_mesh(devices=jax.devices()[:1])):
        return fn()


def _data(kind="binary", seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    if kind == "binary":
        y = X[:, 0] - X[:, 1] + 0.8 * rng.randn(n) > 0
    elif kind == "multi":
        y = np.argmax(X[:, :3] + 0.8 * rng.randn(n, 3), 1)
    else:
        y = X @ rng.randn(D) + 0.3 * rng.randn(n)
    return X, y.astype(np.float32)


# -- splits -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"test_size": 0.3, "random_state": 3},
    {"train_size": 0.5, "test_size": 0.2, "random_state": 1},
    {"shuffle": False, "test_size": 100}])
def test_train_test_split_matches_jax(kw):
    X, y = _data()
    ref = JMS.train_test_split(X, y, **{"random_state": 0, **kw})
    got = TMS.train_test_split(X, y, **{"random_state": 0, **kw})
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    dev = TMS.train_test_split(ShardedArray.from_array(X), y,
                               **{"random_state": 0, **kw})
    assert isinstance(dev[0], ShardedArray)
    np.testing.assert_array_equal(dev[0].to_numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(dev[3], np.asarray(ref[3]))


def test_kfold_and_shuffle_split_match_jax():
    X, _ = _data(n=103)
    for t_cv, j_cv in [
            (TMS.KFold(4), JMS.KFold(4)),
            (TMS.KFold(5, shuffle=True, random_state=7),
             JMS.KFold(5, shuffle=True, random_state=7)),
            (TMS.ShuffleSplit(3, test_size=0.2, random_state=2),
             JMS.ShuffleSplit(3, test_size=0.2, random_state=2))]:
        got, ref = list(t_cv.split(X)), list(j_cv.split(X))
        assert len(got) == len(ref) == t_cv.get_n_splits()
        for (gtr, gte), (rtr, rte) in zip(got, ref):
            np.testing.assert_array_equal(gtr, rtr)
            np.testing.assert_array_equal(gte, rte)
    with pytest.raises(ValueError, match="n_splits"):
        list(TMS.KFold(200).split(X))
    with pytest.raises(ValueError, match="empty"):
        TMS.train_test_split(X, test_size=0.0)

    # a PartitionedFrame splits as JAX's does: blockwise per partition,
    # or one permutation of the whole frame
    import pandas as pd

    from dask_ml_tpu.parallel.frames import from_pandas as j_from_pandas
    from dask_ml_tpu_torch.parallel.frames import from_pandas

    df = pd.DataFrame({"a": np.arange(50.0), "b": np.arange(50.0) * 2})
    for blockwise in (True, False):
        got = TMS.train_test_split(from_pandas(df, 3), test_size=0.2,
                                   random_state=5, blockwise=blockwise)
        ref = JMS.train_test_split(j_from_pandas(df, 3), test_size=0.2,
                                   random_state=5, blockwise=blockwise)
        for g, r in zip(got, ref):
            assert [len(p) for p in g.partitions] == \
                [len(p) for p in r.partitions]
            pd.testing.assert_frame_equal(g.compute(), r.compute())


# -- parameter grids and samplers ----------------------------------------

def test_parameter_grid_matches_sklearn():
    for grid in ({"b": [1, 2, 3], "a": ["x", "y"], "c": [0.5]},
                 [{"kernel": ["linear"]}, {"kernel": ["rbf"], "g": [1, 10]}],
                 {}):
        got, ref = _params.ParameterGrid(grid), SkGrid(grid)
        assert list(got) == list(ref) and len(got) == len(ref)
        assert [got[i] for i in range(len(ref))] == list(ref)
    with pytest.raises(TypeError, match="needs to be a list"):
        _params.ParameterGrid({"a": 1})
    with pytest.raises(ValueError, match="non-empty"):
        _params.ParameterGrid({"a": []})
    with pytest.raises(IndexError):
        _params.ParameterGrid({"a": [1]})[1]


# all-list grids of 2000 points: ratios below 0.01 and at 0.01 take
# tracking selection, 0.01-0.99 a permutation's head, 0.99 and above
# reservoir sampling (n_iter past the grid warns and truncates)
@pytest.mark.parametrize("n_iter", [5, 20, 21, 700, 1980, 1999, 2000, 2400])
@pytest.mark.parametrize("seed", [0, 11])
def test_parameter_sampler_lists_match_sklearn(n_iter, seed):
    grid = {"a": list(range(50)), "b": list(range(40))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = list(_params.ParameterSampler(grid, n_iter, random_state=seed))
        ref = list(SkSampler(grid, n_iter, random_state=seed))
    assert got == ref


def test_parameter_sampler_distributions_match_sklearn():
    dists = {"alpha": st.loguniform(1e-5, 1e-1), "eta0": [0.01, 0.1, 1.0],
             "l1_ratio": st.uniform(0, 1), "n": st.randint(1, 9)}
    for space in (dists, [dists, {"alpha": st.norm()}]):
        got = list(_params.ParameterSampler(space, 25, random_state=4))
        ref = list(SkSampler(space, 25, random_state=4))
        assert got == ref
        assert len(_params.ParameterSampler(space, 25)) == 25
    rng_a, rng_b = np.random.RandomState(2), np.random.RandomState(2)
    assert list(_params.ParameterSampler(dists, 5, random_state=rng_a)) == \
        list(SkSampler(dists, 5, random_state=rng_b))
    with pytest.warns(UserWarning, match="smaller than n_iter"):
        assert len(list(_params.ParameterSampler({"a": [1, 2]}, 5))) == 2


# -- grid and randomized search ------------------------------------------

def _compare(got, ref, atol=SCORE_ATOL):
    assert got.cv_results_["params"] == ref.cv_results_["params"]
    for key in ref.cv_results_:
        if key.startswith(("mean_test", "split", "mean_train")):
            np.testing.assert_allclose(got.cv_results_[key],
                                       ref.cv_results_[key], atol=atol,
                                       err_msg=key)
    assert got.best_params_ == ref.best_params_
    assert got.best_index_ == ref.best_index_


@pytest.mark.parametrize("scheduler", ["synchronous", None])
def test_grid_search_general_path_matches_jax(scheduler):
    X, y = _data()
    grid = {"C": CS, "intercept_scaling": [1.0]}
    kw = dict(cv=3, return_train_score=True, scheduler=scheduler)
    ref = _jax(lambda: JMS.GridSearchCV(
        JLogistic(solver="lbfgs", max_iter=50), grid, **kw).fit(X, y))
    got = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=50), grid,
                           **kw).fit(X, y)
    assert not hasattr(got, "_c_grid_vmapped_")
    _compare(got, ref)
    np.testing.assert_allclose(got.best_estimator_.coef_,
                               ref.best_estimator_.coef_, atol=1e-3)
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))
    assert got.score(X, y) == pytest.approx(ref.score(X, y), abs=1e-6)


def test_randomized_search_matches_jax():
    X, y = _data("regression", seed=2)
    space = {"C": st.loguniform(1e-3, 1e2), "fit_intercept": [True, False]}
    kw = dict(n_iter=5, random_state=3, cv=TMS.KFold(3, shuffle=True,
                                                      random_state=1))
    jkw = dict(kw, cv=JMS.KFold(3, shuffle=True, random_state=1))
    ref = _jax(lambda: JMS.RandomizedSearchCV(
        JLinear(solver="lbfgs", max_iter=50), space, scoring="r2",
        **jkw).fit(X, y))
    got = TMS.RandomizedSearchCV(TLinear(solver="lbfgs", max_iter=50), space,
                                 scoring="r2", **kw).fit(X, y)
    _compare(got, ref)


@pytest.mark.parametrize("kind", ["binary", "multi"])
def test_c_grid_fast_path_matches_jax(kind):
    X, y = _data(kind, seed=4)
    est = dict(solver="lbfgs", max_iter=60)
    ref = _jax(lambda: JMS.GridSearchCV(JLogistic(**est), {"C": CS},
                                        cv=3).fit(X, y))
    got = TMS.GridSearchCV(TLogistic(**est), {"C": CS}, cv=3).fit(X, y)
    assert got._c_grid_vmapped_ == ref._c_grid_vmapped_ == len(CS)
    _compare(got, ref, atol=2e-3)
    np.testing.assert_allclose(got.best_estimator_.coef_,
                               ref.best_estimator_.coef_, atol=1e-3)
    # the stacked solve's clones against dask_ml_tpu's: coefficients,
    # each candidate's own iteration count, the joint budget
    models = TLogistic(**est)._fit_C_grid(X, y, CS)
    jmodels = _jax(lambda: JLogistic(**est)._fit_C_grid(X, y, CS))
    for m, jm in zip(models, jmodels):
        np.testing.assert_allclose(m.coef_, jm.coef_, atol=1e-3)
        np.testing.assert_allclose(m.intercept_, jm.intercept_, atol=1e-3)
        np.testing.assert_array_equal(m.classes_, jm.classes_)
        assert m.n_iter_ == jm.n_iter_
        assert m.solver_info_["n_iter_per_candidate"] == \
            jm.solver_info_["n_iter_per_candidate"]


def test_c_grid_fast_path_fallbacks():
    X, y = _data(seed=5, n=600)
    # ineligible solvers, penalties and grids take the general path
    for est, grid in [
            (TLogistic(solver="newton", max_iter=20), {"C": [0.1, 1.0]}),
            (TLogistic(solver="proximal_grad", penalty="l1", max_iter=20),
             {"C": [0.1, 1.0]}),
            (TLogistic(solver="lbfgs", max_iter=20), {"C": [1.0]}),
            (TLogistic(solver="lbfgs", max_iter=20), {"C": [-1.0, 1.0]})]:
        s = TMS.GridSearchCV(est, grid, cv=2, refit=False,
                             error_score=np.nan).fit(X, y)
        assert not hasattr(s, "_c_grid_vmapped_")
    # a later fold whose train split has one class: the earlier folds'
    # cells are reset, and the general path scores every candidate
    y1 = y.copy()
    y1[: len(y) // 2] = 0.0
    cv = [(np.arange(len(y) // 2, len(y)), np.arange(len(y) // 2)),
          (np.arange(len(y) // 2), np.arange(len(y) // 2, len(y)))]

    class Fixed:
        def split(self, X, y=None):
            return iter(cv)

    s = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=20),
                         {"C": [0.1, 1.0]}, cv=Fixed(), refit=False,
                         error_score=-1.0).fit(X, y1)
    assert not hasattr(s, "_c_grid_vmapped_")
    assert (s.cv_results_["split1_test_score"] == -1.0).all()
    assert np.isfinite(s.cv_results_["split0_test_score"]).all()

    # a failing stacked solve warns, records why, and falls back
    class Broken(TLogistic):
        def _fit_C_grid(self, X, y, Cs):
            raise FloatingPointError("diverged")

    with pytest.warns(RuntimeWarning, match="C-grid fast path failed"):
        s = TMS.GridSearchCV(Broken(solver="lbfgs", max_iter=20),
                             {"C": [0.1, 1.0]}, cv=2).fit(X, y)
    assert "diverged" in s._c_grid_fallback_
    assert np.isfinite(s.cv_results_["mean_test_score"]).all()


def test_multimetric_scoring_matches_jax():
    X, y = _data(seed=6)
    grid = {"C": [0.05, 5.0], "intercept_scaling": [1.0]}
    scoring = ["accuracy", "roc_auc", "neg_log_loss"]
    ref = _jax(lambda: JMS.GridSearchCV(
        JLogistic(solver="lbfgs", max_iter=40), grid, scoring=scoring,
        refit="roc_auc", cv=2).fit(X, y))
    got = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=40), grid,
                           scoring=scoring, refit="roc_auc", cv=2).fit(X, y)
    for name in scoring:
        np.testing.assert_allclose(got.cv_results_[f"mean_test_{name}"],
                                   ref.cv_results_[f"mean_test_{name}"],
                                   atol=SCORE_ATOL)
        np.testing.assert_array_equal(got.cv_results_[f"rank_test_{name}"],
                                      ref.cv_results_[f"rank_test_{name}"])
    assert got.best_params_ == ref.best_params_ and got.multimetric_
    assert got.score(X, y) == pytest.approx(ref.score(X, y), abs=1e-5)
    s = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=40), grid,
                         scoring={"acc": "accuracy"}, refit=False,
                         cv=2).fit(X, y)
    assert "mean_test_acc" in s.cv_results_ and not hasattr(s, "best_params_")
    with pytest.raises(AttributeError, match="refit"):
        s.predict(X)
    with pytest.raises(ValueError, match="refit to name"):
        TMS.GridSearchCV(TLogistic(), grid, scoring=scoring,
                         refit="f1").fit(X, y)


def test_threads_run_under_the_callers_config():
    """n_jobs=2 threads each run a fit under config.set(device="cpu"):
    a worker on the default config would ask for the card and raise."""
    X, y = _data(seed=7, n=400)
    grid = {"C": [0.1, 1.0, 10.0], "intercept_scaling": [1.0]}
    threads = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=30), grid,
                               cv=2, n_jobs=2).fit(X, y)
    seq = TMS.GridSearchCV(TLogistic(solver="lbfgs", max_iter=30), grid,
                           cv=2, scheduler="synchronous").fit(X, y)
    np.testing.assert_array_equal(threads.cv_results_["mean_test_score"],
                                  seq.cv_results_["mean_test_score"])
    with pytest.raises(ValueError, match="n_jobs"):
        TMS.GridSearchCV(TLogistic(), grid, n_jobs=0).fit(X, y)
    with pytest.raises(ValueError, match="scheduler"):
        TMS.GridSearchCV(TLogistic(), grid, scheduler="dask").fit(X, y)


class _Center(BaseEstimator):
    """A duck-typed transformer: subtract the column means of fit."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def fit(self, X, y=None):
        self.mean_ = np.asarray(X).mean(0)
        return self

    def transform(self, X):
        return ((np.asarray(X) - self.mean_) * self.scale).astype(np.float32)


class _Pipe(BaseEstimator):
    """The duck-typed pipeline both packages' searches recognise."""

    def __init__(self, steps):
        self.steps = steps

    @property
    def named_steps(self):
        return dict(self.steps)

    def get_params(self, deep=True):
        out = {"steps": self.steps}
        if deep:
            for name, step in self.steps:
                for k, v in step.get_params(deep=False).items():
                    out[f"{name}__{k}"] = v
        return out

    def set_params(self, **params):
        for key, value in params.items():
            name, _, sub = key.partition("__")
            self.named_steps[name].set_params(**{sub: value})
        return self

    def _xt(self, X):
        for _, step in self.steps[:-1]:
            X = step.transform(X)
        return X

    def fit(self, X, y):
        for _, step in self.steps[:-1]:
            X = step.fit(X, y).transform(X)
        self.steps[-1][1].fit(X, y)
        return self

    def predict(self, X):
        return self.steps[-1][1].predict(self._xt(X))

    def score(self, X, y):
        return self.steps[-1][1].score(self._xt(X), y)


def test_pipeline_prefix_memo_and_c_grid_match_jax():
    X, y = _data(seed=8, n=800)
    X = X + 3.0

    def search(logistic, grid):
        pipe = _Pipe([("center", _Center()),
                      ("lr", logistic(solver="lbfgs", max_iter=40))])
        return pipe, grid

    for grid in ({"lr__C": [0.1, 1.0, 10.0]},
                 {"lr__C": [0.1, 1.0], "center__scale": [1.0, 0.5]}):
        ref = _jax(lambda: JMS.GridSearchCV(*search(JLogistic, grid),
                                            cv=2).fit(X, y))
        got = TMS.GridSearchCV(*search(TLogistic, grid), cv=2).fit(X, y)
        _compare(got, ref, atol=2e-3)
        assert hasattr(got, "_c_grid_vmapped_") == \
            hasattr(ref, "_c_grid_vmapped_")
        assert got._memo_stats == ref._memo_stats
