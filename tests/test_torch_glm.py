"""The port's GLMs (dask_ml_tpu_torch) against dask_ml_tpu on the same
data, on the CPU: the same inputs, made with numpy.random.RandomState,
fitted by both packages. The port runs with device="cpu", where its
kernel-backed loss runs the kernel's plain version."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu_torch import config, convert
import dask_ml_tpu_torch.linear_model as T


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(family, seed=0, n=3000, d=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d) / np.sqrt(d)
    eta = X @ beta + 0.3
    if family == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(np.exp(0.5 * eta)).astype(np.float32)
    else:
        y = (eta + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


# The gap in n_iter_ measured between the two packages on this data at
# tol=1e-8. Below float32 resolution the stopping test is decided by
# rounding noise: proximal_grad's backtracking collapses its step towards
# 1e-20 once no step shows a decrease in f32, which ends the loop with a
# zero residual — at iteration 14 in dask_ml_tpu, at 46 in the port.
# gradient_descent's gradient norm stalls near 4e-5 in dask_ml_tpu and
# both run to max_iter here (at tol=1e-6 the port reaches it at 55, JAX
# not in 100). At tolerances the solvers resolve (1e-5 and above on this
# data) the counts agree exactly (test_n_iter_matches_jax).
N_ITER_GAP = {"lbfgs": 0, "gradient_descent": 0, "proximal_grad": 32}
COEF_ATOL = 5e-4


def _assert_same_predictions(t, j, X):
    """Equal predictions, except on rows whose JAX decision value is
    within what COEF_ATOL lets the decision value move (|x|_1 + 1 times
    it): there the sign is float noise."""
    pt, pj = t.predict(X), j.predict(X)
    diff = np.flatnonzero(pt != pj)
    edge = COEF_ATOL * (np.abs(X[diff]).sum(1) + 1.0)
    assert np.all(np.abs(j.decision_function(X)[diff]) <= edge), diff


@pytest.mark.parametrize("solver,kw", [
    ("lbfgs", {}),
    ("gradient_descent", {}),
    ("proximal_grad", {"penalty": "l1", "C": 0.05}),
])
def test_logistic_matches_jax(solver, kw):
    X, y = _data("logistic")
    j = J.LogisticRegression(solver=solver, max_iter=100, tol=1e-8,
                             **kw).fit(X, y)
    t = T.LogisticRegression(solver=solver, max_iter=100, tol=1e-8,
                             **kw).fit(X, y)
    assert t.solver_info_["kernel"] == "fused_glm_value_grad"
    # 5e-4: the tolerance of the fused-kernel parity in
    # tests/test_pallas_glm.py:30 (float32 solves of the same objective)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    _assert_same_predictions(t, j, X)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    assert abs(t.n_iter_ - j.n_iter_) <= N_ITER_GAP[solver]


@pytest.mark.parametrize("tol", [1e-5, 1e-4])
@pytest.mark.parametrize("solver,kw", [
    ("lbfgs", {}),
    ("gradient_descent", {}),
    ("proximal_grad", {"penalty": "l1", "C": 0.05}),
])
def test_n_iter_matches_jax(solver, kw, tol):
    X, y = _data("logistic")
    j = J.LogisticRegression(solver=solver, max_iter=100, tol=tol,
                             **kw).fit(X, y)
    t = T.LogisticRegression(solver=solver, max_iter=100, tol=tol,
                             **kw).fit(X, y)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)


@pytest.mark.parametrize("family,J_est,T_est", [
    ("normal", J.LinearRegression, T.LinearRegression),
    ("poisson", J.PoissonRegression, T.PoissonRegression),
])
def test_regressions_match_jax(family, J_est, T_est):
    X, y = _data(family, seed=1)
    j = J_est(solver="lbfgs", max_iter=60, tol=1e-8).fit(X, y)
    t = T_est(solver="lbfgs", max_iter=60, tol=1e-8).fit(X, y)
    # same 5e-4 as above; predictions are continuous, compared at 1e-3
    # relative (exp of a 5e-4 error in eta for Poisson)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=5e-4)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=5e-4)
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-3,
                               atol=1e-3)
    assert abs(t.score(X, y) - j.score(X, y)) < 1e-4
    assert t.n_iter_ == j.n_iter_


def test_kernel_flavor_matches_plain_loss():
    """The kernel-backed loss (its plain version on the CPU) and the
    plain autograd loss are the same objective: 1e-5 apart."""
    X, y = _data("logistic", seed=2)
    a = T.LogisticRegression(solver="lbfgs", max_iter=50, tol=1e-8).fit(X, y)
    b = T.LogisticRegression(solver="lbfgs", max_iter=50, tol=1e-8,
                             solver_kwargs={"use_kernel": False}).fit(X, y)
    assert b.solver_info_["kernel"] is None
    np.testing.assert_allclose(a.coef_, b.coef_, atol=1e-5)


def test_bf16_design_matches_jax():
    """fit_dtype="bfloat16" casts the design to bf16 in both packages
    (bf16 operands, f32 sums); 5e-3 absorbs the bf16 rounding of the
    residual at different iterates."""
    X, y = _data("logistic", seed=3)
    with jconfig.set(dtype="bfloat16"):
        j = J.LogisticRegression(solver="lbfgs", max_iter=40).fit(X, y)
    t = T.LogisticRegression(solver="lbfgs", max_iter=40,
                             fit_dtype="bfloat16").fit(X, y)
    assert t.fit_dtype_ == j.fit_dtype_ == "bfloat16"
    np.testing.assert_allclose(t.coef_, j.coef_, atol=5e-3)
    assert np.mean(t.predict(X) == j.predict(X)) > 0.995


def test_shape_gate_is_recorded():
    """The kernel takes every width: a design wider than one warp's share
    of shared memory would hold keeps it, and only use_kernel=False takes
    the plain loss, which solver_info_ says, to the same fit."""
    X, y = _data("logistic", seed=4, n=500, d=12)
    wide = np.repeat(X, 120, axis=1)[:, :1400]
    t = T.LogisticRegression(solver="lbfgs", max_iter=20).fit(wide, y)
    assert t.solver_info_["kernel"] == "fused_glm_value_grad"
    assert t.solver_info_["kernel_reason"] is None
    p = T.LogisticRegression(solver="lbfgs", max_iter=20,
                             solver_kwargs={"use_kernel": False}).fit(X, y)
    assert p.solver_info_["kernel"] is None
    assert p.solver_info_["kernel_reason"] == "use_kernel=False"
    k = T.LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
    # on the CPU the kernel's wrapper is its plain version: the two fits
    # differ only in how the loss sums its f32 terms
    np.testing.assert_allclose(k.coef_, p.coef_, atol=5e-4)


def test_warm_start_and_params():
    X, y = _data("logistic", seed=5, n=800)
    t = T.LogisticRegression(solver="lbfgs", max_iter=30, warm_start=True)
    t.fit(X, y)
    first = t.coef_.copy()
    t.fit(X, y)
    assert t.n_iter_ <= 2
    np.testing.assert_allclose(t.coef_, first, atol=1e-4)
    assert set(t.get_params()) == set(J.LogisticRegression().get_params())
    assert "C=0.5" in repr(T.LogisticRegression(C=0.5))


@pytest.mark.parametrize("what,match", [
    ({"solver": "newton"}, "queue 1 item 2"),
    ({"solver": "admm"}, "queue 1 item 2"),
    ({"solver": "lbfgs",
      "solver_kwargs": {"checkpoint_path": "ck"}}, "checkpoint_path"),
])
def test_unported_paths_raise(what, match):
    X, y = _data("logistic", seed=6, n=200)
    with pytest.raises(NotImplementedError, match=match):
        T.LogisticRegression(**what).fit(X, y)


def test_multiclass_and_streamed_raise(tmp_path):
    X, y = _data("logistic", seed=7, n=300)
    y3 = np.arange(300) % 3
    with pytest.raises(NotImplementedError, match="one-vs-rest"):
        T.LogisticRegression(solver="lbfgs").fit(X, y3)
    with pytest.raises(ValueError, match="at least 2 classes"):
        T.LogisticRegression(solver="lbfgs").fit(X, np.zeros(300))
    mm = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+",
                                   dtype=np.float32, shape=X.shape)
    mm[:] = X
    with pytest.raises(NotImplementedError, match="streamed"):
        T.LogisticRegression(solver="lbfgs").fit(mm, y)


@pytest.mark.parametrize("name", ["LogisticRegression", "LinearRegression"])
def test_convert_carries_jax_fit(name):
    """A model fitted by dask_ml_tpu, carried across as plain numpy,
    predicts as it did (float32 decision values in both: 1e-6)."""
    family = "logistic" if name == "LogisticRegression" else "normal"
    X, y = _data(family, seed=8, n=1000)
    j = getattr(J, name)(solver="lbfgs", max_iter=30).fit(X, y)
    state = convert.export_fitted(j)
    assert all(isinstance(v, (np.ndarray, int, float, str))
               for v in state["fitted"].values())
    t = convert.from_fitted(**state)
    np.testing.assert_array_equal(t.predict(X) > 0.5, j.predict(X) > 0.5)
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-6,
                               atol=1e-6)
    assert t.score(X, y) == pytest.approx(j.score(X, y), abs=1e-6)
    if name == "LogisticRegression":
        np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.predict_log_proba(X),
                                   j.predict_log_proba(X), atol=1e-5)
        np.testing.assert_allclose(t.decision_function(X),
                                   j.decision_function(X), atol=1e-5)


def test_cuda_without_a_card_raises():
    """Asking for cuda on a machine without a card raises; nothing
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule needs none")
    X, y = _data("logistic", seed=9, n=100)
    with config.set(device="cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.LogisticRegression(solver="lbfgs").fit(X, y)
    code = ("import numpy as np; "
            "from dask_ml_tpu_torch.linear_model import LogisticRegression;"
            "LogisticRegression(solver='lbfgs').fit(np.ones((4, 2)), "
            "np.array([0, 1, 0, 1]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode != 0 and "no CUDA device" in out.stderr
