"""The port's GLMs (dask_ml_tpu_torch) against dask_ml_tpu on the same
data, on the CPU: the same inputs, made with numpy.random.RandomState,
fitted by both packages. The port runs with device="cpu", where its
kernel-backed loss runs the kernel's plain version."""

import subprocess
import sys

import os

import numpy as np
import pytest
import torch

import jax

import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu.parallel.sharded import ShardedArray
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
# zero residual. Both packages take the same steps (float32 step
# arithmetic, t * grow rounded as JAX rounds it) through iteration 10;
# at iteration 11 the two losses of the same iterate differ by one f32
# ulp (their sums run in another order), the quadratic-bound test parts,
# and the loop ends at iteration 14 in dask_ml_tpu, at 19 in the port.
# gradient_descent's gradient norm stalls near 4e-5 in dask_ml_tpu and
# both run to max_iter here (at tol=1e-6 the port reaches it at 55, JAX
# not in 100: the Armijo tests part on a one-ulp loss difference at
# iteration 6). At tolerances the solvers resolve (1e-5 and above on
# this data) the counts agree exactly (test_n_iter_matches_jax).
N_ITER_GAP = {"lbfgs": 0, "gradient_descent": 0, "proximal_grad": 5}
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
    ({"solver": "newton",
      "solver_kwargs": {"checkpoint_path": "ck"}}, "checkpoint_path"),
    ({"solver": "admm",
      "solver_kwargs": {"checkpoint_path": "ck"}}, "checkpoint_path"),
    ({"solver": "lbfgs",
      "solver_kwargs": {"checkpoint_path": "ck"}}, "checkpoint_path"),
])
def test_unported_paths_raise(what, match, tmp_path):
    """``checkpoint_path`` is ported: newton and admm ignore it, as in
    dask_ml_tpu; lbfgs checkpoints in chunks once ``checkpoint_every`` is
    set too, bit-equal to the unchunked fit, and clears the checkpoint
    when it completes (tests/test_torch_checkpoint.py kills and resumes
    it). The C-grid fast path still refuses solver_kwargs, so a search
    takes the general path's fit."""
    X, y = _data("logistic", seed=6, n=200)
    path = str(tmp_path / what["solver_kwargs"][match])
    ref = T.LogisticRegression(solver=what["solver"]).fit(X, y)
    for every in (0, 3):
        kw = {match: path, "checkpoint_every": every}
        est = T.LogisticRegression(solver=what["solver"],
                                   solver_kwargs=kw).fit(X, y)
        np.testing.assert_array_equal(est.coef_, ref.coef_)
        assert est.n_iter_ == ref.n_iter_
        assert ("resumed_from" in est.solver_info_) == bool(
            every and what["solver"] == "lbfgs")
        assert not os.path.exists(path)
    assert T.LogisticRegression(**what)._fit_C_grid(X, y, [1.0]) is None


def test_multiclass_and_streamed_raise(tmp_path):
    """Three classes fit one-vs-rest, and a memmap fits streamed, now;
    what still raises: another multi_class than ovr/auto (as in
    dask_ml_tpu), one class, multiclass targets on a regression family,
    and a sparse source (the streamed sparse fits are not ported:
    ROADMAP.md queue 1, Sparse; tests/test_torch_stream_glm.py holds the
    streamed fits to dask_ml_tpu)."""
    X, y = _data("logistic", seed=7, n=300)
    y3 = np.arange(300) % 3
    with pytest.raises(ValueError, match="multi_class"):
        T.LogisticRegression(solver="lbfgs",
                             multi_class="multinomial").fit(X, y3)
    assert T.LogisticRegression(solver="lbfgs").fit(X, y3).coef_.shape \
        == (3, 12)
    with pytest.raises(NotImplementedError, match="multiclass"):
        T.LinearRegression()._finish_fit_multi(np.zeros((3, 13)),
                                               np.arange(3), {}, 12)
    with pytest.raises(ValueError, match="at least 2 classes"):
        T.LogisticRegression(solver="lbfgs").fit(X, np.zeros(300))
    mm = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+",
                                   dtype=np.float32, shape=X.shape)
    mm[:] = X
    fit = T.LogisticRegression(solver="lbfgs").fit(mm, y)
    assert fit.solver_info_["streamed"] and fit.coef_.shape == (1, 12)
    import scipy.sparse as sp

    # a sparse X streams (one block, as the memmap's; all nonzero, its
    # nonzeros with the density limit raised), the same fit as the
    # memmap's up to the order of its sums
    with config.set(stream_sparse_max_density=1.0):
        sparse = T.LogisticRegression(solver="lbfgs").fit(
            sp.csr_matrix(X), y)
    assert sparse.solver_info_["sparse_stream"]
    assert sparse.solver_info_["n_blocks"] == fit.solver_info_["n_blocks"]
    np.testing.assert_allclose(sparse.coef_, fit.coef_, atol=COEF_ATOL)


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


# ---------------------------------------------------------------------------
# Newton, ADMM and one-vs-rest
# ---------------------------------------------------------------------------

def _one_device(fit):
    """Run a dask_ml_tpu fit on a one-device mesh: its ADMM consensus
    depends on the number of shards, and the port's ADMM is the JAX
    arithmetic with one shard (tests/test_parity_sweeps.py:24-30)."""
    mesh = device_mesh(devices=jax.devices()[:1])
    with use_mesh(mesh):
        return fit(lambda a: ShardedArray.from_array(a, mesh=mesh))


# Newton's step-halving test compares the loss at the new iterate with
# the value at the old one. Near the optimum the decrease falls below one
# float32 ulp of the loss, and the test is decided by how each package
# rounds its sum: a one-ulp rise halves the step, and repeated halving
# can stall the loop short of tol (traced: ROADMAP queue 3; it stalls
# dask_ml_tpu on other data, e.g. its Poisson fit of seed 0 at 1e-6). At
# tol 1e-5 these fits sit in that regime: the port stalls to max_iter on
# the regressions' Poisson data (seed 1; dask_ml_tpu stops at 7) and on
# class 2 of the three-class data (dask_ml_tpu: 7). At 1e-4, and for the
# other fits at 1e-5, the counts agree.
NEWTON_STALL = {("poisson", 1e-5), ("ovr3", 1e-5)}


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("family,J_est,T_est,seed", [
    ("logistic", J.LogisticRegression, T.LogisticRegression, 0),
    ("normal", J.LinearRegression, T.LinearRegression, 1),
    ("poisson", J.PoissonRegression, T.PoissonRegression, 1),
])
def test_newton_matches_jax(family, J_est, T_est, seed, tol):
    X, y = _data(family, seed=seed)
    j = J_est(solver="newton", tol=tol).fit(X, y)
    t = T_est(solver="newton", tol=tol).fit(X, y)
    assert t.solver_info_["kernel"] == "fused_glm_value_grad_hess"
    # Newton reaches the optimum in a few steps in both: the parity
    # tolerance of the other solvers, 5e-4 (tests/test_pallas_glm.py:30)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    if family == "logistic":
        _assert_same_predictions(t, j, X)
    else:
        np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-3,
                                   atol=1e-3)
    if (family, tol) in NEWTON_STALL:
        assert t.n_iter_ == 100 > j.n_iter_
    else:
        assert t.n_iter_ == j.n_iter_


def test_newton_kernel_matches_plain_path():
    """use_kernel=False takes the plain value, gradient and Hessian, which
    solver_info_ records; on the CPU both are the same f32 objective."""
    X, y = _data("logistic", seed=2)
    a = T.LogisticRegression(solver="newton", tol=1e-4).fit(X, y)
    b = T.LogisticRegression(solver="newton", tol=1e-4,
                             solver_kwargs={"use_kernel": False}).fit(X, y)
    assert (b.solver_info_["kernel"], b.solver_info_["kernel_reason"]) == \
        (None, "use_kernel=False")
    np.testing.assert_allclose(a.coef_, b.coef_, atol=1e-5)
    assert a.n_iter_ == b.n_iter_


@pytest.mark.parametrize("case", ["duplicated_column", "n_below_d"])
def test_newton_singular_hessian_matches_jax(case):
    """A singular Hessian takes the minimum-norm step (an SVD with JAX's
    cutoff, as jnp.linalg.lstsq), finite and equal in both packages; the
    duplicated column's two coefficients split its weight evenly."""
    X, y = _data("logistic", seed=10, n=400, d=6)
    if case == "duplicated_column":
        X = np.c_[X, X[:, :1]]
    else:
        X, y = X[:5], y[:5]
    kw = dict(solver="newton", tol=1e-6, max_iter=20, C=1e4)
    j = J.LogisticRegression(**kw).fit(X, y)
    t = T.LogisticRegression(**kw).fit(X, y)
    assert np.isfinite(t.coef_).all()
    # 5e-4 relative to the coefficients' size: with C = 1e4 the n < d
    # fit's coefficients grow to O(10) along the data's span
    scale = max(1.0, float(np.abs(j.coef_).max()))
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL * scale)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    if case == "duplicated_column":
        np.testing.assert_allclose(t.coef_[0, 0], t.coef_[0, -1], atol=1e-5)


@pytest.mark.parametrize("family,J_est,T_est,kw", [
    ("logistic", J.LogisticRegression, T.LogisticRegression, {}),
    ("logistic", J.LogisticRegression, T.LogisticRegression,
     {"penalty": "l1", "C": 0.05}),
    ("normal", J.LinearRegression, T.LinearRegression, {}),
    ("poisson", J.PoissonRegression, T.PoissonRegression,
     {"penalty": "none"}),
])
def test_admm_matches_jax(family, J_est, T_est, kw):
    """ADMM (the default solver) against dask_ml_tpu on a one-device mesh:
    the same consensus arithmetic, so the same iterations and residuals;
    the coefficients to 5e-4 as for every solver."""
    X, y = _data(family, seed=11)
    j = _one_device(lambda s: J_est(**kw).fit(s(X), s(y)))
    t = T_est(**kw).fit(X, y)
    assert t.solver == j.solver == "admm"
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    assert t.n_iter_ == j.n_iter_
    for k in ("primal_residual", "dual_residual"):
        # residuals of the same iterates: float32 noise of their sums
        assert t.solver_info_[k] == pytest.approx(j.solver_info_[k],
                                                  rel=1e-3, abs=1e-7)


def test_default_logistic_fit_runs_admm():
    X, y = _data("logistic", seed=12, n=1000)
    t = T.LogisticRegression().fit(X, y)
    assert t.solver == "admm" and t.n_iter_ > 0
    assert {"primal_residual", "dual_residual"} <= set(t.solver_info_)
    ref = T.LogisticRegression(solver="newton", tol=1e-8).fit(X, y)
    # ADMM stops on residuals of 1e-4: its coefficients sit within 1e-3
    # of the Newton optimum on this data
    np.testing.assert_allclose(t.coef_, ref.coef_, atol=1e-3)


def _multi_data(n_classes, seed=0, n=2000, d=8):
    """Labels drawn from a softmax of X W, so every class is learnable."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    logits = X @ rng.randn(d, n_classes)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    u = rng.uniform(size=(n, 1))
    y = (u > np.cumsum(p, 1)).sum(1).astype(np.float32)
    return X, y


def _fit_multi(solver, X, y, **kw):
    est = dict(solver=solver, **kw)
    if solver == "admm":
        j = _one_device(lambda s: J.LogisticRegression(**est).fit(s(X), s(y)))
    else:
        j = J.LogisticRegression(**est).fit(X, y)
    return j, T.LogisticRegression(**est).fit(X, y)


def _assert_multi_predictions(t, j, X):
    """Equal labels except on rows whose two leading JAX decision values
    lie within what COEF_ATOL lets a decision value move; probabilities
    are per-class sigmoids normalized to sum 1 in both."""
    diff = np.flatnonzero(t.predict(X) != j.predict(X))
    top2 = np.sort(j.decision_function(X)[diff], axis=1)[:, -2:]
    edge = 2 * COEF_ATOL * (np.abs(X[diff]).sum(1) + 1.0)
    assert np.all(top2[:, 1] - top2[:, 0] <= edge), diff
    p = t.predict_proba(X)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(p, j.predict_proba(X), atol=1e-3)


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("n_classes", [3, 4])
@pytest.mark.parametrize("solver", ["lbfgs", "newton", "admm"])
def test_ovr_matches_jax(solver, n_classes, tol):
    """One-vs-rest against dask_ml_tpu: lbfgs as one joint solve whose
    data term is the multi-target kernel (the stacked XLA loss in JAX),
    newton and admm per class. Coefficients to 5e-4, and the joint and
    per-class iteration counts equal."""
    X, y = _multi_data(n_classes)
    j, t = _fit_multi(solver, X, y, tol=tol)
    assert t.coef_.shape == (n_classes, 8)
    assert t.intercept_.shape == (n_classes,)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    _assert_multi_predictions(t, j, X)
    if solver == "newton" and (f"ovr{n_classes}", tol) in NEWTON_STALL:
        assert t.n_iter_ == 100 > j.n_iter_
    else:
        assert t.n_iter_ == j.n_iter_
        assert t.solver_info_["n_iter_per_class"] == \
            j.solver_info_["n_iter_per_class"]
    if solver == "lbfgs":
        assert t.solver_info_["fused_multi"]
        assert t.solver_info_["kernel"] == "fused_glm_multi_value_grad"


@pytest.mark.parametrize("n_classes", [3, 4])
@pytest.mark.parametrize("solver,kw", [
    ("gradient_descent", {}),
    ("proximal_grad", {"penalty": "l1", "C": 0.5}),
])
def test_ovr_first_order_matches_jax(solver, kw, n_classes):
    """The first-order solvers fit one-vs-rest as a loop of the binary
    solver. Each class's fit is the port's binary fit of that class
    exactly (same iterations, same coefficients); against dask_ml_tpu the
    coefficients agree to 5e-4 at tol 1e-5. Their iteration counts follow
    the binary solvers' float32 stopping noise (N_ITER_GAP above, and
    ROADMAP queue 3) and are not compared here."""
    X, y = _multi_data(n_classes)
    j, t = _fit_multi(solver, X, y, tol=1e-5, **kw)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    _assert_multi_predictions(t, j, X)
    for c, cls in enumerate(t.classes_):
        b = T.LogisticRegression(solver=solver, tol=1e-5, **kw).fit(
            X, (y == cls).astype(np.float32))
        np.testing.assert_array_equal(b.coef_[0], t.coef_[c])
        assert b.n_iter_ == t.solver_info_["n_iter_per_class"][c]
    assert t.n_iter_ == max(t.solver_info_["n_iter_per_class"])


def test_ovr_kernel_matches_stacked_plain_loss():
    """use_kernel=False runs the joint L-BFGS on the plain stacked loss;
    on the CPU the kernel's plain version is the same objective summed in
    another order: 1e-5 apart, the same iterations."""
    X, y = _multi_data(4, seed=1)
    a = T.LogisticRegression(solver="lbfgs", tol=1e-5).fit(X, y)
    b = T.LogisticRegression(solver="lbfgs", tol=1e-5,
                             solver_kwargs={"use_kernel": False}).fit(X, y)
    assert "fused_multi" not in b.solver_info_
    assert b.solver_info_["kernel_reason"] == "use_kernel=False"
    np.testing.assert_allclose(a.coef_, b.coef_, atol=1e-5)
    assert a.n_iter_ == b.n_iter_


def test_ovr_bf16_design_matches_jax():
    """fit_dtype="bfloat16" casts the design to bf16 for the one-vs-rest
    L-BFGS in both packages. bf16 rounding is relative, so the binary
    bf16 fit's 5e-3 is taken relative to the coefficients' size (about
    1.7 here, 0.3 in the binary test)."""
    X, y = _multi_data(3, seed=2)
    with jconfig.set(dtype="bfloat16"):
        j = J.LogisticRegression(solver="lbfgs", max_iter=40).fit(X, y)
    t = T.LogisticRegression(solver="lbfgs", max_iter=40,
                             fit_dtype="bfloat16").fit(X, y)
    assert t.fit_dtype_ == j.fit_dtype_ == "bfloat16"
    assert t.solver_info_["fused_multi"]
    scale = max(1.0, float(np.abs(j.coef_).max()))
    np.testing.assert_allclose(t.coef_, j.coef_, atol=5e-3 * scale)
    assert np.mean(t.predict(X) == j.predict(X)) > 0.995


def test_ovr_warm_start():
    X, y = _multi_data(3, seed=3, n=800)
    t = T.LogisticRegression(solver="lbfgs", warm_start=True, tol=1e-5)
    t.fit(X, y)
    first = t.coef_.copy()
    t.fit(X, y)
    assert t.n_iter_ <= 2
    np.testing.assert_allclose(t.coef_, first, atol=1e-4)


def test_convert_carries_multiclass_fit():
    """A one-vs-rest model carried both ways as plain numpy: coef_ (C, d),
    intercept_ (C,) and classes_ predict as they did (1e-6: float32
    decision values in both)."""
    X, y = _multi_data(4, seed=4, n=600)
    j = J.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
    t = convert.from_fitted(**convert.export_fitted(j))
    assert t.coef_.shape == (4, 8) and t.intercept_.shape == (4,)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.decision_function(X),
                               j.decision_function(X), atol=1e-5)
    # and back: the port's fit as plain numpy, set on a JAX estimator
    p = T.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
    state = convert.export_fitted(p)
    back = J.LogisticRegression(**state["params"])
    for k, v in state["fitted"].items():
        setattr(back, k, v)
    np.testing.assert_array_equal(back.predict(X), p.predict(X))
    np.testing.assert_allclose(back.predict_proba(X), p.predict_proba(X),
                               rtol=1e-6, atol=1e-6)


def test_add_intercept_matches_jax():
    from dask_ml_tpu.linear_model import add_intercept as j_add
    from dask_ml_tpu.parallel.sharded import ShardedArray as JSA
    from dask_ml_tpu_torch.linear_model import add_intercept
    from dask_ml_tpu_torch.parallel import ShardedArray

    X = np.random.RandomState(0).randn(9, 3).astype(np.float32)
    np.testing.assert_array_equal(add_intercept(X), j_add(X))
    t = add_intercept(ShardedArray.from_array(X))
    assert isinstance(t, ShardedArray) and t.shape == (9, 4)
    np.testing.assert_array_equal(t.to_numpy(),
                                  np.asarray(j_add(JSA.from_array(X))
                                             .to_numpy()))
