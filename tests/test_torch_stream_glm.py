"""The port's streamed (out-of-core) GLM fits against dask_ml_tpu's on
the same data, on the CPU. Both packages stream an ndarray taller than
``config.stream_block_rows`` (700 rows here: 3000 rows make five blocks,
the last ragged) or an ``np.memmap``; dask_ml_tpu runs its XLA flavour
(its default off a TPU) on one device (``stream_mesh=1``: the test
harness's eight virtual devices would shard its blocks and round them to
704 rows), the port its kernels' plain versions. The host
solvers are the same algorithm in both, so coefficients agree to 5e-4
(the fused-loss tolerance of tests/test_pallas_glm.py) and the iteration
counts are equal at tolerances the solvers resolve before float32 does:
1e-3 for the first-order solvers, whose Armijo tests compare losses, and
1e-4 for Newton. Closer to the optimum the two packages' losses of one
iterate differ by an f32 ulp (their sums run in another order), an
Armijo test can pass in one and fail in the other, and the fits part
(measured here: PoissonRegression lbfgs at 1e-4 stops after 7 iterations
in dask_ml_tpu and runs to max_iter in the port, its step at iteration 7
decreasing the loss by less than one ulp), as tests/test_torch_glm.py
records for the resident solvers.

Streamed proximal_grad is held to the resident fits (dask_ml_tpu's and
the port's): dask_ml_tpu's streamed proximal_grad fails its own parity
test (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.ops import fused
import dask_ml_tpu_torch.linear_model as T

BLOCK = 700
COEF_ATOL = 5e-4
TOL = {"lbfgs": 1e-3, "gradient_descent": 1e-3, "newton": 1e-4,
       "admm": 1e-4}


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every superblock in fresh buffers,
    the reference's own switch for backends whose ``device_put`` aliases
    host memory: jax's CPU backend aliases a 64-byte-aligned numpy array,
    and a reused staging slab could then be rewritten under a read that
    is still queued. Its one-time probe (an 8-float array, copied) does
    not see that."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(family, seed=0, n=3000, d=12, n_classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    if n_classes > 2:
        W = rng.randn(d, n_classes) / np.sqrt(d)
        logits = X @ W
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        y = np.array([rng.choice(n_classes, p=pi) for pi in p])
        return X, (y * 2 + 1).astype(np.float32)   # labels 1, 3, 5, ...
    beta = rng.randn(d) / np.sqrt(d)
    eta = X @ beta + 0.3
    if family == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(np.exp(0.5 * eta)).astype(np.float32)
    else:
        y = (eta + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _memmap(tmp_path, X):
    path = str(tmp_path / "X.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)


def _both(name, X, y, **kw):
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1):
        j = getattr(J, name)(**kw).fit(X, y)
    with config.set(stream_block_rows=BLOCK):
        t = getattr(T, name)(**kw).fit(X, y)
    return j, t


def _assert_close(t, j):
    assert t.solver_info_["streamed"] and j.solver_info_["streamed"]
    assert t.solver_info_["n_blocks"] == j.solver_info_["n_blocks"] == 5
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)


@pytest.mark.parametrize("solver", ["lbfgs", "newton", "gradient_descent",
                                    "admm"])
def test_streamed_logistic_matches_jax(solver):
    X, y = _data("logistic", seed=1)
    j, t = _both("LogisticRegression", X, y, solver=solver, tol=TOL[solver],
                 max_iter=60)
    _assert_close(t, j)
    assert t.n_iter_ == j.n_iter_
    assert t.solver_info_["data_passes"] == j.solver_info_["data_passes"]
    np.testing.assert_array_equal(t.classes_, j.classes_)
    info = t.solver_info_
    if solver == "admm":
        assert not info["fused_stream"]
        assert info["fused_stream_reason"] == "admm-local-newton"
    else:
        assert info["fused_stream"] and info["fused_stream_reason"] is None
    assert info["stream_shards"] == 1 and info["fit_dtype"] == "float32"


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
@pytest.mark.parametrize("name,family", [("LinearRegression", "normal"),
                                         ("PoissonRegression", "poisson")])
def test_streamed_regressions_match_jax(name, family, solver):
    X, y = _data(family, seed=2)
    j, t = _both(name, X, y, solver=solver, tol=TOL[solver], max_iter=60)
    _assert_close(t, j)
    assert t.n_iter_ == j.n_iter_
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("solver", ["lbfgs", "newton", "gradient_descent",
                                    "admm"])
def test_streamed_ovr_matches_jax(solver):
    """One-vs-rest with 3 classes: one pass serves all classes (the
    class codes stream beside X); newton keeps per-class Hessians."""
    X, y = _data("logistic", seed=3, n_classes=3)
    j, t = _both("LogisticRegression", X, y, solver=solver, tol=TOL[solver],
                 max_iter=60)
    assert t.solver_info_["n_classes"] == j.solver_info_["n_classes"] == 3
    assert t.coef_.shape == (3, 12) and t.intercept_.shape == (3,)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    _assert_close(t, j)
    assert t.n_iter_ == j.n_iter_
    if solver == "newton":
        assert t.solver_info_["fused_stream_reason"] == \
            "multiclass-hessian-plain"
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               atol=1e-3)


# The one-vs-rest fit is one joint solve with one step size for every
# class; its backtracking collapses once no step shows a decrease in f32,
# which ends the loop with a zero residual (dask_ml_tpu's streamed fit
# does the same). On this data at C = 0.01 that stall comes at iteration
# 13, 8.4e-4 from the resident optimum (dask_ml_tpu's streamed fit: 14
# iterations, 4.4e-4), so the 3-class case runs at C = 0.05, where the
# joint solve converges first (ROADMAP queue 3).
@pytest.mark.parametrize("n_classes,C", [(2, 0.01), (3, 0.05)])
def test_streamed_proximal_grad_matches_resident(n_classes, C):
    """Streamed proximal_grad (l1) against the resident fits of both
    packages on the same data, with the same zeros."""
    X, y = _data("logistic", seed=4, n_classes=n_classes)
    kw = dict(solver="proximal_grad", penalty="l1", C=C, tol=1e-6,
              max_iter=200)
    j = J.LogisticRegression(**kw).fit(X, y)
    r = T.LogisticRegression(**kw).fit(X, y)
    with config.set(stream_block_rows=BLOCK):
        t = T.LogisticRegression(**kw).fit(X, y)
    assert t.solver_info_["streamed"] and "streamed" not in r.solver_info_
    for ref in (j, r):
        np.testing.assert_allclose(t.coef_, ref.coef_, atol=COEF_ATOL)
        np.testing.assert_allclose(t.intercept_, ref.intercept_,
                                   atol=COEF_ATOL)
    np.testing.assert_array_equal(t.coef_ == 0, r.coef_ == 0)
    assert (t.coef_ == 0).any()


def test_memmap_fit_matches_jax(tmp_path):
    """An np.memmap streams whatever config says: with the auto block
    (256 MB) this one is a single block, with stream_block_rows five."""
    X, y = _data("logistic", seed=5)
    mm = _memmap(tmp_path, X)
    kw = dict(solver="lbfgs", tol=TOL["lbfgs"], max_iter=60)
    with jconfig.set(stream_mesh=1):
        j = J.LogisticRegression(**kw).fit(mm, y)
    t = T.LogisticRegression(**kw).fit(mm, y)
    assert t.solver_info_["n_blocks"] == j.solver_info_["n_blocks"] == 1
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    assert t.n_iter_ == j.n_iter_
    j5, t5 = _both("LogisticRegression", mm, y, **kw)
    _assert_close(t5, j5)
    # streamed inference on the memmap equals the resident one
    np.testing.assert_allclose(t5.decision_function(mm),
                               t5.decision_function(X), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t5.predict(mm), t5.predict(X))
    np.testing.assert_allclose(t5.predict_proba(mm), j5.predict_proba(mm),
                               atol=1e-3)


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_streamed_matches_resident_fit(solver):
    """Where the algorithms agree on the optimum (converged fits of one
    objective) a streamed fit equals the port's resident fit."""
    X, y = _data("logistic", seed=6)
    kw = dict(solver=solver, tol=1e-6, max_iter=100)
    r = T.LogisticRegression(**kw).fit(X, y)
    with config.set(stream_block_rows=BLOCK):
        t = T.LogisticRegression(**kw).fit(X, y)
    np.testing.assert_allclose(t.coef_, r.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, r.intercept_, atol=COEF_ATOL)


@pytest.mark.parametrize("solver,n_classes", [("lbfgs", 2), ("newton", 2),
                                              ("lbfgs", 3), ("newton", 3)])
def test_use_kernel_false_matches(solver, n_classes):
    """The plain flavour (per-block autograd functions) gives the kernel
    flavour's coefficients and iterations, and launches nothing."""
    X, y = _data("logistic", seed=7, n_classes=n_classes)
    kw = dict(solver=solver, tol=TOL[solver], max_iter=60)
    with config.set(stream_block_rows=BLOCK):
        t = T.LogisticRegression(**kw).fit(X, y)
        p = T.LogisticRegression(solver_kwargs={"use_kernel": False},
                                 **kw).fit(X, y)
    assert p.solver_info_["fused_stream_reason"] == "use_kernel=False"
    assert not p.solver_info_["fused_stream"]
    np.testing.assert_allclose(t.coef_, p.coef_, atol=1e-5)
    np.testing.assert_allclose(t.intercept_, p.intercept_, atol=1e-5)
    assert t.n_iter_ == p.n_iter_


def test_stale_tail_is_never_read():
    """Two blocks in a ring of two: the ragged second block lands in a
    slot whose rows past its count hold NaN on every pass. The fit is
    finite and equals the fit of five blocks."""
    X, y = _data("logistic", seed=8)
    kw = dict(solver="newton", tol=TOL["newton"], max_iter=30)
    with config.set(stream_block_rows=1800):
        t = T.LogisticRegression(**kw).fit(X, y)
    with config.set(stream_block_rows=BLOCK):
        t5 = T.LogisticRegression(**kw).fit(X, y)
    assert t.solver_info_["n_blocks"] == 2
    assert np.isfinite(t.coef_).all()
    np.testing.assert_allclose(t.coef_, t5.coef_, atol=1e-5)


def test_streamed_fit_launches_nothing_on_the_cpu():
    X, y = _data("normal", seed=9)
    fused.reset_launches()
    with config.set(stream_block_rows=BLOCK):
        T.LinearRegression(solver="lbfgs", max_iter=5).fit(X, y)
    assert all(v == 0 for v in fused.launches().values())


def test_streamed_bf16_vg_policy():
    """Under config.dtype="bfloat16" the "vg" passes take bf16 operands
    (fit_dtype_ bfloat16); newton's "vgh" and "val" stay f32."""
    X, y = _data("logistic", seed=10)
    with config.set(stream_block_rows=BLOCK, dtype="bfloat16"):
        t = T.LogisticRegression(solver="lbfgs", tol=1e-3).fit(X, y)
        n = T.LogisticRegression(solver="newton", tol=1e-4).fit(X, y)
    assert t.fit_dtype_ == "bfloat16"
    assert n.fit_dtype_ == "float32"
    assert n.solver_info_["fit_dtype_source"] == "hessian-f32"
    with config.set(stream_block_rows=BLOCK):
        f = T.LogisticRegression(solver="lbfgs", tol=1e-3).fit(X, y)
    # bf16 operands move the optimum by about the rounding of x (2**-8)
    np.testing.assert_allclose(t.coef_, f.coef_, atol=2e-2)


def test_unported_streamed_paths_raise():
    import scipy.sparse as sp

    X, y = _data("logistic", seed=11, n=200)
    with pytest.raises(NotImplementedError, match="item 10"):
        T.LogisticRegression(solver="lbfgs").fit(sp.csr_matrix(X), y)
    with config.set(stream_block_rows=50):
        with pytest.raises(NotImplementedError, match="checkpoint_path"):
            T.LogisticRegression(solver="lbfgs", solver_kwargs={
                "checkpoint_path": "ck"}).fit(X, y)
        with pytest.raises(ValueError, match="inconsistent"):
            T.LogisticRegression(solver="lbfgs").fit(X, y[:-1])
        with pytest.raises(ValueError, match="smooth"):
            T.LogisticRegression(solver="newton", penalty="l1").fit(X, y)
        with pytest.raises(ValueError, match="Unknown solver"):
            T.LogisticRegression(solver="sgd").fit(X, y)
        with pytest.raises(ValueError, match="non-negative"):
            T.PoissonRegression(solver="lbfgs").fit(X, y - 1)
        with pytest.raises(ValueError, match="at least 2 classes"):
            T.LogisticRegression(solver="lbfgs").fit(X, np.zeros(200))


def test_cuda_ring_needs_a_card():
    """A stream asks for config.device; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule needs none")
    from dask_ml_tpu_torch.parallel.streaming import BlockStream

    with config.set(device="cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BlockStream((np.zeros((10, 2), np.float32),))
