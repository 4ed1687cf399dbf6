"""The port's fits, searches and refusals across processes, on the CPU,
as virtual ranks (``distributed.run_virtual_processes``: threads of this
process, each rank streaming or holding its own rows).

The JAX package's virtual streamed fit is no oracle (its own test of it
fails on the CPU), so every fit is held to single-process twins on the
concatenated data: the port's, and dask_ml_tpu's on one device
(``stream_mesh=1``), so that a defect shared by the port's single- and
multi-process paths still shows. Tolerances: GLM ``coef_`` 5e-4 (the
merged sums reassociate float32 block sums; the resident proximal_grad
fit is held to JAX's by its float64 objective, see
``test_resident_process_local_matches_single``); ADMM over the same
blocks 5e-4 (the blocks are the consensus members in both runs), and
one member a process within 1 % of the lbfgs optimum of both packages;
KMeans centers 1e-3, inertia rel 1e-4, ``n_iter_`` equal with an init
array (k-means|| draws per rank, so its centers are held at 1e-3 on
separated blobs, sorted); grad-accum SGD: A = 1 bit-equal to the
sequential fit, two ranks at A = 2 within 1e-6 of one process at A = 4
over the same group order, in both packages; PCA and TruncatedSVD
singular values rel 1e-5 and components 1e-4 (randomized fits take
JAX's Ω through ``jax_omega``). The searches:
GridSearchCV's striped scores equal the single-process search's (and
JAX's within 1e-4); Hyperband's brackets and the adaptive search's
owned candidates reproduce the single-process search exactly, and the
adaptive search over scikit-learn's SGD reproduces dask_ml_tpu's
single-process search on one device (the JAX package holds its own
virtual world to that search in tests/test_distributed.py). ``_PUT_ALIASES``: dask_ml_tpu's host streams stage fresh
buffers (ROADMAP.md queue 3).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA, IncrementalPCA, TruncatedSVD
from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                            LogisticRegression,
                                            SGDClassifier)
from dask_ml_tpu_torch.ops import linalg
from dask_ml_tpu_torch.parallel import distributed as dist
from dask_ml_tpu_torch.parallel.sharded import ShardedArray

BLOCK = 500
COEF = 5e-4


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture
def jax_omega(monkeypatch):
    def draw(d, size, random_state, device, dtype=torch.float32):
        key = jax.random.PRNGKey(0 if random_state is None
                                 else int(random_state))
        return torch.tensor(np.asarray(
            jax.random.normal(key, (d, size), jnp.float32)), device=device)

    monkeypatch.setattr(linalg, "draw_omega", draw)


def _jax(fn, **cfg):
    with jconfig.set(stream_mesh=1, **cfg), \
            use_mesh(device_mesh(devices=jax.devices()[:1])):
        return fn()


def _glm_data(seed=0, n=4000, d=8, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    eta = X @ rng.randn(d) + 1.5 * rng.randn(n)
    if classes == 2:
        return X, (eta > 0).astype(np.float32)
    return X, np.digitize(eta, np.quantile(eta, [1 / 3, 2 / 3])
                          ).astype(np.float32)


def _ranks(fn, world=2):
    return dist.run_virtual_processes(fn, world, timeout=300)


def _half(a, rank, world=2):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


# -- the streamed GLMs -----------------------------------------------------

SOLVERS = [("lbfgs", "l2", {}), ("newton", "l2", {}),
           ("gradient_descent", "l2", {}),
           ("proximal_grad", "l1", {"C": 0.5}),
           ("admm", "l2", {})]


@pytest.mark.parametrize("solver,penalty,kw", SOLVERS,
                         ids=[s[0] for s in SOLVERS])
def test_streamed_glm_matches_single(solver, penalty, kw):
    X, y = _glm_data()

    def make():
        return LogisticRegression(solver=solver, penalty=penalty,
                                  max_iter=60, **kw)

    with config.set(stream_block_rows=BLOCK):
        single = make().fit(X, y)
        got = _ranks(lambda r: make().fit(_half(X, r), _half(y, r)))
    ref = _jax(lambda: make_jax(solver, penalty, kw).fit(X, y),
               stream_block_rows=BLOCK)
    for est in got:
        assert est.solver_info_["streamed"]
        assert est.solver_info_["data_passes"] > 0
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.intercept_, single.intercept_,
                                   atol=COEF)
    np.testing.assert_array_equal(got[0].coef_, got[1].coef_)
    if solver != "proximal_grad":
        # the streamed proximal fit is held to its resident twins, not to
        # JAX's streamed one (ROADMAP.md queue 3, reference failures)
        np.testing.assert_allclose(got[0].coef_, ref.coef_, atol=COEF)


def make_jax(solver, penalty, kw, max_iter=60):
    from dask_ml_tpu.linear_model import LogisticRegression as JLR

    return JLR(solver=solver, penalty=penalty, max_iter=max_iter, **kw)


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_streamed_one_vs_rest_matches_single(solver):
    X, y = _glm_data(seed=1, classes=3)
    with config.set(stream_block_rows=BLOCK):
        single = LogisticRegression(solver=solver, max_iter=40).fit(X, y)
        got = _ranks(lambda r: LogisticRegression(
            solver=solver, max_iter=40).fit(_half(X, r), _half(y, r)))
    ref = _jax(lambda: make_jax(solver, "l2", {}, max_iter=40).fit(X, y),
               stream_block_rows=BLOCK)
    for est in got:
        assert est.solver_info_["n_classes"] == 3
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF)
        np.testing.assert_array_equal(est.classes_, single.classes_)
        np.testing.assert_array_equal(est.classes_, ref.classes_)


def test_class_set_is_the_union_over_processes():
    X, y = _glm_data(seed=2, classes=3)
    order = np.argsort(y, kind="stable")      # rank 1 holds no class 0
    X, y = X[order], y[order]
    with config.set(stream_block_rows=BLOCK):
        single = LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
        got = _ranks(lambda r: LogisticRegression(
            solver="lbfgs", max_iter=30).fit(_half(X, r), _half(y, r)))
    ref = _jax(lambda: make_jax("lbfgs", "l2", {}, max_iter=30).fit(X, y),
               stream_block_rows=BLOCK)
    assert set(np.unique(_half(y, 1))) == {1.0, 2.0}
    for est in got:
        np.testing.assert_array_equal(est.classes_, [0.0, 1.0, 2.0])
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF)


def test_streamed_regression_matches_single():
    from dask_ml_tpu.linear_model import LinearRegression as JLinear

    rng = np.random.RandomState(3)
    X = rng.randn(3000, 6).astype(np.float32)
    y = (X @ rng.randn(6) + 0.1 * rng.randn(3000)).astype(np.float32)
    with config.set(stream_block_rows=BLOCK):
        single = LinearRegression(solver="lbfgs").fit(X, y)
        got = _ranks(lambda r: LinearRegression(solver="lbfgs").fit(
            _half(X, r), _half(y, r)))
    ref = _jax(lambda: JLinear(solver="lbfgs").fit(X, y),
               stream_block_rows=BLOCK)
    for est in got:
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF)


# -- the resident fits over process-local arrays -----------------------------

RESIDENT = [("lbfgs", "l2", {}), ("newton", "l2", {}),
            ("gradient_descent", "l2", {}),
            ("proximal_grad", "l1", {"C": 0.5}),
            ("lbfgs", "l2", {"solver_kwargs": {"use_kernel": False}})]


@pytest.mark.parametrize("solver,penalty,kw", RESIDENT,
                         ids=["lbfgs", "newton", "gradient_descent",
                              "proximal_grad", "lbfgs-plain"])
def test_resident_process_local_matches_single(solver, penalty, kw):
    """Against the port's single-process fit and JAX's. proximal_grad
    (C = 0.5) stops at float32's floor in both packages, where the
    port's own single-process fit parts from JAX's by 6.8e-4 in
    ``coef_`` (ISTA creeps along a flat valley); there the merged fit is
    held to JAX's by its float64 objective, rel 1e-6, and to its
    ``coef_`` at 1e-3."""
    X, y = _glm_data(seed=4)

    def make():
        return LogisticRegression(solver=solver, penalty=penalty,
                                  max_iter=60, **kw)

    single = make().fit(X, y)
    ref = _jax(lambda: make_jax(solver, penalty, kw).fit(X, y))

    def body(rank):
        Xl = dist.array_from_process_local(_half(X, rank))
        assert Xl.global_rows == X.shape[0]
        return make().fit(Xl, _half(y, rank))

    for est in _ranks(body):
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.intercept_, single.intercept_,
                                   atol=COEF)
        if solver == "proximal_grad":
            f, f_ref = (_objective(e, X, y, kw["C"]) for e in (est, ref))
            assert abs(f - f_ref) <= 1e-6 * f_ref
            np.testing.assert_allclose(est.coef_, ref.coef_, atol=1e-3)
            continue
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF)
        np.testing.assert_allclose(est.intercept_, ref.intercept_,
                                   atol=COEF)


def _objective(est, X, y, C):
    """The l1 logistic objective of a fitted estimator, in float64."""
    b = np.asarray(est.coef_, np.float64).ravel()
    eta = X.astype(np.float64) @ b + float(np.ravel(est.intercept_)[0])
    nll = np.mean(np.logaddexp(0.0, eta) - y * eta)
    return nll + np.abs(b).sum() / (C * len(y))


def test_resident_process_local_one_vs_rest_and_admm():
    X, y = _glm_data(seed=5, classes=3)
    single = LogisticRegression(solver="lbfgs", max_iter=50).fit(X, y)
    ref = _jax(lambda: make_jax("lbfgs", "l2", {}, max_iter=50).fit(X, y))
    got = _ranks(lambda r: LogisticRegression(solver="lbfgs", max_iter=50)
                 .fit(dist.array_from_process_local(_half(X, r)),
                      _half(y, r)))
    for est in got:
        assert est.solver_info_.get("fused_multi")
        np.testing.assert_allclose(est.coef_, single.coef_, atol=COEF)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF)
    # ADMM: each process one consensus member, converging to the optimum
    Xb, yb = _glm_data(seed=6)
    opt = LogisticRegression(solver="lbfgs", max_iter=200,
                             tol=1e-8).fit(Xb, yb)
    opt_ref = _jax(lambda: make_jax("lbfgs", "l2", {"tol": 1e-8},
                                    max_iter=200).fit(Xb, yb))
    got = _ranks(lambda r: LogisticRegression(max_iter=300).fit(
        dist.array_from_process_local(_half(Xb, r)), _half(yb, r)))
    np.testing.assert_array_equal(got[0].coef_, got[1].coef_)
    # the tol=1e-4 residual stop leaves both runs within 1 % of the optimum
    single = LogisticRegression(max_iter=300).fit(Xb, yb)
    for est in (got[0], single):
        for o in (opt, opt_ref):
            np.testing.assert_allclose(est.coef_, o.coef_, rtol=1e-2,
                                       atol=1e-3)


# -- KMeans --------------------------------------------------------------------

def _blobs(seed=7, n=4000, d=5, k=4):
    rng = np.random.RandomState(seed)
    C = rng.randn(k, d) * 6
    X = (C[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)
    return X, (C + 0.4 * rng.randn(k, d)).astype(np.float32)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["streamed", "resident"])
def test_kmeans_init_array_matches_single(resident):
    from dask_ml_tpu.cluster import KMeans as JKMeans

    X, init = _blobs()

    def fit(X_):
        return KMeans(4, init=init, max_iter=30).fit(X_)

    with config.set(stream_block_rows=BLOCK if not resident else 0):
        single = fit(X)
        got = _ranks(lambda r: fit(dist.array_from_process_local(
            _half(X, r)) if resident else _half(X, r)))
    ref = _jax(lambda: JKMeans(4, init=init, max_iter=30).fit(X))
    for est in got:
        np.testing.assert_allclose(est.cluster_centers_,
                                   single.cluster_centers_, atol=1e-3)
        assert abs(est.inertia_ - single.inertia_) <= 1e-4 * single.inertia_
        assert est.n_iter_ == single.n_iter_
        np.testing.assert_allclose(est.cluster_centers_,
                                   ref.cluster_centers_, atol=1e-3)
    labels = np.concatenate([np.asarray(
        e.labels_.to_numpy() if resident else e.labels_) for e in got])
    np.testing.assert_array_equal(
        labels, single.labels_.to_numpy() if resident else single.labels_)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["streamed", "resident"])
def test_kmeans_parallel_init_across_ranks(resident):
    from dask_ml_tpu.cluster import KMeans as JKMeans

    X, _ = _blobs(seed=8)
    with config.set(stream_block_rows=BLOCK if not resident else 0):
        single = KMeans(4, random_state=0).fit(X)
        got = _ranks(lambda r: KMeans(4, random_state=0).fit(
            dist.array_from_process_local(_half(X, r)) if resident
            else _half(X, r)))
    ref = _jax(lambda: JKMeans(4, random_state=0).fit(X),
               **({} if resident else {"stream_block_rows": BLOCK}))
    twins = [(single.cluster_centers_, single.inertia_),
             (np.asarray(ref.cluster_centers_), float(ref.inertia_))]
    for est in got:
        k2 = np.lexsort(est.cluster_centers_.T[::-1])
        for centers, inertia in twins:
            key = np.lexsort(centers.T[::-1])
            np.testing.assert_allclose(est.cluster_centers_[k2],
                                       centers[key], atol=1e-3)
            assert abs(est.inertia_ - inertia) <= 1e-4 * inertia
    np.testing.assert_array_equal(got[0].cluster_centers_,
                                  got[1].cluster_centers_)


# -- gradient-accumulation SGD ---------------------------------------------------

def _sgd_data(seed=9, n=4000, d=6, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    eta = X @ rng.randn(d)
    if classes == 2:
        return X, (eta > 0).astype(np.float32)
    return X, np.digitize(eta, [-0.5, 0.5]).astype(np.float32)


@pytest.mark.parametrize("classes", [2, 3])
def test_grad_accum_a1_bit_equal_to_sequential(classes):
    X, y = _sgd_data(classes=classes)
    seq = SGDClassifier(random_state=0, max_iter=3).fit(X, y)
    with config.set(stream_grad_accum=1):
        acc = SGDClassifier(random_state=0, max_iter=3).fit(X, y)
    np.testing.assert_array_equal(acc.coef_, seq.coef_)
    np.testing.assert_array_equal(acc.intercept_, seq.intercept_)
    assert acc._t == seq._t and acc.solver_info_["grad_accum"] == 1


def test_grad_accum_a1_bit_equal_on_the_nnz_route():
    import scipy.sparse as sp

    rng = np.random.RandomState(10)
    X = sp.random(3000, 40, density=0.05, random_state=rng,
                  dtype=np.float32, format="csr")
    y = (np.asarray(X.sum(1)).ravel() > 0.5).astype(np.float32)
    seq = SGDClassifier(random_state=0, max_iter=2).fit(X, y)
    with config.set(stream_grad_accum=1):
        acc = SGDClassifier(random_state=0, max_iter=2).fit(X, y)
    assert acc.solver_info_["sparse_stream"]
    np.testing.assert_array_equal(acc.coef_, seq.coef_)


@pytest.mark.parametrize("classes", [2, 3])
def test_grad_accum_two_ranks_match_one_process(classes):
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    X, y = _sgd_data(seed=11, classes=classes)
    block, A = 250, 2
    halves = [(_half(X, r), _half(y, r)) for r in range(2)]
    # one process at 2 x A over the ranks' group order
    xs, ys = [], []
    for lo in range(0, halves[0][0].shape[0], block * A):
        for Xh, yh in halves:
            xs.append(Xh[lo:lo + block * A])
            ys.append(yh[lo:lo + block * A])
    Xc, yc = np.concatenate(xs), np.concatenate(ys)
    with config.set(stream_grad_accum=2 * A, stream_block_rows=block):
        twin = SGDClassifier(random_state=0, max_iter=2, shuffle=False).fit(
            Xc, yc)
    ref = _jax(lambda: JSGD(random_state=0, max_iter=2, shuffle=False).fit(
        Xc, yc), stream_grad_accum=2 * A, stream_block_rows=block)
    assert ref.solver_info_["grad_accum"] == 2 * A

    def body(rank):
        with config.set(stream_grad_accum=A, stream_block_rows=block):
            return SGDClassifier(random_state=0, max_iter=2,
                                 shuffle=False).fit(*halves[rank])

    for est in _ranks(body):
        for t in (twin, ref):
            np.testing.assert_allclose(est.coef_, t.coef_, atol=1e-6)
            assert est._t == t._t


def test_grad_accum_uneven_ranks_join_every_merge():
    X, y = _sgd_data(seed=12)

    def body(rank):
        part = slice(0, 2500) if rank == 0 else slice(2500, 4000)
        with config.set(stream_grad_accum=2, stream_block_rows=250):
            return SGDClassifier(random_state=0, max_iter=2).fit(
                X[part], y[part])

    a, b = _ranks(body)
    np.testing.assert_array_equal(a.coef_, b.coef_)
    assert a._t == b._t == 2 * 5


# -- decompositions -------------------------------------------------------------

def _decomp_data(seed=13, n=4000, d=16):
    rng = np.random.RandomState(seed)
    scale = np.geomspace(4.0, 0.05, d)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    return ((rng.randn(n, d) * scale) @ basis + 2.0).astype(np.float32)


@pytest.mark.parametrize("solver", ["full", "randomized"])
def test_streamed_pca_matches_single(solver, jax_omega):
    from dask_ml_tpu.decomposition import PCA as JPCA

    X = _decomp_data()

    def make(cls):
        return cls(5, svd_solver=solver, random_state=0)

    with config.set(stream_block_rows=BLOCK):
        single = make(PCA).fit(X)
        got = _ranks(lambda r: make(PCA).fit(_half(X, r)))
    ref = _jax(lambda: make(JPCA).fit(X), stream_block_rows=BLOCK)
    s0 = single.singular_values_[0]
    for est in got:
        np.testing.assert_allclose(est.singular_values_,
                                   single.singular_values_, rtol=1e-5)
        np.testing.assert_allclose(est.components_, single.components_,
                                   atol=1e-4)
        np.testing.assert_allclose(est.mean_, single.mean_, atol=1e-5)
        assert np.abs(est.singular_values_ - ref.singular_values_).max() \
            <= 1e-4 * s0


def test_streamed_truncated_svd_matches_single(jax_omega):
    from dask_ml_tpu.decomposition import TruncatedSVD as JTSVD

    X = _decomp_data(seed=14)
    with config.set(stream_block_rows=BLOCK):
        single = TruncatedSVD(4, algorithm="randomized",
                              random_state=0).fit(X)
        got = _ranks(lambda r: TruncatedSVD(
            4, algorithm="randomized", random_state=0).fit(_half(X, r)))
    ref = _jax(lambda: JTSVD(4, algorithm="randomized",
                             random_state=0).fit(X), stream_block_rows=BLOCK)
    for est in got:
        for t in (single, ref):
            np.testing.assert_allclose(est.singular_values_,
                                       t.singular_values_, rtol=1e-5)
            # a component's sign is arbitrary
            np.testing.assert_allclose(np.abs(est.components_),
                                       np.abs(np.asarray(t.components_)),
                                       atol=1e-4)


# -- refusals ------------------------------------------------------------------

def test_refusals_across_processes():
    X, y = _sgd_data(seed=15)

    def ipca(rank):
        IncrementalPCA(2).fit(_half(X, rank))

    with pytest.raises(NotImplementedError,
                       match="IncrementalPCA is single-process"):
        _ranks(ipca)

    def sgd(rank):
        SGDClassifier().fit(_half(X, rank), _half(y, rank))

    with pytest.raises(NotImplementedError,
                       match="config.stream_grad_accum=A"):
        _ranks(sgd)

    def local_sgd(rank):
        return SGDClassifier(max_iter=2).fit(
            dist.array_from_process_local(_half(X, rank)),
            _half(y, rank)).coef_

    # a process-local array fits the global array on every rank (held to
    # the single-process fit in test_sgd_process_local_matches_single)
    a, b = _ranks(local_sgd)
    np.testing.assert_array_equal(a, b)
    with config.set(stream_grad_accum=2, stream_nonfinite="quarantine"):
        with pytest.raises(ValueError, match="quarantine"):
            SGDClassifier().fit(X, y)
    with config.set(stream_grad_accum=2, stream_checkpoint_path="/x"):
        with pytest.warns(RuntimeWarning, match="does not checkpoint"):
            SGDClassifier(max_iter=1).fit(X, y)


# -- searches ----------------------------------------------------------------

def _search_data():
    from sklearn.datasets import make_classification

    X, y = make_classification(n_samples=400, n_features=8,
                               n_informative=4, random_state=0)
    return X.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("world", [2, 3])
def test_grid_search_striped_over_ranks(world):
    from dask_ml_tpu.linear_model import LogisticRegression as JLR
    from dask_ml_tpu.model_selection import GridSearchCV as JGrid

    from dask_ml_tpu_torch.model_selection import GridSearchCV

    X, y = _search_data()
    grid = {"C": [0.01, 0.1, 1.0, 10.0]}
    seq = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=25),
                       grid, cv=2, scheduler="synchronous",
                       refit=False).fit(X, y)
    expected = np.asarray(seq.cv_results_["mean_test_score"])
    ref = _jax(lambda: JGrid(JLR(solver="lbfgs", max_iter=25), grid, cv=2,
                             scheduler="synchronous", refit=False).fit(X, y))

    def body(rank):
        s = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=25),
                         grid, cv=2, refit=True).fit(X, y)
        n_local, n_total, proc, n_proc = s._dist_stats
        assert (proc, n_proc, n_total) == (rank, world, 8)
        assert n_local == len(range(rank, 8, world))
        assert not hasattr(s, "_c_grid_vmapped_")  # fast path off
        assert s.best_estimator_.score(X, y) > 0.7
        return np.asarray(s.cv_results_["mean_test_score"])

    for scores in _ranks(body, world):
        assert not np.isnan(scores).any()
        np.testing.assert_array_equal(scores, expected)
        np.testing.assert_allclose(
            scores, ref.cv_results_["mean_test_score"], atol=1e-4)


def test_grid_search_failure_fails_every_rank():
    from dask_ml_tpu_torch.model_selection import GridSearchCV

    X, y = _search_data()
    seen = {}

    def body(rank):
        # rank 1's copy of the targets holds one class: its trials raise
        yy = y if rank == 0 else np.zeros_like(y)
        try:
            GridSearchCV(LogisticRegression(max_iter=5), {"C": [0.1, 1.0]},
                         cv=2, error_score="raise").fit(X, yy)
        except Exception as exc:
            seen[rank] = exc
            raise

    with pytest.raises(ValueError, match="at least 2 classes"):
        _ranks(body)
    assert isinstance(seen[0], RuntimeError)
    assert "peer process failed during distributed search" in str(seen[0])


def test_hyperband_brackets_striped_over_ranks():
    from dask_ml_tpu.model_selection import HyperbandSearchCV as JHB
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    from dask_ml_tpu_torch.model_selection import HyperbandSearchCV

    rng = np.random.RandomState(0)
    X = rng.randn(600, 6).astype(np.float32)
    y = (X @ rng.randn(6) > 0).astype(np.float32)
    params = {"alpha": [1e-5, 1e-4, 1e-3, 1e-2], "eta0": [0.05, 0.5]}

    def run(ms_hb, sgd):
        s = ms_hb(sgd(tol=1e-3, random_state=0), params, max_iter=9,
                  aggressiveness=3, random_state=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return s.fit(X, y, classes=[0.0, 1.0])

    solo = run(HyperbandSearchCV, SGDClassifier)
    ref = _jax(lambda: run(JHB, JSGD))

    def body(rank):
        s = run(HyperbandSearchCV, SGDClassifier)
        assert s._dist_stats == (rank, 2)
        assert {r["bracket"] for r in s.history_} == {0, 1, 2}
        assert 0.0 <= s.best_estimator_.score(X, y) <= 1.0
        return s

    for s in _ranks(body):
        np.testing.assert_array_equal(s.cv_results_["test_score"],
                                      solo.cv_results_["test_score"])
        assert s.cv_results_["params"] == solo.cv_results_["params"]
        assert s.best_score_ == solo.best_score_
        assert len(s.history_) == len(solo.history_)
        assert s.metadata_["partial_fit_calls"] == \
            solo.metadata_["partial_fit_calls"]
        np.testing.assert_allclose(s.cv_results_["test_score"],
                                   ref.cv_results_["test_score"],
                                   atol=2.0 / 90)


def test_adaptive_search_owned_candidates_match_jax():
    """The JAX package's own twin of this test (tests/test_distributed.py)
    holds its virtual world to its single-process search; here the port's
    virtual world is held to dask_ml_tpu's single-process search on one
    device (its virtual ranks split eight devices, and the blocks follow
    the devices)."""
    from sklearn.linear_model import SGDClassifier as SkSGD

    from dask_ml_tpu.model_selection import IncrementalSearchCV as JInc
    from dask_ml_tpu_torch.model_selection import IncrementalSearchCV

    rng = np.random.RandomState(0)
    X = rng.randn(500, 6).astype(np.float32)
    y = (X @ rng.randn(6) > 0).astype(np.float32)
    params = {"alpha": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0]}

    def run(cls):
        s = cls(SkSGD(tol=None, random_state=7), params,
                n_initial_parameters="grid", decay_rate=1.0, max_iter=6,
                random_state=0)
        return s.fit(X, y, classes=[0.0, 1.0])

    ref = _jax(lambda: run(JInc))

    def body(rank):
        s = run(IncrementalSearchCV)
        owners = {r["model_id"] % 2 for r in s.history_
                  if r["owner"] == rank}
        assert owners == {rank} and s._dist_stats == (rank, 2)
        assert {r["owner"] for r in s.history_} == {0, 1}
        return s

    for s in _ranks(body):
        np.testing.assert_allclose(s.cv_results_["test_score"],
                                   ref.cv_results_["test_score"], atol=1e-6)
        np.testing.assert_array_equal(s.cv_results_["partial_fit_calls"],
                                      ref.cv_results_["partial_fit_calls"])
        assert abs(s.best_score_ - ref.best_score_) < 1e-6
        assert len(s.history_) == len(ref.history_)


def test_adaptive_search_port_cohorts_owned_across_ranks():
    from dask_ml_tpu_torch.model_selection import IncrementalSearchCV

    X, y = _sgd_data(seed=16, n=2000)
    params = {"alpha": [1e-5, 1e-4, 1e-3, 1e-2], "eta0": [0.05, 0.5]}

    def make():
        return IncrementalSearchCV(SGDClassifier(random_state=0), params,
                                   n_initial_parameters="grid", max_iter=5,
                                   random_state=0)

    solo = make().fit(X, y, classes=[0.0, 1.0])

    def body(rank):
        s = make().fit(X, y, classes=[0.0, 1.0])
        assert {r["owner"] for r in s.history_} == {0, 1}
        return s

    for s in _ranks(body):
        np.testing.assert_allclose(s.cv_results_["test_score"],
                                   solo.cv_results_["test_score"], atol=1e-6)
        np.testing.assert_array_equal(s.cv_results_["partial_fit_calls"],
                                      solo.cv_results_["partial_fit_calls"])
        np.testing.assert_allclose(s.best_estimator_.coef_,
                                   solo.best_estimator_.coef_, atol=1e-6)

    def no_seed(rank):
        IncrementalSearchCV(SGDClassifier(), params).fit(X, y)

    with pytest.raises(ValueError, match="fixed random_state"):
        _ranks(no_seed)


# -- uneven and empty ranks ----------------------------------------------------
# Every fit agrees on its route (``fit_stream_plan``): a rank no taller
# than a block streams its one block, an empty rank none, and both add
# their sums (zero) to every merge. Each fit is held to the single-process
# fit of the concatenated rows, in both packages (ROADMAP.md, "Oracles").

UNEVEN = {"2500/1000/500": (2500, 1000, 500),
          "2500/900/600": (2500, 900, 600),
          "3700/300": (3700, 300),
          "4000/0": (4000, 0)}
UNEVEN_FITS = ["stream_lbfgs", "resident_lbfgs", "stream_kmeans",
               "resident_kmeans", "stream_pca", "resident_pca"]


def _split(a, counts, rank):
    lo = int(sum(counts[:rank]))
    return a[lo:lo + counts[rank]]


def _uneven_data(kind):
    if kind.endswith("lbfgs"):
        return _glm_data(seed=21)
    if kind.endswith("kmeans"):
        return _blobs(seed=22, n=4000, d=8)
    rng = np.random.RandomState(23)
    X = (rng.randn(4000, 8) * np.linspace(3, 0.3, 8) + 1.0)
    return X.astype(np.float32), None


def _uneven_fit(kind, X, y, init):
    if kind.endswith("lbfgs"):
        return LogisticRegression(solver="lbfgs", max_iter=40).fit(X, y)
    if kind.endswith("kmeans"):
        return KMeans(4, init=init, max_iter=40).fit(X)
    return PCA(4, svd_solver="full").fit(X)


_UNEVEN_REFS = {}


def _uneven_refs(kind):
    """(the port's single-process fit, JAX's) of the concatenated rows."""
    if kind not in _UNEVEN_REFS:
        from dask_ml_tpu.cluster import KMeans as JKMeans
        from dask_ml_tpu.decomposition import PCA as JPCA
        from dask_ml_tpu.linear_model import LogisticRegression as JLR

        X, y = _uneven_data(kind)
        streamed = kind.startswith("stream")
        with config.set(stream_block_rows=BLOCK if streamed else 0):
            one = _uneven_fit(kind, X, y, y)
        # the streamed lbfgs against JAX's streamed fit (the same host
        # solver), the resident one against JAX's resident fit
        cfg = {"stream_block_rows": BLOCK} if streamed else {}
        if kind.endswith("lbfgs"):
            ref = _jax(lambda: JLR(solver="lbfgs", max_iter=40).fit(X, y),
                       **cfg)
        elif kind.endswith("kmeans"):
            ref = _jax(lambda: JKMeans(4, init=y, max_iter=40).fit(X))
        else:
            ref = _jax(lambda: JPCA(4, svd_solver="full").fit(X))
        _UNEVEN_REFS[kind] = (one, ref)
    return _UNEVEN_REFS[kind]


@pytest.mark.parametrize("kind", UNEVEN_FITS)
@pytest.mark.parametrize("case", list(UNEVEN))
def test_uneven_and_empty_ranks_match_single(case, kind):
    counts = UNEVEN[case]
    X, y = _uneven_data(kind)
    one, ref = _uneven_refs(kind)
    streamed = kind.startswith("stream")

    def body(rank):
        Xr = _split(X, counts, rank)
        if not streamed:
            Xr = dist.array_from_process_local(Xr)
        yr = _split(y, counts, rank) if kind.endswith("lbfgs") else y
        with config.set(stream_block_rows=BLOCK):
            return _uneven_fit(kind, Xr, yr, y)

    # a rank that hung would fail here at the deadline, not hang the suite
    got = dist.run_virtual_processes(body, len(counts), timeout=60)
    for est in got:
        if streamed:
            # every rank streamed, the short and the empty one too
            assert est.stream_stats_["passes"] > 0
        if kind.endswith("lbfgs"):
            if streamed:
                assert est.solver_info_["streamed"]
            np.testing.assert_array_equal(est.coef_, got[0].coef_)
            for twin in (one, ref):
                np.testing.assert_allclose(est.coef_, twin.coef_, atol=COEF)
                np.testing.assert_allclose(est.intercept_, twin.intercept_,
                                           atol=COEF)
        elif kind.endswith("kmeans"):
            for twin in (one, ref):
                np.testing.assert_allclose(est.cluster_centers_,
                                           np.asarray(twin.cluster_centers_),
                                           atol=1e-3)
                assert abs(est.inertia_ - float(twin.inertia_)) <= \
                    1e-4 * abs(float(twin.inertia_))
                assert est.n_iter_ == int(twin.n_iter_)
        else:
            for twin in (one, ref):
                np.testing.assert_allclose(
                    est.singular_values_, np.asarray(twin.singular_values_),
                    rtol=1e-5)
                np.testing.assert_allclose(
                    np.abs(est.components_),
                    np.abs(np.asarray(twin.components_)), atol=1e-4)


@pytest.mark.parametrize("counts", [(1700, 800, 500), (3000, 0)],
                         ids=["1700/800/500", "3000/0"])
@pytest.mark.parametrize("classes", [2, 3])
def test_sgd_process_local_matches_single(counts, classes):
    X, y = _sgd_data(seed=31, n=3000, classes=classes)
    one = SGDClassifier(max_iter=3, random_state=0).fit(
        ShardedArray.from_array(X), y)

    def body(rank):
        return SGDClassifier(max_iter=3, random_state=0).fit(
            dist.array_from_process_local(_split(X, counts, rank)),
            _split(y, counts, rank))

    for est in dist.run_virtual_processes(body, len(counts), timeout=60):
        np.testing.assert_array_equal(est.classes_, one.classes_)
        assert est._t == one._t
        np.testing.assert_allclose(est.coef_, one.coef_, atol=1e-5)
        np.testing.assert_allclose(est.intercept_, one.intercept_,
                                   atol=1e-5)


@pytest.mark.parametrize("scaler", ["StandardScaler", "MinMaxScaler",
                                    "RobustScaler", "QuantileTransformer"])
def test_scalers_over_partitioned_frames_match_single(scaler):
    pd = pytest.importorskip("pandas")
    from dask_ml_tpu_torch import preprocessing as TP
    from dask_ml_tpu_torch.parallel import PartitionedFrame, from_pandas

    rng = np.random.RandomState(33)
    df = pd.DataFrame(rng.randn(900, 3) * [1.0, 5.0, 0.2] + [0.0, 3.0, -1.0],
                      columns=list("abc"))
    counts = (500, 400, 0)
    make = getattr(TP, scaler)
    kw = {"n_quantiles": 50} if scaler == "QuantileTransformer" else {}
    one = make(**kw).fit(df.to_numpy(np.float32))

    def body(rank):
        part = _split(df, counts, rank)
        pf = from_pandas(part, 2) if len(part) else PartitionedFrame([part])
        est = make(**kw).fit(pf)
        out = est.transform(pf)
        return est, out.compute().to_numpy() if len(part) else None

    got = dist.run_virtual_processes(body, len(counts), timeout=60)
    attrs = {"StandardScaler": ("mean_", "var_", "scale_"),
             "MinMaxScaler": ("data_min_", "data_max_", "scale_", "min_"),
             "RobustScaler": ("center_", "scale_"),
             "QuantileTransformer": ("quantiles_",)}[scaler]
    for est, out in got:
        for a in attrs:
            np.testing.assert_allclose(getattr(est, a), getattr(one, a),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([o for _, o in got if o is not None]),
        one.transform(df.to_numpy(np.float32)).to_numpy(), rtol=1e-5,
        atol=1e-5)
