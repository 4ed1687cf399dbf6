"""The port's fits of sparse sources (scipy CSR and ``SparseBlocks``)
against dask_ml_tpu's fits of the same matrix densified and held
resident, on the CPU.

The port streams a sparse X in ``config.stream_block_rows`` blocks (400
rows here: 1000 rows in three blocks, the last ragged) on the nnz route
(``solver_info_["sparse_stream"]``), where the passes run the sparse
products of ``ops/sparse_kernels.py``; dask_ml_tpu fits the dense
ndarray in memory on one device. dask_ml_tpu's own streamed sparse path
is not the reference: three of its sparse tests fail (ROADMAP.md queue
3). The solvers are other algorithms on the two sides (the port's host
loop of the streamed solvers, dask_ml_tpu's resident loops), so the
fits are held at the optimum: tolerances each reaches on this data in
float32 (smooth penalty C = 0.05 for the smooth solvers, l1 at C = 0.05
for proximal_grad), ``coef_`` and ``intercept_`` within COEF_ATOL
(5e-4). The port's densify route (``stream_sparse=False``) runs the
same solver on the same blocks densified, and agrees with the nnz route
within 1e-5.

dask_ml_tpu runs under ``stream_mesh=1`` and a one-device mesh, its
host streams with fresh staging buffers (``_PUT_ALIASES``), as in the
other streamed test files.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.decomposition import PCA as JPCA
from dask_ml_tpu.decomposition import IncrementalPCA as JIPCA
from dask_ml_tpu.decomposition import TruncatedSVD as JTSVD
from dask_ml_tpu.model_selection import GridSearchCV as JGridSearchCV
from dask_ml_tpu.model_selection import train_test_split as j_split
from dask_ml_tpu.naive_bayes import GaussianNB as JGaussianNB
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu import wrappers as JW
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import wrappers as TW
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA, IncrementalPCA, TruncatedSVD
import dask_ml_tpu_torch.linear_model as T
from dask_ml_tpu_torch.model_selection import (GridSearchCV, KFold,
                                               IncrementalSearchCV,
                                               train_test_split)
from dask_ml_tpu_torch.naive_bayes import GaussianNB
from dask_ml_tpu_torch.parallel.streaming import SparseBlocks

BLOCK = 400
COEF_ATOL = 5e-4
ROUTE_ATOL = 1e-5
TOL = {"lbfgs": 1e-5, "gradient_descent": 1e-5, "proximal_grad": 1e-6,
       "newton": 1e-6, "admm": 1e-5}


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _jax(fn):
    with jconfig.set(stream_mesh=1), use_mesh(
            device_mesh(devices=jax.devices()[:1])):
        return fn()


def _corpus(seed=0, n=1000, d=20, density=0.2):
    """A seeded CSR matrix (float64 values in [0, 2)), its dense float32
    twin, binary and 3-class targets from a linear score."""
    rng = np.random.RandomState(seed)
    A = sp.random(n, d, density=density, format="csr", random_state=rng,
                  dtype=np.float64)
    A.data *= 2.0
    D = A.toarray().astype(np.float32)
    eta = A @ rng.randn(d)
    eta -= eta.mean()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    y3 = np.digitize(eta, [-0.5, 0.5]).astype(np.float32) * 2 + 1
    return A, D, y, y3


A, D, Y2, Y3 = _corpus()


def _blocks(A):
    return SparseBlocks([A[:333], A[333:700], A[700:]])


def _kw(solver):
    kw = dict(solver=solver, tol=TOL[solver], max_iter=400, C=0.05)
    if solver == "proximal_grad":
        kw["penalty"] = "l1"
    return kw


def _port_fit(est, X, y, **cfg):
    with config.set(stream_block_rows=BLOCK, **cfg):
        return est.fit(X, y)


@pytest.mark.parametrize("solver", ["lbfgs", "gradient_descent",
                                    "proximal_grad", "newton", "admm"])
def test_glm_binary_matches_jax_resident(solver):
    kw = _kw(solver)
    j = _jax(lambda: J.LogisticRegression(**kw).fit(D, Y2))
    t = _port_fit(T.LogisticRegression(**kw), A, Y2)
    info = t.solver_info_
    assert info["streamed"] and info["n_blocks"] == 3
    if solver == "admm":
        assert not info["sparse_stream"]
        assert info["sparse_stream_reason"] == "admm-local-newton"
    else:
        assert info["sparse_stream"] and info["sparse_stream_reason"] is None
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    if solver == "lbfgs":
        r = _port_fit(T.LogisticRegression(**kw), A, Y2,
                      stream_sparse=False)
        # within what COEF_ATOL lets a decision value move
        edge = COEF_ATOL * (np.abs(D).sum(1) + 1.0)
        assert np.all(np.abs(t.decision_function(A)
                             - j.decision_function(D)) <= edge)
        np.testing.assert_allclose(t.decision_function(A),
                                   t.decision_function(D), atol=1e-5)
        np.testing.assert_allclose(t.predict_proba(A), r.predict_proba(D),
                                   atol=1e-5)


@pytest.mark.parametrize("solver", ["lbfgs", "gradient_descent",
                                    "proximal_grad", "newton", "admm"])
def test_nnz_route_matches_densify_route(solver):
    """The nnz route against the densify route (``stream_sparse=False``)
    on the same blocks: one pass's value and gradient within 1e-6, and
    the fits within 1e-5 at the tolerances the solvers resolve before
    float32 does (tests/test_torch_stream_glm.py's: closer to the
    optimum the two summation orders part an Armijo test)."""
    from dask_ml_tpu_torch.models.solvers.streamed import StreamedObjective
    from dask_ml_tpu_torch.parallel.streaming import BlockStream

    beta = np.linspace(-0.5, 0.5, 21)
    sums = []
    for on in (True, False):
        with config.set(stream_sparse=on):
            stream = BlockStream((A, Y2), block_rows=BLOCK)
        assert stream.nnz_route == on
        obj = StreamedObjective(stream, 1000, 0.01, np.ones(21), 0.5,
                                "logistic", "l2", True)
        sums.append(obj.value_and_grad(beta))
    assert sums[0][0] == pytest.approx(sums[1][0], rel=1e-6)
    np.testing.assert_allclose(sums[0][1], sums[1][1], atol=1e-6)
    kw = dict(_kw(solver), tol={"newton": 1e-4, "admm": 1e-4}.get(
        solver, 1e-3))
    t = _port_fit(T.LogisticRegression(**kw), A, Y2)
    r = _port_fit(T.LogisticRegression(**kw), A, Y2, stream_sparse=False)
    assert r.solver_info_["sparse_stream_reason"] == "stream-sparse-off"
    assert t.n_iter_ == r.n_iter_
    np.testing.assert_allclose(t.coef_, r.coef_, atol=ROUTE_ATOL)


@pytest.mark.parametrize("solver", ["lbfgs", "newton", "admm"])
def test_glm_ovr_matches_jax_resident(solver):
    kw = _kw(solver)
    if solver == "lbfgs":
        kw["tol"] = 1e-4   # the joint (C * d,) gradient's f32 floor
    j = _jax(lambda: J.LogisticRegression(**kw).fit(D, Y3))
    t = _port_fit(T.LogisticRegression(**kw), A, Y3)
    assert t.solver_info_["n_classes"] == 3
    assert t.solver_info_["sparse_stream"] == (solver != "admm")
    if solver == "newton":
        assert t.solver_info_["fused_stream_reason"] == \
            "multiclass-hessian-plain"
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    np.testing.assert_array_equal(t.predict(A), _jax(lambda: j.predict(D)))


def test_sparse_blocks_source_equals_csr():
    """A SparseBlocks view streams the same blocks as the CSR it splits:
    the fits are bit-equal, as are two runs of one fit."""
    kw = _kw("lbfgs")
    a = _port_fit(T.LogisticRegression(**kw), A, Y2)
    b = _port_fit(T.LogisticRegression(**kw), _blocks(A), Y2)
    c = _port_fit(T.LogisticRegression(**kw), A, Y2)
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.coef_, c.coef_)
    assert b.stream_stats_["nnz"] == A.nnz * b.stream_stats_["passes"]


def test_glm_reasons_and_densify_fallback():
    kw = _kw("lbfgs")
    t = _port_fit(T.LogisticRegression(**kw), A, Y2,
                  stream_sparse_max_density=0.1)
    assert not t.solver_info_["sparse_stream"]
    assert t.solver_info_["sparse_stream_reason"] == \
        "density 0.2000 > stream_sparse_max_density 0.1"
    d = _port_fit(T.LogisticRegression(**kw), D, Y2)
    assert d.solver_info_["sparse_stream_reason"] == "dense-source"
    n = _port_fit(T.LogisticRegression(**kw), A, Y2)
    np.testing.assert_allclose(t.coef_, n.coef_, atol=ROUTE_ATOL)
    np.testing.assert_allclose(d.coef_, n.coef_, atol=ROUTE_ATOL)


def test_regressions_match_jax_resident():
    y = (A @ np.linspace(-1, 1, 20) + 0.1).astype(np.float32)
    kw = dict(solver="lbfgs", tol=1e-5, max_iter=400, C=0.05)
    j = _jax(lambda: J.LinearRegression(**kw).fit(D, y))
    t = _port_fit(T.LinearRegression(**kw), A, y)
    assert t.solver_info_["sparse_stream"]
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.predict(A), _jax(lambda: j.predict(D)),
                               atol=1e-3)
    yp = np.random.RandomState(3).poisson(np.exp(0.3 * y)).astype(
        np.float32)
    kw["tol"] = 1e-4   # the Poisson loss's f32 floor on this data
    j = _jax(lambda: J.PoissonRegression(**kw).fit(D, yp))
    t = _port_fit(T.PoissonRegression(**kw), A, yp)
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)


def test_c_grid_densifies_a_sparse_fold():
    """The C-grid fast path densifies a sparse fold once (reason on
    record); over the byte budget it leaves the fold to the streamed
    per-candidate fits. GridSearchCV over CSR matches dask_ml_tpu's over
    the same CSR."""
    est = T.LogisticRegression(solver="lbfgs", max_iter=100)
    fits = est._fit_C_grid(A, Y2, [0.1, 1.0])
    dense = est._fit_C_grid(D, Y2, [0.1, 1.0])
    for f, g in zip(fits, dense):
        assert f.solver_info_["sparse_stream_reason"] == "search-dense-solve"
        np.testing.assert_array_equal(f.coef_, g.coef_)
    with config.set(to_dense_byte_budget=1000):
        assert est._fit_C_grid(A, Y2, [0.1, 1.0]) is None
    grid = {"C": [0.1, 1.0]}
    t = GridSearchCV(T.LogisticRegression(solver="lbfgs", max_iter=100),
                     grid, cv=3).fit(A, Y2)
    j = _jax(lambda: JGridSearchCV(
        J.LogisticRegression(solver="lbfgs", max_iter=100), grid,
        cv=3).fit(A, Y2))
    assert t.best_params_ == j.best_params_
    np.testing.assert_allclose(t.cv_results_["mean_test_score"],
                               j.cv_results_["mean_test_score"], atol=2e-3)


@pytest.mark.parametrize("kind", ["binary", "multi", "regression"])
def test_sgd_matches_jax_dense(kind):
    """The same minibatches (grid_partition's 8 blocks of 125 rows, one
    shuffled order) through the sparse step and dask_ml_tpu's dense
    step."""
    from dask_ml_tpu.models import sgd as JS
    from dask_ml_tpu_torch.models import sgd as TS

    y = {"binary": Y2, "multi": Y3,
         "regression": (A @ np.linspace(-1, 1, 20)).astype(np.float32)
         }[kind]
    name = "SGDRegressor" if kind == "regression" else "SGDClassifier"
    kw = dict(max_iter=3, random_state=0, alpha=1e-3)
    j = _jax(lambda: getattr(JS, name)(**kw).fit(D, y))
    t = getattr(TS, name)(**kw).fit(A, y)
    info = t.solver_info_
    assert info["sparse_stream"] and info["fused_stream_reason"] == \
        "sparse-stream" and info["n_blocks"] == 8
    np.testing.assert_allclose(t.coef_, j.coef_, atol=1e-5)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=1e-5)
    np.testing.assert_allclose(
        t.predict(A) if kind == "regression" else t.decision_function(A),
        _jax(lambda: j.predict(D) if kind == "regression"
             else j.decision_function(D)), atol=1e-4)
    with config.set(stream_sparse=False):
        r = getattr(TS, name)(**kw).fit(A, y)
    assert r.solver_info_["sparse_stream_reason"] == "stream-sparse-off"
    np.testing.assert_allclose(t.coef_, r.coef_, atol=ROUTE_ATOL)


def test_incremental_sgd_matches_jax_dense():
    from dask_ml_tpu.models import sgd as JS
    from dask_ml_tpu_torch.models import sgd as TS

    kw = dict(alpha=1e-3, eta0=0.05)
    j = _jax(lambda: JW.Incremental(JS.SGDClassifier(**kw),
                                    random_state=0).fit(D, Y2))
    for X in (A, _blocks(A)):
        t = TW.Incremental(TS.SGDClassifier(**kw), random_state=0).fit(X, Y2)
        np.testing.assert_allclose(t.estimator_.coef_, j.estimator_.coef_,
                                   atol=1e-5)
        np.testing.assert_array_equal(t.predict(X),
                                      _jax(lambda: j.predict(D)))


def test_kmeans_matches_jax_resident():
    init = D[:4].copy()
    kw = dict(n_clusters=4, init=init, max_iter=10, tol=0.0)
    j = _jax(lambda: JKMeans(**kw).fit(D))
    t = _port_fit(KMeans(**kw), A, None)
    assert t.kernel_info_["sparse_stream"]
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               atol=1e-5)
    np.testing.assert_array_equal(t.labels_, np.asarray(j.labels_.to_numpy()
                                  if hasattr(j.labels_, "to_numpy")
                                  else j.labels_))
    assert t.inertia_ == pytest.approx(j.inertia_, rel=1e-5)
    with config.set(stream_block_rows=BLOCK):
        np.testing.assert_array_equal(t.predict(A), t.labels_)
        np.testing.assert_allclose(t.transform(_blocks(A)),
                                   np.asarray(_jax(lambda: j.transform(D))
                                              .to_numpy()), atol=1e-4)
    # k-means|| draws the port's own way; it seeds on dense blocks made on
    # the device and reaches the same fit from the CSR and the dense rows
    s = _port_fit(KMeans(n_clusters=4, random_state=0, max_iter=20), A, None)
    r = _port_fit(KMeans(n_clusters=4, random_state=0, max_iter=20), D, None)
    np.testing.assert_allclose(s.cluster_centers_, r.cluster_centers_,
                               atol=1e-5)


def test_decompositions_match_jax_resident():
    """TruncatedSVD (randomized, streamed) and PCA stream the sparse X
    densified a block at a time; four power iterations reach the top
    components of the exact SVD, held to dask_ml_tpu's resident fits."""
    # columns scaled to a decaying spectrum (the sparsity kept), so the
    # range finder's power iterations converge
    S = A @ sp.diags(np.geomspace(4.0, 0.1, 20))
    SD = S.toarray().astype(np.float32)
    t = _port_fit(TruncatedSVD(n_components=3, algorithm="randomized",
                               n_iter=6, random_state=0), S, None)
    j = _jax(lambda: JTSVD(n_components=3, algorithm="tsqr").fit(SD))
    np.testing.assert_allclose(t.singular_values_, j.singular_values_,
                               rtol=1e-4)
    np.testing.assert_allclose(np.abs(t.components_),
                               np.abs(j.components_), atol=1e-3)
    p = _port_fit(PCA(n_components=3), S, None)
    jp = _jax(lambda: JPCA(n_components=3).fit(SD))
    np.testing.assert_allclose(p.explained_variance_,
                               jp.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(np.abs(p.components_),
                               np.abs(jp.components_), atol=1e-4)
    ip = IncrementalPCA(n_components=3, batch_size=250).fit(S)
    jip = _jax(lambda: JIPCA(n_components=3, batch_size=250).fit(SD))
    np.testing.assert_allclose(ip.singular_values_, jip.singular_values_,
                               rtol=1e-4)
    def host(a):
        return np.asarray(a.to_numpy() if hasattr(a, "to_numpy") else a)

    np.testing.assert_allclose(np.abs(host(ip.transform(S))),
                               np.abs(host(_jax(lambda: jip.transform(SD)))),
                               atol=1e-3)


def test_gaussian_nb_matches_jax():
    j = _jax(lambda: JGaussianNB().fit(D, Y3))
    t = GaussianNB().fit(A, Y3)
    np.testing.assert_allclose(t.theta_, j.theta_, atol=1e-5)
    np.testing.assert_allclose(t.var_, j.var_, rtol=1e-4)
    np.testing.assert_array_equal(t.predict(A), _jax(lambda: np.asarray(
        j.predict(D))))
    inc = TW.Incremental(GaussianNB()).fit(_blocks(A), Y3)
    np.testing.assert_allclose(inc.estimator_.theta_, j.theta_, atol=1e-5)


def test_splits_keep_sparse_folds():
    """train_test_split and KFold gather CSR rows (never densified), the
    rows dask_ml_tpu picks."""
    parts = train_test_split(A, Y2, test_size=0.25, random_state=3)
    jparts = j_split(A, Y2, test_size=0.25, random_state=3)
    for p, q in zip(parts, jparts):
        if sp.issparse(p):
            assert sp.issparse(q)
            np.testing.assert_array_equal(p.toarray(), q.toarray())
        else:
            np.testing.assert_array_equal(p, np.asarray(q))
    bparts = train_test_split(_blocks(A), Y2, test_size=0.25,
                              random_state=3)
    assert sp.issparse(bparts[0])
    np.testing.assert_array_equal(bparts[1].toarray(), parts[1].toarray())
    from dask_ml_tpu_torch.model_selection._split import take_rows

    for tr, te in KFold(n_splits=3).split(A):
        assert sp.issparse(take_rows(A, te))
        np.testing.assert_array_equal(take_rows(A, te).toarray(),
                                      A.toarray()[te])


def test_incremental_search_sparse_plane():
    """An adaptive search over a CSR train split streams its nonzeros on
    the cohort plane (the holdout staged as one slab): the same
    candidates, calls and scores as the device-resident plane over the
    same CSR blocks, and as the streamed plane over the dense rows."""
    from dask_ml_tpu_torch.models.sgd import SGDClassifier

    params = {"alpha": [1e-4, 1e-3, 1e-2], "eta0": [0.01, 0.1]}

    def run(X, **cfg):
        with config.set(**cfg):
            return IncrementalSearchCV(
                SGDClassifier(), params, n_initial_parameters=4,
                max_iter=6, random_state=0).fit(X, Y2, classes=[0.0, 1.0])

    s = run(A)
    assert s.metadata_["stream"]["sparse"]
    assert s.metadata_["stream"]["fused_reason"] == "sparse-stream"
    r = run(A, search_stream=False)
    d = run(D)
    for other in (r, d):
        assert s.best_params_ == other.best_params_
        np.testing.assert_allclose(s.cv_results_["test_score"],
                                   other.cv_results_["test_score"],
                                   atol=1e-6)


def test_parallel_post_fit_host_estimator_on_sparse():
    """A host estimator sees CSR (a SparseBlocks view made one CSR); its
    sparse output stays sparse."""
    from sklearn.linear_model import LogisticRegression as SkLR
    from sklearn.preprocessing import MaxAbsScaler

    ppf = TW.ParallelPostFit(SkLR(max_iter=200)).fit(_blocks(A), Y2)
    np.testing.assert_array_equal(ppf.predict(_blocks(A)),
                                  SkLR(max_iter=200).fit(A, Y2).predict(A))
    out = TW.ParallelPostFit(MaxAbsScaler()).fit(A).transform(_blocks(A))
    assert sp.issparse(out)
    np.testing.assert_allclose(out.toarray(),
                               MaxAbsScaler().fit(A).transform(A).toarray())
    port = TW.ParallelPostFit(T.LogisticRegression(solver="lbfgs"))
    with config.set(stream_block_rows=BLOCK):
        port.fit(A, Y2)
        assert port.estimator_.solver_info_["sparse_stream"]


def test_remaining_sparse_entry_points():
    """The other entry points that refused a sparse X: a sparse
    partial_fit block (densified on placement, as in dask_ml_tpu),
    Incremental.partial_fit, the C grid over a SparseBlocks view, and an
    adaptive search of a scikit-learn estimator, whose host blocks stay
    CSR."""
    from sklearn.linear_model import SGDClassifier as SkSGD

    from dask_ml_tpu_torch.models.sgd import SGDClassifier

    a = SGDClassifier(random_state=0).partial_fit(A[:200], Y2[:200],
                                                  classes=[0.0, 1.0])
    b = SGDClassifier(random_state=0).partial_fit(D[:200], Y2[:200],
                                                  classes=[0.0, 1.0])
    np.testing.assert_array_equal(a.coef_, b.coef_)
    s = TW.Incremental(SGDClassifier(), random_state=0).partial_fit(
        _blocks(A), Y2, classes=[0.0, 1.0])
    d = TW.Incremental(SGDClassifier(), random_state=0).partial_fit(
        D, Y2, classes=[0.0, 1.0])
    np.testing.assert_allclose(s.estimator_.coef_, d.estimator_.coef_,
                               atol=1e-6)
    est = T.LogisticRegression(solver="lbfgs", max_iter=50)
    for f, g in zip(est._fit_C_grid(_blocks(A), Y2, [0.5]),
                    est._fit_C_grid(A, Y2, [0.5])):
        np.testing.assert_array_equal(f.coef_, g.coef_)
    search = IncrementalSearchCV(SkSGD(tol=None), {"alpha": [1e-4, 1e-2]},
                                 n_initial_parameters=2, max_iter=2,
                                 random_state=0).fit(A, Y2, classes=[0, 1])
    assert search.best_params_["alpha"] in (1e-4, 1e-2)
