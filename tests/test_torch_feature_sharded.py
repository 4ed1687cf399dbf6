"""The port's feature-sharded paths on the CPU, over virtual worlds of 2
ranks (``mesh_shape="1x2"``, one row group of two column tiles) and 4
ranks (``"2x2"``, two row groups), against the port's single-process
twins and the JAX package's 2-D ("data", "model") fits.

- Pass level, at a fixed beta: the streamed objective's ``val``, ``vg``
  and ``vgh`` sums, binary and one-vs-rest, against the port's
  single-process pass (1e-6) and JAX's ``"2x4"`` pass (1e-5), as
  ``tests/test_mesh2d.py::test_pass_level_parity`` holds JAX's; an
  indivisible width runs model-replicated and counts each row group
  once.
- Fit level: the streamed lbfgs (``coef_`` 5e-4, as JAX's own
  ``test_fit_level_parity``), streamed randomized PCA and TruncatedSVD
  (JAX's Omega injected; singular values rel 1e-5, components 1e-4),
  and ``tests/test_tensor_parallel.py``'s resident fits over
  ``shard_features=True`` arrays (lbfgs, Newton, KMeans, full PCA) held
  to JAX's fits on its (4, 2) mesh at JAX's tolerances (rtol 1e-3, atol
  1e-4) and to the port's single-process fit (``coef_`` 5e-4).
``_PUT_ALIASES``: dask_ml_tpu's host streams stage fresh buffers
(ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.models.solvers.streamed import (
    MulticlassStreamedObjective, StreamedObjective)
from dask_ml_tpu_torch.ops import linalg
from dask_ml_tpu_torch.parallel import distributed as dist
from dask_ml_tpu_torch.parallel.sharded import ShardedArray
from dask_ml_tpu_torch.parallel.streaming import BlockStream

SHAPES = [("1x2", 2), ("2x2", 4)]
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


def _rows(a, rank, shape, world):
    """The rows of ``rank``'s row group: all of them with one row group,
    a half each with two."""
    D = int(shape.split("x")[0])
    if D == 1:
        return a
    cut = a.shape[0] // 2 + 150           # uneven row groups
    return a[:cut] if rank // (world // D) == 0 else a[cut:]


def _world(fn, shape, world):
    def body(rank):
        with config.set(mesh_shape=shape):
            return fn(rank)

    return dist.run_virtual_processes(body, world, timeout=120)


# -- the streamed passes at a fixed beta -------------------------------------

def _xy(n=2300, d=8, classes=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    eta = X @ rng.randn(d)
    if classes == 2:
        return X, (eta > 0).astype(np.float32)
    return X, np.digitize(eta, np.quantile(eta, [1 / 3, 2 / 3])
                          ).astype(np.float32)


def _port_obj(X, y, n, C, reduce=None, tiles=True):
    d = X.shape[1]
    stream = BlockStream((X, y), block_rows=512, feature_tiles=tiles)
    if C:
        return MulticlassStreamedObjective(
            stream, n, 0.1, np.ones(C * (d + 1)), 0.5, "logistic", "l2",
            True, use_kernel=True, reduce=reduce, n_classes=C)
    return StreamedObjective(stream, n, 0.1, np.ones(d + 1), 0.5,
                             "logistic", "l2", True, use_kernel=True,
                             reduce=reduce)


def _passes(obj, beta):
    return (*obj.value_and_grad(beta), obj.value(beta),
            *obj.value_and_grad_and_hess(beta))


def _jax_passes(X, y, n, C, beta):
    from dask_ml_tpu.models.solvers.streamed import (
        MulticlassStreamedObjective as JMulti, StreamedObjective as JObj)

    d = X.shape[1]
    with jconfig.set(stream_block_rows=1024, stream_mesh=0,
                     mesh_shape="2x4"):
        s = jstreaming.BlockStream((X, y), block_rows=1024)
        assert s.sb_model_shards() == 4
        if C:
            o = JMulti(s, n, jnp.asarray(0.1, jnp.float32),
                       jnp.ones(C * (d + 1)), 0.5, "logistic", "l2", True,
                       n_classes=C)
        else:
            o = JObj(s, n, jnp.asarray(0.1, jnp.float32), jnp.ones(d + 1),
                     0.5, "logistic", "l2", True)
        return (*o.value_and_grad(beta), o.value(beta),
                *o.value_and_grad_and_hess(beta))


@pytest.mark.parametrize("shape,world", SHAPES)
@pytest.mark.parametrize("C", [None, 3], ids=["binary", "ovr"])
def test_pass_level_parity(shape, world, C):
    X, y = _xy(classes=C or 2)
    n, d = X.shape
    beta = np.random.RandomState(3).randn((C or 1) * (d + 1)) * 0.3
    base = _passes(_port_obj(X, y, n, C), beta)
    ref = _jax_passes(X, y, n, C, beta)

    def body(rank):
        obj = _port_obj(_rows(X, rank, shape, world),
                        _rows(y, rank, shape, world), n, C,
                        reduce=dist.host_reduce("data"))
        assert obj.stream.model_tiled and obj._flavor("vg")[2] == \
            "feature-sharded"
        return _passes(obj, beta)

    got = _world(body, shape, world)
    for g in got[1:]:
        for a, b in zip(got[0], g):
            np.testing.assert_array_equal(a, b)   # bit-equal on every rank
    for a, b, r in zip(got[0], base, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_indivisible_width_counts_each_row_group_once():
    X, y = _xy(d=5)
    n = X.shape[0]
    beta = np.random.RandomState(4).randn(6) * 0.3
    base = _passes(_port_obj(X, y, n, None), beta)

    def body(rank):
        obj = _port_obj(_rows(X, rank, "2x2", 4), _rows(y, rank, "2x2", 4),
                        n, None, reduce=dist.host_reduce("data"))
        assert obj.stream.model_tile_reason == "d-not-divisible(5%2)"
        return _passes(obj, beta)

    for got in _world(body, "2x2", 4):
        for a, b in zip(got, base):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
    # the fit: the world's row count is the row groups', not the ranks'
    with config.set(stream_block_rows=512):
        one = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
        fits = _world(lambda r: LogisticRegression(
            solver="lbfgs", max_iter=20).fit(_rows(X, r, "2x2", 4),
                                             _rows(y, r, "2x2", 4)),
            "2x2", 4)
    for est in fits:
        assert est.solver_info_["model_shards"] == 1
        np.testing.assert_allclose(est.coef_, one.coef_, atol=COEF)


# -- streamed fits -----------------------------------------------------------

@pytest.mark.parametrize("shape,world", SHAPES)
def test_streamed_lbfgs_fit_parity(shape, world):
    from dask_ml_tpu.linear_model import LogisticRegression as JLR

    X, y = _xy(4096, 8, seed=1)
    with jconfig.set(stream_block_rows=1024, stream_mesh=0,
                     mesh_shape="2x4"):
        ref = JLR(solver="lbfgs", max_iter=15).fit(X.astype(np.float64),
                                                   y.astype(np.float64))
    with config.set(stream_block_rows=1024):
        one = LogisticRegression(solver="lbfgs", max_iter=15).fit(X, y)
        got = _world(lambda r: LogisticRegression(
            solver="lbfgs", max_iter=15).fit(_rows(X, r, shape, world),
                                             _rows(y, r, shape, world)),
            shape, world)
    for est in got:
        assert est.solver_info_["fused_stream_reason"] == "feature-sharded"
        np.testing.assert_array_equal(est.coef_, got[0].coef_)
        np.testing.assert_allclose(est.coef_, one.coef_, atol=COEF,
                                   rtol=COEF)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF,
                                   rtol=COEF)


def test_streamed_newton_and_ovr_fits():
    X, y = _xy(3000, 8, classes=3, seed=2)
    yb = (y > 0).astype(np.float32)
    with config.set(stream_block_rows=700):
        one_n = LogisticRegression(solver="newton", max_iter=5).fit(X, yb)
        one_o = LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)

        def body(rank):
            return (LogisticRegression(solver="newton", max_iter=5).fit(
                _rows(X, rank, "2x2", 4), _rows(yb, rank, "2x2", 4)),
                LogisticRegression(solver="lbfgs", max_iter=30).fit(
                _rows(X, rank, "2x2", 4), _rows(y, rank, "2x2", 4)))

        got = _world(body, "2x2", 4)
    for newton, ovr in got:
        np.testing.assert_allclose(newton.coef_, one_n.coef_, atol=COEF)
        assert newton.n_iter_ == one_n.n_iter_
        np.testing.assert_allclose(ovr.coef_, one_o.coef_, atol=COEF)


def _spectrum(n=2048, d=32, seed=0):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(n, d)))[0]
    v = np.linalg.qr(rng.normal(size=(d, d)))[0]
    X = (u * (100.0 * 0.7 ** np.arange(d))) @ v.T \
        + 0.01 * rng.normal(size=(n, d))
    return (X + 1.5).astype(np.float32)


def _decomp_close(est, ref, s_rtol=1e-5, comp_atol=1e-4):
    np.testing.assert_allclose(est.singular_values_, ref.singular_values_,
                               rtol=s_rtol)
    np.testing.assert_allclose(np.abs(est.components_),
                               np.abs(np.asarray(ref.components_)),
                               atol=comp_atol)


@pytest.mark.parametrize("shape,world", SHAPES)
def test_streamed_pca_and_truncated_svd_parity(shape, world, jax_omega):
    from dask_ml_tpu.decomposition import PCA as JPCA
    from dask_ml_tpu.decomposition import TruncatedSVD as JTSVD

    X = _spectrum()
    with jconfig.set(stream_block_rows=512, stream_mesh=0,
                     mesh_shape="2x4"):
        jp = JPCA(n_components=6, svd_solver="randomized",
                  random_state=0).fit(X)
        jt = JTSVD(n_components=6, algorithm="randomized",
                   random_state=0).fit(X)
    with config.set(stream_block_rows=512):
        one_p = PCA(6, svd_solver="randomized", random_state=0).fit(X)
        one_t = TruncatedSVD(6, algorithm="randomized",
                             random_state=0).fit(X)

        def body(rank):
            Xr = _rows(X, rank, shape, world)
            return (PCA(6, svd_solver="randomized", random_state=0).fit(Xr),
                    TruncatedSVD(6, algorithm="randomized",
                                 random_state=0).fit(Xr))

        got = _world(body, shape, world)
    for p, t in got:
        _decomp_close(p, one_p)
        _decomp_close(p, jp)
        np.testing.assert_allclose(p.mean_, one_p.mean_, atol=1e-5)
        _decomp_close(t, one_t)
        _decomp_close(t, jt)


# -- resident fits over feature-sharded arrays (tests/test_tensor_parallel.py)

@pytest.fixture(scope="module")
def jmesh2d():
    from dask_ml_tpu.parallel.mesh import device_mesh

    return device_mesh((4, 2), ("data", "model"))


def _clf_data():
    rng = np.random.RandomState(0)
    X = rng.randn(400, 16).astype(np.float32)
    beta = rng.randn(16) / 4
    y = (X @ beta + 0.1 * rng.randn(400) > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("shape,world", SHAPES)
@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_resident_glm_parity(shape, world, solver, jmesh2d):
    from dask_ml_tpu.linear_model import LogisticRegression as JLR
    from dask_ml_tpu.parallel.mesh import use_mesh
    from dask_ml_tpu.parallel.sharded import ShardedArray as JSA

    X, y = _clf_data()
    with use_mesh(jmesh2d):
        ref = JLR(solver=solver, max_iter=100).fit(
            JSA.from_array(X, mesh=jmesh2d, shard_features=True),
            JSA.from_array(y, mesh=jmesh2d))
    one = LogisticRegression(solver=solver, max_iter=100).fit(X, y)

    def body(rank):
        Xs = ShardedArray.from_array(_rows(X, rank, shape, world),
                                     shard_features=True)
        yr = _rows(y, rank, shape, world)
        est = LogisticRegression(solver=solver, max_iter=100).fit(Xs, yr)
        return est, est.score(Xs, yr)

    got = _world(body, shape, world)
    for est, _ in got:
        assert est.solver_info_["kernel_reason"] == "feature-sharded"
        np.testing.assert_array_equal(est.coef_, got[0][0].coef_)
        np.testing.assert_allclose(est.coef_, ref.coef_, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(est.intercept_, ref.intercept_,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(est.coef_, one.coef_, atol=COEF)
        assert est.n_iter_ == one.n_iter_
    if world == 2:
        # one row group: each rank scores every row
        assert got[0][1] == pytest.approx(one.score(X, y), abs=1e-6)


def test_resident_admm_refuses_and_ovr_fits():
    X, y = _clf_data()
    y3 = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    one = LogisticRegression(solver="lbfgs", max_iter=50).fit(X, y3)

    def body(rank):
        Xs = ShardedArray.from_array(X, shard_features=True)
        with pytest.raises(NotImplementedError, match="part 3"):
            LogisticRegression(solver="admm").fit(Xs, y)
        return LogisticRegression(solver="lbfgs", max_iter=50).fit(Xs, y3)

    for est in _world(body, "1x2", 2):
        np.testing.assert_allclose(est.coef_, one.coef_, atol=COEF)
        assert est.n_iter_ == one.n_iter_


@pytest.mark.parametrize("shape,world", SHAPES)
def test_resident_kmeans_parity(shape, world, jmesh2d):
    from dask_ml_tpu.cluster import KMeans as JKM
    from dask_ml_tpu.parallel.mesh import use_mesh
    from dask_ml_tpu.parallel.sharded import ShardedArray as JSA

    rng = np.random.RandomState(3)
    centers = rng.randn(3, 8).astype(np.float32) * 4
    X = np.concatenate([centers[i] + 0.3 * rng.randn(150, 8).astype(
        np.float32) for i in range(3)])
    X = X[rng.permutation(len(X))]
    init = centers + 0.5
    with use_mesh(jmesh2d):
        ref = JKM(n_clusters=3, init=init, max_iter=40, use_pallas=False
                  ).fit(JSA.from_array(X, mesh=jmesh2d, shard_features=True))
    one = KMeans(3, init=init, max_iter=40).fit(X)

    def body(rank):
        return KMeans(3, init=init, max_iter=40).fit(ShardedArray.from_array(
            _rows(X, rank, shape, world), shard_features=True))

    for est in _world(body, shape, world):
        assert est.kernel_info_["kernel_reason"] == "feature-sharded"
        np.testing.assert_allclose(est.cluster_centers_,
                                   ref.cluster_centers_, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(est.inertia_, ref.inertia_, rtol=1e-4)
        np.testing.assert_allclose(est.cluster_centers_,
                                   one.cluster_centers_, atol=1e-3)
        assert est.n_iter_ == one.n_iter_


@pytest.mark.parametrize("shape,world", SHAPES)
def test_resident_full_pca_parity(shape, world, jmesh2d):
    from dask_ml_tpu.decomposition import PCA as JPCA
    from dask_ml_tpu.parallel.mesh import use_mesh
    from dask_ml_tpu.parallel.sharded import ShardedArray as JSA

    rng = np.random.RandomState(2)
    X = (rng.randn(300, 12) * np.linspace(4, 0.2, 12)).astype(np.float32)
    with use_mesh(jmesh2d):
        ref = JPCA(n_components=4, svd_solver="full").fit(
            JSA.from_array(X, mesh=jmesh2d, shard_features=True))
    one = PCA(n_components=4, svd_solver="full").fit(X)

    def body(rank):
        Xs = ShardedArray.from_array(_rows(X, rank, shape, world),
                                     shard_features=True)
        est = PCA(n_components=4, svd_solver="full").fit(Xs)
        return est, est.transform(Xs).to_numpy()

    for est, scores in _world(body, shape, world):
        np.testing.assert_allclose(est.explained_variance_,
                                   ref.explained_variance_, rtol=1e-4)
        np.testing.assert_allclose(est.components_, ref.components_,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(est.mean_, ref.mean_, atol=1e-5)
        np.testing.assert_allclose(est.components_, one.components_,
                                   atol=1e-4)
        assert scores.shape[1] == 4
