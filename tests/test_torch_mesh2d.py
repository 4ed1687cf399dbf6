"""The 2-D ("data" x "model") mesh of the port's process plane, on the CPU.

The port's mesh is the process world (``dask_ml_tpu_torch/parallel/
mesh.py``): under ``config.mesh_shape="DxM"`` rank r sits at data index
r // M and model index r % M. These tests run it on virtual worlds of 2
ranks ("1x2") and 4 ranks ("2x2"): the mesh string rules against the JAX
package's (``tests/test_mesh2d.py:34-61``), the group collectives (bit-
equal on every member, in group order), ``ShardedArray``'s column tiles,
``BlockStream``'s tiles and ``model_tile_reason`` against JAX's strings,
the per-process byte budget's typed refusal and its lift by a model
axis, the ``stream_put_sharded`` fault site, and a frame's
``to_sharded(shard_features=True)``. ``_PUT_ALIASES``: dask_ml_tpu's host
streams stage fresh buffers (ROADMAP.md queue 3).
"""

import functools
import pickle
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu.parallel.mesh import parse_mesh_shape as jparse
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.parallel import distributed as dist
from dask_ml_tpu_torch.parallel import mesh as tmesh
from dask_ml_tpu_torch.parallel.sharded import ShardedArray
from dask_ml_tpu_torch.parallel.streaming import (BlockStream,
                                                  StreamBudgetExceeded)


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _world(fn, shape, world):
    def body(rank):
        with config.set(mesh_shape=shape):
            return fn(rank)

    return dist.run_virtual_processes(body, world, timeout=120)


# -- the mesh strings, against JAX's -----------------------------------------

@pytest.mark.parametrize("s,n", [
    ("auto", 8), ("", 8), ("1d", 8), (None, 8), ("AUTO", 8),
    ("8", 8), ("4", 8), ("2x4", 8), ("1x4", 8), ("2x2", 8),
    ("-1x2", 8), ("4x-1", 8), ("-1x2", 6),
    ("5x3", 8), ("0x2", 8), ("-1x-1", 8), ("-1x3", 8), ("axb", 8),
    ("2x3x4", 8)])
def test_parse_mesh_shape_cases_match_jax(s, n):
    try:
        want = jparse(s, n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_shape(s, n)
        assert str(got.value) == str(exc)
        return
    assert tmesh.parse_mesh_shape(s, n) == want


def test_check_stream_mesh_refuses_only_several_devices():
    with config.set(stream_mesh=2):
        with pytest.raises(NotImplementedError,
                           match=r"queue 1, Multi-GPU \(several devices in "
                                 r"one process\)"):
            tmesh.check_stream_mesh()
    for shape in ("auto", "1", "1x1", "-1x1"):
        with config.set(mesh_shape=shape):
            tmesh.check_stream_mesh()
            assert tmesh.mesh_str() == "1x1"

    def body(rank):
        tmesh.check_stream_mesh()
        return (tmesh.data_shards(), tmesh.model_shards(),
                tmesh.data_index(), tmesh.model_index(), tmesh.mesh_str())

    assert _world(body, "2x2", 4) == [(2, 2, r // 2, r % 2, "2x2")
                                      for r in range(4)]
    assert _world(body, "-1x2", 4)[3] == (2, 2, 1, 1, "2x2")
    assert _world(body, "1x4", 4)[2] == (1, 4, 0, 2, "1x4")

    def short(rank):
        with pytest.raises(ValueError, match="D \\* M must equal"):
            tmesh.check_stream_mesh()

    _world(short, "1x2", 4)


# -- the group collectives ---------------------------------------------------

def test_group_collectives_are_bit_equal_in_group_order():
    def body(rank):
        v = np.random.RandomState(rank).randn(64)
        data = dist.psum_host(v, group="data")
        model = dist.psum_host(v, group="model")
        world = dist.psum_host(v)
        objs = (dist.allgather_object(rank, "data"),
                dist.allgather_object(rank, "model"))
        return data, model, world, objs

    # plane_stats is the process's: the virtual ranks' calls add up
    dist.reset_plane_stats()
    out = _world(body, "2x2", 4)
    stats = dict(dist.plane_stats)
    vs = [np.random.RandomState(r).randn(64) for r in range(4)]
    for r, (data, model, world, objs) in enumerate(out):
        j, i = r % 2, r // 2
        # the sum in group order, float64, the same bits on every member
        np.testing.assert_array_equal(data, vs[j] + vs[j + 2])
        np.testing.assert_array_equal(model, vs[2 * i] + vs[2 * i + 1])
        np.testing.assert_array_equal(world, out[0][2])
        assert objs == ([j, j + 2], [2 * i, 2 * i + 1])
    assert stats["data_calls"] == stats["model_calls"] == 4 * 2
    assert stats["psum_calls"] == 4 * 3
    assert stats["data_bytes"] == stats["model_bytes"] == 4 * 512 + sum(
        len(pickle.dumps(r)) for r in range(4))
    assert stats["psum_bytes"] == 4 * 3 * 512
    # a group of one is the identity, and the world's groups are its own
    one = _world(lambda r: dist.psum_host(np.ones(2), group="data"), "1x2", 2)
    np.testing.assert_array_equal(one[0], np.ones(2))


def test_group_peer_failure_fails_the_group():
    def body(rank):
        if rank == 3:
            raise KeyError("gone")
        dist.psum_host(np.ones(2), group="model")

    with pytest.raises(KeyError):
        _world(body, "2x2", 4)


# -- the column tiles of a ShardedArray --------------------------------------

def test_from_array_keeps_the_column_tile():
    X = np.arange(60, dtype=np.float32).reshape(10, 6)

    def body(rank):
        part = X[:7] if rank < 2 else X[7:]
        Xs = ShardedArray.from_array(part, shard_features=True)
        state = pickle.loads(pickle.dumps(Xs))
        return (Xs.shape, Xs.model_sharded, Xs.col_offset, Xs.global_rows,
                Xs.row_offset, Xs.process_local, Xs.data.numpy(),
                Xs.to_numpy(), state.model_sharded, state.col_offset,
                state.n_features)

    out = _world(body, "2x2", 4)
    for r, o in enumerate(out):
        rows = X[:7] if r < 2 else X[7:]
        lo = 3 * (r % 2)
        assert o[:6] == ((len(rows), 6), True, lo, 10, 0 if r < 2 else 7,
                         True)
        # the tile with no collective; the row group's width gathered
        np.testing.assert_array_equal(o[6], rows[:, lo:lo + 3])
        np.testing.assert_array_equal(o[7], rows)
        assert o[8:] == (True, lo, 6)
    # an indivisible width stays whole (model-replicated)
    odd = _world(lambda r: ShardedArray.from_array(
        X[:, :5], shard_features=True).data.shape, "1x2", 2)
    assert odd == [(10, 5), (10, 5)]

    def uneven(rank):
        ShardedArray.from_array(X[:5 + rank], shard_features=True)

    with pytest.raises(ValueError, match="same rows"):
        _world(uneven, "1x2", 2)


def test_frame_to_sharded_feature_tiles():
    pd = pytest.importorskip("pandas")
    from dask_ml_tpu_torch.parallel import from_pandas

    df = pd.DataFrame(np.arange(48, dtype=np.float64).reshape(12, 4),
                      columns=list("abcd"))

    def body(rank):
        Xs = from_pandas(df, 3).to_sharded(shard_features=True)
        return Xs.model_sharded, Xs.col_offset, Xs.data.numpy()

    for r, (tiled, lo, tile) in enumerate(_world(body, "1x2", 2)):
        assert tiled and lo == 2 * r
        np.testing.assert_array_equal(tile, df.to_numpy(np.float32)[
            :, 2 * r:2 * r + 2])


# -- BlockStream's tiles -----------------------------------------------------

def _jax_reason(X, shape):
    with jconfig.set(stream_mesh=0, mesh_shape=shape):
        return jstreaming.BlockStream((X,), block_rows=16).model_tile_reason


@pytest.mark.parametrize("case", ["sparse", "not-2d", "indivisible"])
def test_model_tile_reason_matches_jax(case):
    X = {"sparse": sp.random(64, 8, density=0.2, format="csr",
                             dtype=np.float32, random_state=0),
         "not-2d": np.zeros((64, 2, 4), np.float32),
         "indivisible": np.zeros((64, 5), np.float32)}[case]
    want = _jax_reason(X, "1x2")

    def body(rank):
        s = BlockStream((X,), block_rows=16, feature_tiles=True)
        return s.model_tile_reason, s.sb_model_shards(), s.model_tiled

    assert _world(body, "1x2", 2) == [(want, 1, False)] * 2
    assert want in ("sparse-source", "x-not-2d", "d-not-divisible(5%2)")


def test_block_stream_stages_the_tile():
    X = np.arange(200, dtype=np.float32).reshape(25, 8)

    def body(rank):
        s = BlockStream((X,), block_rows=10, feature_tiles=True)
        blocks = [b.arrays[0][:b.n_rows].numpy().copy() for b in s]
        plain = BlockStream((X,), block_rows=10)
        return (s.tile, s.sb_data_shards(), s.sb_model_shards(),
                s.sb_sharded(), np.concatenate(blocks),
                plain.model_tile_reason, plain.sb_model_shards())

    for r, o in enumerate(_world(body, "1x2", 2)):
        assert o[:4] == ((4 * r, 4 * r + 4), 1, 2, True)
        np.testing.assert_array_equal(o[4], X[:, 4 * r:4 * r + 4])
        assert o[5:] == ("consumer-data-only", 1)


# -- the byte budget ---------------------------------------------------------

def test_budget_refuses_1d_and_the_model_axis_lifts_it():
    rng = np.random.RandomState(7)
    n, d = 2048, 64
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    # the ring: 2 slots x 512 rows x (64 + 1) x 4 = 266,240 bytes on a 1-D
    # mesh, 2 x 512 x (32 + 1) x 4 = 135,168 with X tiled over two
    budget = 200_000
    with config.set(stream_block_rows=512, stream_device_byte_budget=budget):
        with pytest.raises(StreamBudgetExceeded, match="mesh_shape") as ei:
            LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
        assert isinstance(ei.value, ValueError)
        got = _world(lambda r: LogisticRegression(
            solver="lbfgs", max_iter=3).fit(X, y), "1x2", 2)
    with config.set(stream_block_rows=512):
        ref = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
        ring = _world(lambda r: BlockStream(
            (X, y), block_rows=512, feature_tiles=True).ring_bytes(),
            "1x2", 2)
    assert ring == [135_168, 135_168]
    assert BlockStream((X, y), block_rows=512).ring_bytes() == 266_240
    for est in got:
        assert est.solver_info_["model_shards"] == 2
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=5e-4)


# -- the stream_put_sharded fault site ---------------------------------------

def test_stream_put_sharded_fires_per_tiled_block():
    from dask_ml_tpu_torch.observability import counters_snapshot
    from dask_ml_tpu_torch.reliability import reset_plans
    from dask_ml_tpu_torch.reliability.faults import InjectedCrash

    X = np.random.RandomState(1).randn(600, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    reset_plans()
    with config.set(stream_block_rows=200,
                    fault_plan="stream_put_sharded:crash@2"):
        # the rank that draws index 2 crashes, its peer fails with it
        # (either may surface first)
        with pytest.raises((InjectedCrash, RuntimeError),
                           match="injected crash at site "
                                 "'stream_put_sharded'"):
            _world(lambda r: LogisticRegression(
                solver="lbfgs", max_iter=2).fit(X, y), "1x2", 2)
    reset_plans()
    before = counters_snapshot().get("faults_injected_stream_put_sharded", 0)
    with config.set(stream_block_rows=200,
                    fault_plan="stream_put_sharded:io@0"):
        got = _world(lambda r: LogisticRegression(
            solver="lbfgs", max_iter=2).fit(X, y), "1x2", 2)
        # a data-only stream never fires it
        one = LogisticRegression(solver="lbfgs", max_iter=2).fit(X, y)
    after = counters_snapshot().get("faults_injected_stream_put_sharded", 0)
    reset_plans()
    assert after - before == 1
    np.testing.assert_array_equal(got[0].coef_, got[1].coef_)
    np.testing.assert_allclose(got[0].coef_, one.coef_, atol=5e-4)


# -- the model-replicated consumers: searches and grad-accum SGD -------------
# A search's trials, refit, brackets and owned candidates run inside
# ``distributed.local_section``, where the mesh is 1 x 1 whatever
# ``mesh_shape`` names: every rank passes the whole X, and a trial's
# stream (X taller than a block) stages data-only on its own device. The
# grad-accum SGD has no feature-sharded flavour: each rank of a row group
# streams its rows at full width and the group sums merge over "data".
# Each is held to the port's single-process run and to the JAX package:
# under mesh_shape="2x4" (its searches and grad-accum SGD on 8 devices),
# Hyperband's brackets on one device (below).

MESHES = [("1x2", 2), ("2x2", 4)]
SEARCH_BLOCK = 64


def _jax(fn, **cfg):
    with jconfig.set(stream_mesh=0, **cfg):
        return fn()


def _search_data():
    from sklearn.datasets import make_classification

    X, y = make_classification(n_samples=400, n_features=8,
                               n_informative=4, random_state=0)
    return X.astype(np.float32), y.astype(np.float32)


def _grid(cls, lr):
    return cls(lr(solver="lbfgs", max_iter=25), {"C": [0.1, 10.0]}, cv=2)


@functools.lru_cache(maxsize=None)
def _grid_refs():
    from dask_ml_tpu.linear_model import LogisticRegression as JLR
    from dask_ml_tpu.model_selection import GridSearchCV as JGrid

    from dask_ml_tpu_torch.model_selection import GridSearchCV

    X, y = _search_data()
    with config.set(stream_block_rows=SEARCH_BLOCK):
        solo = _grid(GridSearchCV, LogisticRegression).fit(X, y)
    ref = _jax(lambda: _grid(JGrid, JLR).fit(X, y), mesh_shape="2x4",
               stream_block_rows=SEARCH_BLOCK)
    return solo, ref


@pytest.mark.parametrize("shape,world", MESHES)
def test_grid_search_streams_trials_and_refit_under_the_mesh(shape, world):
    from dask_ml_tpu_torch.model_selection import GridSearchCV

    X, y = _search_data()
    solo, ref = _grid_refs()
    assert solo.best_estimator_.solver_info_["streamed"]

    def body(rank):
        with config.set(stream_block_rows=SEARCH_BLOCK):
            s = _grid(GridSearchCV, LogisticRegression).fit(X, y)
        assert s._dist_stats[2:] == (rank, world)
        assert s.best_estimator_.solver_info_["streamed"]
        return s

    for s in _world(body, shape, world):
        scores = np.asarray(s.cv_results_["mean_test_score"])
        np.testing.assert_array_equal(scores,
                                      solo.cv_results_["mean_test_score"])
        np.testing.assert_array_equal(s.best_estimator_.coef_,
                                      solo.best_estimator_.coef_)
        np.testing.assert_allclose(scores, ref.cv_results_["mean_test_score"],
                                   atol=1e-4)
        np.testing.assert_allclose(s.best_estimator_.coef_,
                                   ref.best_estimator_.coef_, atol=5e-4)


def _hyperband(cls, sgd):
    rng = np.random.RandomState(0)
    X = rng.randn(600, 6).astype(np.float32)
    y = (X @ rng.randn(6) > 0).astype(np.float32)
    s = cls(sgd(tol=1e-3, random_state=0),
            {"alpha": [1e-5, 1e-4, 1e-3, 1e-2], "eta0": [0.05, 0.5]},
            max_iter=9, aggressiveness=3, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return s.fit(X, y, classes=[0.0, 1.0])


@functools.lru_cache(maxsize=None)
def _hyperband_refs():
    from dask_ml_tpu.model_selection import HyperbandSearchCV as JHB
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.model_selection import HyperbandSearchCV

    with config.set(stream_block_rows=SEARCH_BLOCK):
        solo = _hyperband(HyperbandSearchCV, SGDClassifier)
    # JAX under "2x4" runs a bracket data-sharded over its 8 devices, and
    # its SGD blocks follow the devices; the port's bracket runs on one
    # device, so its oracle is JAX's bracket on one device
    with jconfig.set(stream_mesh=1, stream_block_rows=SEARCH_BLOCK), \
            use_mesh(device_mesh(devices=jax.devices()[:1])):
        ref = _hyperband(JHB, JSGD)
    return solo, ref


@pytest.mark.parametrize("shape,world", MESHES)
def test_hyperband_brackets_under_the_mesh(shape, world):
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.model_selection import HyperbandSearchCV

    solo, ref = _hyperband_refs()

    def body(rank):
        with config.set(stream_block_rows=SEARCH_BLOCK):
            s = _hyperband(HyperbandSearchCV, SGDClassifier)
        assert s._dist_stats == (rank, world)
        return s

    for s in _world(body, shape, world):
        np.testing.assert_array_equal(s.cv_results_["test_score"],
                                      solo.cv_results_["test_score"])
        assert s.cv_results_["params"] == solo.cv_results_["params"]
        assert s.metadata_["partial_fit_calls"] == \
            solo.metadata_["partial_fit_calls"]
        # the JAX test's own tolerance (tests/test_torch_multiprocess_fits)
        np.testing.assert_allclose(s.cv_results_["test_score"],
                                   ref.cv_results_["test_score"],
                                   atol=2.0 / 90)


def _sgd_data(seed=11, n=4000, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    return X, (X @ rng.randn(d) > 0).astype(np.float32)


@pytest.mark.parametrize("shape,world", MESHES)
def test_grad_accum_sgd_under_the_mesh(shape, world):
    """A row group's ranks stream the same rows model-replicated; the
    merge over "data" counts each row group once. The twin is one process
    at A x D over the row groups' blocks in group order (as the two-rank
    test of tests/test_torch_multiprocess_fits.py builds it)."""
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    from dask_ml_tpu_torch.linear_model import SGDClassifier

    X, y = _sgd_data()
    block, A = 250, 2
    D = int(shape.split("x")[0])
    half = X.shape[0] // D
    groups = [(X[g * half:(g + 1) * half], y[g * half:(g + 1) * half])
              for g in range(D)]
    xs, ys = [], []
    for lo in range(0, half, block * A):
        for Xg, yg in groups:
            xs.append(Xg[lo:lo + block * A])
            ys.append(yg[lo:lo + block * A])
    Xc, yc = np.concatenate(xs), np.concatenate(ys)

    def make(cls):
        return cls(random_state=0, max_iter=2, shuffle=False)

    with config.set(stream_grad_accum=D * A, stream_block_rows=block):
        twin = make(SGDClassifier).fit(Xc, yc)
    ref = _jax(lambda: make(JSGD).fit(Xc, yc), mesh_shape="2x4",
               stream_grad_accum=D * A, stream_block_rows=block)

    def body(rank):
        with config.set(stream_grad_accum=A, stream_block_rows=block):
            return make(SGDClassifier).fit(*groups[rank // (world // D)])

    for est in _world(body, shape, world):
        np.testing.assert_allclose(est.coef_, twin.coef_, atol=1e-6)
        assert est._t == twin._t == ref._t
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=5e-4)
