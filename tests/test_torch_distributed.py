"""The port's process plane (``dask_ml_tpu_torch/parallel/distributed.py``
and ``mesh.py``) on the CPU.

Virtual worlds of 2 and 3 ranks (threads of this process, as the JAX
package tests its distribution logic) hold the host collectives to
dask_ml_tpu's, byte for byte, on the same numpy inputs; a rank that dies
fails its peers fast; ``parse_mesh_shape`` accepts and refuses what
JAX's does, ``stream_mesh`` above 1 raises naming ROADMAP.md queue 1,
Multi-GPU (several devices in one process), and a "DxM" mesh lays out
the world. Three tests spawn two real processes
(``torch.multiprocessing``, a gloo group over a file store under
``tmp_path``), each joined under its own deadline and killed past it:
the collectives; a streamed lbfgs fit and a streamed KMeans fit held to
the single-process fits of the concatenated data (coef_ 5e-4; centers
1e-3, inertia 1e-4); a ``pass_barrier:hang`` plan on rank 1 ending rank
0 with ``StreamSyncTimeout``. A fourth spawns four real processes under
``mesh_shape="2x2"``: the "data" and "model" gloo groups and two
feature-sharded fits. This module imports no jax at its top, so the
spawned processes stay light.
"""

import hashlib
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.parallel import distributed as dist
from dask_ml_tpu_torch.parallel import mesh as tmesh

WAIT = 180.0        # each real 2-process test's deadline, join to kill


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _inputs(rank):
    rng = np.random.RandomState(100 + rank)
    return {
        "obj": {"rank": rank, "x": rng.randn(3).tolist(), "s": "r" * rank},
        "f64": rng.randn(5, 7),
        "f32": rng.randn(11).astype(np.float32),
        "i32": rng.randint(-1000, 1000, (4, 3)).astype(np.int32),
        "psum": (rng.randn(6) * 10.0 ** rng.randint(-8, 8, 6),
                 np.asarray(float(rank + 1)), rng.randn(2, 3)),
    }


def _collect(d, rank):
    x = _inputs(rank)
    out = {"objs": d.allgather_object(x["obj"])}
    for k in ("f64", "f32", "i32"):
        out[k] = d.allgather_host(x[k])
    out["psum"] = d.psum_host(*x["psum"])
    out["psum1"] = d.psum_host(x["f64"])
    out["bcast"] = d.broadcast_host(x["f64"] * (rank == 0), root=0)
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_bit_equal_to_jax(world):
    from dask_ml_tpu.parallel import distributed as jdist

    ref = jdist.run_virtual_processes(lambda r: _collect(jdist, r), world)
    got = dist.run_virtual_processes(lambda r: _collect(dist, r), world)
    for g, r in zip(got, ref):
        assert g["objs"] == r["objs"]
        for k in ("f64", "f32", "i32", "psum1", "bcast"):
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            assert g[k].tobytes() == r[k].tobytes(), k
        for a, b in zip(g["psum"], r["psum"]):
            assert a.tobytes() == b.tobytes()
    # every rank holds the identical sum
    assert len({g["psum1"].tobytes() for g in got}) == 1


def test_topology_queries_and_local_section():
    def body(rank):
        out = (dist.process_count(), dist.process_index(),
               dist.is_coordinator(), dist.in_virtual_world(),
               dist.barrier(), str(dist.rank_device()),
               config.get_config().device)
        with dist.local_section():
            inner = (dist.process_count(), dist.process_index(),
                     dist.allgather_object(rank), dist.in_virtual_world(),
                     dist.host_reduce())
        return out, inner

    for rank, (out, inner) in enumerate(
            dist.run_virtual_processes(body, 3)):
        assert out == (3, rank, rank == 0, True, 3.0, "cpu", "cpu")
        assert inner == (1, 0, [rank], True, None)
    assert (dist.process_count(), dist.process_index(),
            dist.in_virtual_world()) == (1, 0, False)
    assert dist.psum_host(np.ones(2)).tolist() == [1.0, 1.0]
    assert dist.host_reduce() is None


def test_allgather_host_shape_mismatch_raises_on_every_rank():
    seen = {}

    def body(rank):
        try:
            dist.allgather_host(np.zeros(3 + rank))
        except ValueError as exc:
            seen[rank] = str(exc)
            raise

    with pytest.raises(ValueError, match="identical shape/dtype"):
        dist.run_virtual_processes(body, 2)
    assert set(seen) == {0, 1}


def test_worker_death_fails_peers_fast():
    witnessed = {}

    def body(rank):
        if rank == 1:
            raise ValueError("injected death")
        try:
            dist.allgather_object("round-1")
        except RuntimeError as exc:
            witnessed["err"] = str(exc)
            raise
        raise AssertionError("the survivor's collective must fail fast")

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="injected death"):
        dist.run_virtual_processes(body, 2, timeout=60)
    assert time.perf_counter() - t0 < 10
    assert "virtual peer 1 failed" in witnessed["err"]


def test_hung_rank_is_named():
    def body(rank):
        if rank == 1:
            time.sleep(3)

    with pytest.raises(RuntimeError, match="virtual-rank-1"):
        dist.run_virtual_processes(body, 2, timeout=0.5)


def test_array_from_process_local():
    def body(rank):
        rows = [37, 23][rank]
        local = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2) \
            + 1000 * rank
        sa = dist.array_from_process_local(local)
        return (sa.n_rows, sa.global_rows, sa.row_offset, sa.process_local,
                sa.to_numpy(), str(sa.device))

    for rank, (n, g, off, flag, host, dev) in enumerate(
            dist.run_virtual_processes(body, 2)):
        assert (n, g, off, flag, dev) == ([37, 23][rank], 60,
                                          [0, 37][rank], True, "cpu")
        np.testing.assert_array_equal(host[0], [1000.0 * rank,
                                                1000.0 * rank + 1])

    def bad(rank):
        dist.array_from_process_local(np.zeros((4, 2 + rank)))

    with pytest.raises(ValueError, match="identical feature shape"):
        dist.run_virtual_processes(bad, 2)


@pytest.mark.parametrize("s,n", [
    ("auto", 8), ("", 8), ("1d", 8), ("4", 8), ("4x1", 8), ("4x2", 8),
    ("-1x2", 8), ("2x-1", 8), ("8x1", 4), ("3x-1", 8), ("-1x-1", 8),
    ("2x3x4", 8), ("axb", 8), ("0x2", 8), ("-1x3", 8)])
def test_parse_mesh_shape_matches_jax(s, n):
    from dask_ml_tpu.parallel.mesh import parse_mesh_shape as jparse

    try:
        want = jparse(s, n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tmesh.parse_mesh_shape(s, n)
        assert str(got.value) == str(exc)
        return
    assert tmesh.parse_mesh_shape(s, n) == want


def test_mesh_refusals_and_data_axis():
    X = np.random.RandomState(0).randn(600, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    # the mesh is the process world: one process holds no 2 x 2 mesh
    with config.set(stream_block_rows=100, mesh_shape="2x2"):
        with pytest.raises(ValueError, match="needs 4 devices"):
            LogisticRegression(solver="lbfgs").fit(X, y)
    with config.set(stream_block_rows=100, stream_mesh=2):
        with pytest.raises(NotImplementedError,
                           match=r"queue 1, Multi-GPU \(several devices"):
            LogisticRegression(solver="lbfgs").fit(X, y)
    for shape in ("auto", "1", "1x1"):
        with config.set(mesh_shape=shape, stream_mesh=1):
            assert tmesh.check_stream_mesh() is None
    with config.set(mesh_shape="2"):
        with pytest.raises(ValueError, match="needs 2 devices"):
            tmesh.check_stream_mesh()

    def body(rank):
        for shape in ("2", "2x1", "-1x1"):
            with config.set(mesh_shape=shape):
                tmesh.check_stream_mesh()
        with config.set(mesh_shape="1"):
            with pytest.raises(ValueError, match="process world"):
                tmesh.check_stream_mesh()
        with config.set(mesh_shape="1x2"):
            # the 2-D mesh over the world: one row group of two tiles
            tmesh.check_stream_mesh()
            layout = (tmesh.data_shards(), tmesh.model_shards(),
                      tmesh.data_index(), tmesh.model_index(),
                      tmesh.mesh_str())
        with config.set(mesh_shape="1x4"):
            with pytest.raises(ValueError, match="needs 4 devices"):
                tmesh.check_stream_mesh()
        return dist.process_count(), layout

    assert dist.run_virtual_processes(body, 2) == [
        (2, (1, 2, 0, 0, "1x2")), (2, (1, 2, 0, 1, "1x2"))]


def test_stream_checkpoint_refused_in_virtual_world(tmp_path):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.reliability.stream_ckpt import stream_checkpoint

    rng = np.random.RandomState(1)
    X = rng.randn(800, 4).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(800) > 0).astype(np.float32)
    path = str(tmp_path / "ck")

    def body(rank):
        with config.set(stream_checkpoint_path=path, stream_block_rows=100):
            with pytest.warns(RuntimeWarning, match="writes no checkpoint"):
                assert stream_checkpoint("glm", ("x",)) is None
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                part = slice(rank * 400, (rank + 1) * 400)
                return LogisticRegression(solver="lbfgs", max_iter=5).fit(
                    X[part], y[part]).coef_

    a, b = dist.run_virtual_processes(body, 2)
    np.testing.assert_array_equal(a, b)
    assert not os.path.exists(path)
    # one process writes its checkpoint
    with config.set(stream_checkpoint_path=path):
        assert stream_checkpoint("glm", ("x",)) is not None


def test_pass_barrier_and_deadline_helpers():
    assert dist.sync_stream_pass() is False
    assert dist.multihost_capability() == (False, "single-process")
    assert dist.run_virtual_processes(
        lambda r: (dist.sync_stream_pass(), dist.multihost_capability()[0]),
        2) == [(False, False)] * 2
    with pytest.raises(dist.StreamSyncTimeout, match="within 0.2s"):
        dist.run_with_deadline(lambda: time.sleep(5), 0.2, "probe")
    with pytest.raises(KeyError):
        dist.run_with_deadline(lambda: {}["k"], 5.0)
    dist.run_with_deadline(lambda: None, 5.0)


@pytest.mark.parametrize("timeout_s", [0.0, 5.0])
def test_broken_group_raises_in_the_pass_barrier(monkeypatch, timeout_s):
    """A process group whose barrier fails raises from every pass barrier,
    with and without a deadline: no later pass runs unsynced."""
    class Broken:
        calls = 0

        def barrier(self, group=None):
            Broken.calls += 1
            raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "_td", lambda: Broken())
    monkeypatch.setattr(dist, "_host_group", lambda td: None)
    assert dist.multihost_capability() == (True, "")
    with config.set(stream_sync_timeout_s=timeout_s):
        for _ in range(2):
            with pytest.raises(RuntimeError, match="closed by peer"):
                dist.sync_stream_pass()
    assert Broken.calls == 2


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    dist.initialize()
    dist.initialize(world_size=1)
    assert dist.process_count() == 1 and dist._td() is None


# -- two real processes over gloo ----------------------------------------------

def _spawn(target, tmp_path, *args, world=2):
    """Run ``target(rank, store, tmp, *args)`` in ``world`` spawned
    processes, each joined under the shared deadline and killed past
    it."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target, args=(r, store, str(tmp_path))
                         + args) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WAIT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f"a process outlived its {WAIT} s deadline"
    outs = []
    for r, p in enumerate(procs):
        with open(os.path.join(str(tmp_path), f"out{r}.json")) as f:
            out = json.load(f)
        assert p.exitcode == 0 and out.get("error") is None, out
        outs.append(out)
    return outs


def _child(rank, store, tmp, body, *args, world=2, mesh_shape="auto"):
    """One spawned process: the gloo group, ``body``, its result file."""
    torch.set_num_threads(1)
    out = {}
    try:
        with config.set(device="cpu", mesh_shape=mesh_shape):
            dist.initialize(init_method="file://" + store, world_size=world,
                            rank=rank, timeout_s=WAIT)
            out = body(rank, tmp, *args)
    except BaseException as exc:  # noqa: BLE001 - reported to the parent
        import traceback

        out = {"error": "".join(traceback.format_exception(exc))}
    with open(os.path.join(tmp, f"out{rank}.json"), "w") as f:
        json.dump(out, f)
    # the hang probe leaves a helper thread inside a collective
    os._exit(0)


def _collectives_body(rank, tmp):
    x = _inputs(rank)
    got = _collect(dist, rank)
    twice = dist.psum_host(x["f64"])
    try:
        dist.allgather_host(np.zeros(3 + rank))
        mismatch = None
    except ValueError as exc:
        mismatch = str(exc)
    sa = dist.array_from_process_local(np.full((5 + rank, 3), rank,
                                                np.float32))
    return {
        "count": dist.process_count(), "index": dist.process_index(),
        "barrier": dist.barrier(), "objs": got["objs"],
        "digests": {k: hashlib.sha1(np.asarray(v).tobytes()).hexdigest()
                    for k, v in got.items() if k not in ("objs", "psum")},
        "psum": [hashlib.sha1(a.tobytes()).hexdigest() for a in got["psum"]],
        "twice": hashlib.sha1(twice.tobytes()).hexdigest(),
        "mismatch": mismatch, "global_rows": sa.global_rows,
        "offset": sa.row_offset,
        "capable": list(dist.multihost_capability()),
        "synced": dist.sync_stream_pass(),
    }


def _collectives_target(rank, store, tmp):
    _child(rank, store, tmp, _collectives_body)


def test_real_two_process_collectives(tmp_path):
    from dask_ml_tpu.parallel import distributed as jdist

    outs = _spawn(_collectives_target, tmp_path)
    ref = jdist.run_virtual_processes(lambda r: _collect(jdist, r), 2)
    for rank, out in enumerate(outs):
        r = ref[rank]
        assert (out["count"], out["index"], out["barrier"]) == (2, rank, 2.0)
        assert out["objs"] == r["objs"]
        for k, dig in out["digests"].items():
            assert dig == hashlib.sha1(np.asarray(r[k]).tobytes()).hexdigest()
        assert out["psum"] == [hashlib.sha1(a.tobytes()).hexdigest()
                               for a in r["psum"]]
        assert out["twice"] == out["digests"]["psum1"]
        assert "identical shape/dtype" in out["mismatch"]
        assert (out["global_rows"], out["offset"]) == (11, [0, 5][rank])
        assert out["capable"] == [True, ""] and out["synced"] is True


def _halves(tmp):
    """The two ranks' memmaps of one dataset (both halves in one file)."""
    rng = np.random.RandomState(7)
    X = rng.randn(3000, 6).astype(np.float32)
    y = (X @ rng.randn(6) + 0.8 * rng.randn(3000) > 0).astype(np.float32)
    C = rng.randn(4, 6) * 5
    K = (C[rng.randint(0, 4, 3000)] + rng.randn(3000, 6)).astype(np.float32)
    return X, y, K, C[[0, 1, 2, 3]] + 0.3


def _memmap(path, a, offset_rows=0, rows=None):
    rows = a.shape[0] if rows is None else rows
    return np.memmap(path, dtype=np.float32, mode="r",
                     offset=offset_rows * a.shape[1] * 4,
                     shape=(rows, a.shape[1]))


def _fits_body(rank, tmp):
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y, K, init = _halves(tmp)
    lo, n = [0, 1700][rank], [1700, 1300][rank]
    Xm = _memmap(os.path.join(tmp, "X.f32"), X, lo, n)
    Km = _memmap(os.path.join(tmp, "K.f32"), K, lo, n)
    with config.set(stream_block_rows=400):
        glm = LogisticRegression(solver="lbfgs", max_iter=20).fit(
            Xm, y[lo:lo + n])
        km = KMeans(4, init=init, max_iter=20).fit(Km)
    return {"coef": glm.coef_.tolist(), "passes":
            glm.solver_info_["data_passes"],
            "centers": km.cluster_centers_.tolist(),
            "inertia": km.inertia_, "n_iter": km.n_iter_}


def _fits_target(rank, store, tmp):
    _child(rank, store, tmp, _fits_body)


def test_real_two_process_streamed_fits(tmp_path):
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y, K, init = _halves(str(tmp_path))
    for name, a in (("X.f32", X), ("K.f32", K)):
        mm = np.memmap(str(tmp_path / name), dtype=np.float32, mode="w+",
                       shape=a.shape)
        mm[:] = a
        mm.flush()
    outs = _spawn(_fits_target, tmp_path)
    with config.set(stream_block_rows=400):
        glm = LogisticRegression(solver="lbfgs", max_iter=20).fit(
            _memmap(str(tmp_path / "X.f32"), X), y)
        km = KMeans(4, init=init, max_iter=20).fit(
            _memmap(str(tmp_path / "K.f32"), K))
    for out in outs:
        np.testing.assert_allclose(out["coef"], glm.coef_, atol=5e-4)
        np.testing.assert_allclose(out["centers"], km.cluster_centers_,
                                   atol=1e-3)
        assert abs(out["inertia"] - km.inertia_) <= 1e-4 * km.inertia_
        assert out["n_iter"] == km.n_iter_
    assert outs[0]["coef"] == outs[1]["coef"]


def _hang_body(rank, tmp):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.reliability import reset_plans

    X, y, _, _ = _halves(tmp)
    part = slice(rank * 1500, (rank + 1) * 1500)
    reset_plans()
    plan = "pass_barrier:hang@0/60" if rank == 1 else ""
    t0 = time.perf_counter()
    try:
        with config.set(stream_block_rows=500, fault_plan=plan,
                        stream_sync_timeout_s=2.0):
            LogisticRegression(solver="lbfgs", max_iter=3).fit(
                X[part], y[part])
        raised = None
    except dist.StreamSyncTimeout as exc:
        raised = str(exc)
    return {"raised": raised, "after": time.perf_counter() - t0}


def _hang_target(rank, store, tmp):
    _child(rank, store, tmp, _hang_body)


def test_real_pass_barrier_hang_ends_in_timeout(tmp_path):
    outs = _spawn(_hang_target, tmp_path)
    assert "did not complete within 2s" in outs[0]["raised"]
    assert outs[0]["after"] < 30
    # rank 1's own deadline ends it too: its barrier body sleeps
    assert outs[1]["raised"] is not None


# -- four real processes: the 2 x 2 mesh's gloo groups -----------------------

def _mesh_body(rank, tmp):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray

    v = np.random.RandomState(rank).randn(16)
    rng = np.random.RandomState(0)
    X = rng.randn(2400, 8).astype(np.float32)
    y = (X @ rng.randn(8) > 0).astype(np.float32)
    part = slice(0, 1400) if rank < 2 else slice(1400, 2400)
    with config.set(stream_block_rows=500):
        streamed = LogisticRegression(solver="lbfgs", max_iter=20).fit(
            X[part], y[part])
    tiled = LogisticRegression(solver="newton", max_iter=5).fit(
        ShardedArray.from_array(X[part], shard_features=True), y[part])
    return {"data": dist.psum_host(v, group="data").tolist(),
            "model": dist.psum_host(v, group="model").tolist(),
            "groups": [dist.allgather_object(rank, "data"),
                       dist.allgather_object(rank, "model")],
            "streamed": streamed.coef_.tolist(),
            "reason": streamed.solver_info_["fused_stream_reason"],
            "tiled": tiled.coef_.tolist()}


def _mesh_target(rank, store, tmp):
    _child(rank, store, tmp, _mesh_body, world=4, mesh_shape="2x2")


def test_real_four_process_2x2_mesh(tmp_path):
    """The 2 x 2 mesh over four real processes: the "data" and "model"
    gloo groups (``new_group``, made at bring-up), a streamed lbfgs over
    column tiles and a resident Newton over a feature-sharded array, each
    held to the single-process fit and bit-equal on every rank."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    outs = _spawn(_mesh_target, tmp_path, world=4)
    vs = [np.random.RandomState(r).randn(16) for r in range(4)]
    rng = np.random.RandomState(0)
    X = rng.randn(2400, 8).astype(np.float32)
    y = (X @ rng.randn(8) > 0).astype(np.float32)
    with config.set(device="cpu", stream_block_rows=500):
        one = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
    with config.set(device="cpu"):
        one2 = LogisticRegression(solver="newton", max_iter=5).fit(X, y)
    for r, out in enumerate(outs):
        j, i = r % 2, r // 2
        np.testing.assert_array_equal(out["data"], vs[j] + vs[j + 2])
        np.testing.assert_array_equal(out["model"],
                                      vs[2 * i] + vs[2 * i + 1])
        assert out["groups"] == [[j, j + 2], [2 * i, 2 * i + 1]]
        assert out["reason"] == "feature-sharded"
        assert out["streamed"] == outs[0]["streamed"]
        assert out["tiled"] == outs[0]["tiled"]
        np.testing.assert_allclose(out["streamed"], one.coef_, atol=5e-4)
        np.testing.assert_allclose(out["tiled"], one2.coef_, atol=5e-4)
