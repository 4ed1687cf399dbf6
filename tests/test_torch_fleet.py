"""The port's fleet plane (``serving/registry.py``, ``fleet.py``,
``autoscale.py``, ``loadtest.py`` and ``reliability/supervisor.py``)
against dask_ml_tpu's, on the CPU.

The registry, driven alike in both packages, gives the same versions,
currents and status rows. A warmed two-replica fleet under ragged
traffic captures no graph across same-shape publishes, and every answer
equals the prediction of a version live while it was served.
``serve_while_training`` (binary and ten-class SGD, ``Incremental``
passes from host rows) publishes each pass; its trained model agrees
with the JAX package's Incremental over the same passes (coef_ within
1e-5, the SGD tests' tolerance; the JAX reference streams from the host
with fresh staging buffers, ``_PUT_ALIASES``). A ``replica_worker``
crash under ``serving_supervise`` rebuilds the replica and loses no
request. Every wait has a limit of its own.
"""

import threading
import time

import jax
import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import serving as JS
from dask_ml_tpu import wrappers as JW
from dask_ml_tpu.models import sgd as JSGD
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu_torch import config, convert, reliability
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch import serving as TS
from dask_ml_tpu_torch import wrappers as TW
from dask_ml_tpu_torch.models import sgd as TSGD

WAIT = 30.0          # seconds any single future, join or poll may take


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every block in fresh buffers
    (see tests/test_torch_sgd.py): jax's CPU backend aliases 64-byte
    aligned numpy arrays."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _jax(fn):
    with jconfig.set(stream_mesh=1), use_mesh(
            device_mesh(devices=jax.devices()[:1])):
        return fn()


def _data(seed=0, n=600, d=12, k=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k)
    y = np.argmax(X @ W + 0.3 * rng.randn(n, k), axis=1) if k > 2 \
        else (X @ W[:, 0] + 0.3 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def two_models():
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    with config.set(device="cpu"):
        a = LogisticRegression(solver="lbfgs", max_iter=30).fit(*_data(0))
        b = LogisticRegression(solver="lbfgs", max_iter=30).fit(*_data(7))
    return a, b, _data(0)[0]


def _ladder():
    return TS.BucketLadder(8, 128, 2.0)


def _captures():
    return obs.counters_snapshot().get("graph_captures", 0)


def _join(threads):
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a client hung"


class _Est:
    def __init__(self, tag):
        self.tag = tag


def _drive_registry(mod):
    reg = mod.ModelRegistry(keep=3)
    seen = []
    reg.subscribe("m", lambda mv: seen.append(mv.version))
    for k in range(5):
        reg.publish("m", _Est(k), tag=f"t{k}", publisher="p")
    out = [reg.versions("m"), reg.current_version("m"), list(seen)]
    out.append(reg.rollback("m"))
    out.append(reg.rollback("m", version=5))
    for bad in (lambda: reg.rollback("m", version=1),
                lambda: reg.get("nope"), lambda: reg.current_version("x")):
        try:
            bad()
        except mod.UnknownModelError as exc:
            out.append(type(exc).__name__)
    out.append(reg.publish("m", _Est(9), version=12))
    out.append(reg.publish("m", _Est(10)))
    snap = reg.status_snapshot()["m"]
    snap.pop("t_publish")
    out += [snap, reg.names(), list(seen), repr(reg.get("m", 13))]
    try:
        mod.ModelRegistry(keep=0)
    except ValueError:
        out.append("keep")
    return out


def test_registry_matches_jax():
    assert _drive_registry(TS) == _drive_registry(JS)
    reg = TS.ModelRegistry()
    est = _Est(0)
    reg.publish("m", est)
    est.tag = 99                      # the archive is a snapshot
    assert reg.get("m").estimator.tag == 0


def test_fleet_captures_nothing_across_swaps_under_traffic(two_models):
    a, b, X = two_models
    preds = {1: a.predict(X), 2: b.predict(X)}
    fleet = TS.FleetServer(a, name="clf", replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0).warmup()
    errs, stop, versions = [], threading.Event(), []
    with fleet:
        c0 = _captures()

        def client(seed):
            rng = np.random.RandomState(seed)
            while not stop.is_set():
                n = int(rng.randint(1, 100))
                i = int(rng.randint(0, len(X) - n))
                try:
                    got = fleet.submit(X[i:i + n]).result(WAIT)
                except TS.ServingError as exc:
                    errs.append(repr(exc))
                    continue
                if not any(np.array_equal(got, p[i:i + n])
                           for p in preds.values()):
                    errs.append(f"mismatch at {i}+{n}")

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for est in (b, a, b, a):
            time.sleep(0.1)
            versions.append(fleet.publish(est))
        time.sleep(0.1)
        stop.set()
        _join(threads)
        stats = fleet.stats()
        captures = _captures() - c0
    assert not errs, errs[:3]
    assert captures == 0
    assert stats["version"] == versions[-1] and stats["swaps"] >= 4
    assert all(r["version"] == versions[-1] for r in stats["replicas"])
    assert stats["n_replicas"] == 2 and stats["healthy_replicas"] == 2


def test_fleet_routes_least_loaded(two_models):
    a, _, X = two_models
    fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0)
    with fleet:
        r0, r1 = fleet.replicas
        r0.pause()
        r1.pause()
        futs = [fleet.submit(X[:4]) for _ in range(6)]
        assert r0._queue.depth == 3 and r1._queue.depth == 3
        r0.resume()
        r1.resume()
        for f in futs:
            assert f.result(WAIT).shape == (4,)


def test_fleet_failover_and_no_healthy_replicas(two_models):
    a, _, X = two_models
    want = a.predict(X[:6])
    fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0)
    with fleet:
        r0, r1 = fleet.replicas
        r0.pause()
        doomed = []
        while r0._queue.depth == 0:
            f = fleet.submit(X[:4])
            if r0._queue.depth:
                doomed.append(f)
        r0.stop(drain=False, timeout=WAIT)
        with pytest.raises(TS.ServerClosed):
            doomed[-1].result(WAIT)
        for _ in range(5):
            np.testing.assert_array_equal(
                fleet.submit(X[:6]).result(WAIT), want)
        assert fleet.stats()["healthy_replicas"] == 1
        v = r1.model_version
        fleet.publish(a)
        assert r1.model_version == v + 1
        r1.stop(drain=False, timeout=WAIT)
        with pytest.raises(TS.NoHealthyReplicas):
            fleet.submit(X[:4])


def test_fleet_rebuilds_on_incompatible_publish(two_models):
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    a, _, X = two_models
    multi = LogisticRegression(solver="lbfgs", max_iter=20).fit(
        *_data(1, k=3))
    fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0).warmup()
    with fleet:
        r0 = obs.counters_snapshot().get("serving_swap_rebuilds", 0)
        fleet.publish(multi)
        np.testing.assert_array_equal(fleet.submit(X[:30]).result(WAIT),
                                      multi.predict(X[:30]))
        assert obs.counters_snapshot()["serving_swap_rebuilds"] == r0 + 2


def test_slo_admission_sheds_and_never_on_ignorance(two_models):
    a, _, X = two_models
    with config.set(serving_slo_ms=30.0):
        fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                               batch_window_ms=1.0, timeout_ms=0).warmup()
    with fleet:
        for r in fleet.replicas:
            r.pause()
            for _ in range(13):
                r._exec.observe("predict", 128, 0.5)
            for _ in range(8):
                r._queue.put(TS._batching.Request(X[:100], "predict"))
        shed0 = obs.counters_snapshot().get("serving_slo_shed", 0)
        with pytest.raises(TS.SloShed):
            fleet.submit(X[:100])
        assert obs.counters_snapshot()["serving_slo_shed"] == shed0 + 1
        for r in fleet.replicas:
            r._queue.drain_all()
            r.resume()
    with config.set(serving_slo_ms=1.0):
        fleet = TS.FleetServer(a, replicas=1, ladder=_ladder(),
                               batch_window_ms=1.0, timeout_ms=0)
    with fleet:
        assert fleet.submit(X[:4]).result(WAIT).shape == (4,)


def _serve_while_training(X, y, classes, passes=3):
    """The port's serve_while_training under two clients: returns the
    trained wrapper, the flips and, per answer, whether it equals the
    prediction of a version live while it was served."""
    inc = TW.Incremental(TSGD.SGDClassifier(max_iter=1, random_state=0,
                                            shuffle=False),
                         shuffle_blocks=False)
    inc.partial_fit(X, y, classes=classes)
    fleet = TS.FleetServer(inc.estimator_, name="online", replicas=2,
                           ladder=_ladder(), batch_window_ms=1.0,
                           timeout_ms=0).warmup()
    log, flips, stop = [], [], threading.Event()
    with fleet:
        c0 = _captures()

        def client(seed):
            rng = np.random.RandomState(seed)
            while not stop.is_set():
                n = int(rng.randint(1, 60))
                i = int(rng.randint(0, len(X) - n))
                # served by a version between the fleet's (set once every
                # replica swapped) and the registry's current one (set
                # before the swaps)
                v0 = fleet.version
                out = fleet.submit(X[i:i + n]).result(WAIT)
                log.append((i, n, v0,
                            fleet.registry.current_version("online"), out))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(2)]
        for t in threads:
            t.start()
        TS.serve_while_training(
            fleet, inc, X, y, passes=passes, classes=classes,
            on_pass=lambda p, v: (flips.append((p, v)), time.sleep(0.05)))
        time.sleep(0.05)
        stop.set()
        _join(threads)
        captures = _captures() - c0
        final = fleet.submit(X[:64]).result(WAIT)
    preds, keep = {}, {}
    for v in fleet.registry.versions("online"):
        est = fleet.registry.get("online", v).estimator
        preds[v] = est.predict(X)
        eta = est.decision_function(X)
        eta = eta if eta.ndim == 1 else np.diff(np.sort(eta, 1)[:, -2:])[:, 0]
        keep[v] = np.abs(eta) > 1e-5          # float ties left out
    served = [any(np.array_equal(out[keep[v][i:i + n]],
                                 preds[v][i:i + n][keep[v][i:i + n]])
                  for v in range(v0, v1 + 1) if v in preds)
              for i, n, v0, v1, out in log]
    return inc, flips, served, captures, final, fleet


@pytest.mark.parametrize("k", [2, 10], ids=["binary", "ten-class"])
def test_serve_while_training(k):
    X, y = _data(3, n=2000, d=12, k=k)
    classes = np.unique(y)
    inc, flips, served, captures, final, fleet = _serve_while_training(
        X, y, classes)
    assert [p for p, _ in flips] == [1, 2, 3]
    vs = [v for _, v in flips]
    assert vs == sorted(vs) and len(set(vs)) == 3
    assert fleet.version == vs[-1]
    assert captures == 0
    assert served and all(served), served.count(False)
    np.testing.assert_array_equal(final, inc.estimator_.predict(X[:64]))
    # the trained passes agree with the JAX package's Incremental
    j = JW.Incremental(JSGD.SGDClassifier(max_iter=1, random_state=0,
                                          shuffle=False),
                       shuffle_blocks=False)
    for _ in range(4):
        _jax(lambda: j.partial_fit(X, y, classes=classes))
    np.testing.assert_allclose(inc.estimator_.coef_, j.estimator_.coef_,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(inc.estimator_.intercept_,
                               j.estimator_.intercept_, rtol=0, atol=1e-5)


def test_supervisor_rebuilds_a_crashed_replica(two_models):
    a, _, X = two_models
    want = a.predict(X)
    reliability.reset_plans()
    with config.set(fault_plan="replica_worker:crash@6",
                    serving_supervise=True,
                    serving_supervise_interval_s=0.02):
        fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                               batch_window_ms=1.0, timeout_ms=0).warmup()
    restarts0 = obs.counters_snapshot().get("serving_replica_restarts", 0)
    outcomes = []
    with fleet:
        first = fleet.replicas

        def client(s):
            for k in range(40):
                i = (s * 40 + k) % 500
                try:
                    got = fleet.submit(X[i:i + 7]).result(WAIT)
                    outcomes.append(np.array_equal(got, want[i:i + 7]))
                except TS.ServingError as exc:
                    outcomes.append(type(exc).__name__)
                time.sleep(0.002)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(3)]
        for t in threads:
            t.start()
        _join(threads)
        t_end = time.perf_counter() + WAIT
        while time.perf_counter() < t_end and obs.counters_snapshot().get(
                "serving_replica_restarts", 0) == restarts0:
            time.sleep(0.02)
        restarted = [r for r, f in zip(fleet.replicas, first) if r is not f]
        assert fleet.submit(X[:5]).result(WAIT).shape == (5,)
    reliability.reset_plans()
    assert obs.counters_snapshot()["serving_replica_restarts"] == \
        restarts0 + 1
    assert len(restarted) == 1 and restarted[0].healthy is False
    assert outcomes == [True] * 120       # none lost, none wrong
    assert obs.counters_snapshot().get(
        "faults_injected_replica_worker", 0) >= 1


def test_supervisor_budget_degrades_to_failover(two_models):
    a, _, X = two_models
    fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0)
    with fleet:
        sup = reliability.ReplicaSupervisor(fleet, interval_s=0.02, budget=0)
        dead = fleet.replicas[0]
        dead.stop(drain=False, timeout=WAIT)
        sup._sweep()
        assert sup._failed == {0} and sup.restarts() == {}
        assert fleet.submit(X[:3]).result(WAIT).shape == (3,)


def test_autoscaler_scales_on_the_slo_signal(two_models):
    a, _, X = two_models
    with config.set(serving_slo_ms=50.0):
        fleet = TS.FleetServer(a, replicas=1, ladder=_ladder(),
                               batch_window_ms=1.0, timeout_ms=0).warmup()
        scaler = TS.ReplicaAutoscaler(fleet, min_replicas=1,
                                      max_replicas=2, patience=1,
                                      cooldown_s=0.0)
    assert scaler.up_ms == 40.0 and scaler.down_ms == 10.0
    with fleet:
        assert scaler.signal_ms() is None       # cold: no estimate
        scaler.tick()
        assert len(fleet.replicas) == 1
        r = fleet.replicas[0]
        for _ in range(13):
            r._exec.observe("predict", 128, 0.5)
        scaler.tick()
        assert len(fleet.replicas) == 2 and scaler.events[-1][0] == "up"
        assert fleet.submit(X[:9]).result(WAIT).shape == (9,)
        for rep in fleet.replicas:
            rep._exec = TS.policy.ExecStats()
            for _ in range(13):
                rep._exec.observe("predict", 128, 1e-5)
        scaler.tick()
        assert len(fleet.replicas) == 1 and scaler.events[-1][0] == "down"
        scaler.tick()
        assert len(fleet.replicas) == 1          # never below min


def test_synthesize_records_matches_jax():
    kw = dict(methods=("predict", "predict_proba"), rows=(1, 64),
              rate_rps=300.0, seed=4)
    assert TS.synthesize_records(40, **kw) == JS.synthesize_records(40, **kw)


def test_replay_load_test(two_models, tmp_path):
    import json

    a, b, X = two_models
    recs = TS.synthesize_records(30, rows=(1, 40), rate_rps=2000.0, seed=1)
    path = tmp_path / "capture.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs) + "junk\n")
    fleet = TS.FleetServer(a, replicas=2, ladder=_ladder(),
                           batch_window_ms=1.0, timeout_ms=0).warmup()
    with fleet:
        fleet.publish(b)
        rep = TS.replay_load_test(fleet, X, capture_path=str(path),
                                  speed=4.0, slo_ms=5000.0,
                                  canary_version=1, result_timeout_s=WAIT)
        assert fleet.registry.current_version("model") == 2
    assert rep["passed"] and rep["ok"] == 30 and rep["admitted"] == 30
    assert rep["requests"] == 30 and rep["restored_version"] == 2
    miss = TS.replay_load_test(
        lambda: TS.ModelServer(a, ladder=_ladder(), timeout_ms=0)
        .warmup().start(), X, records=recs, slo_ms=1e-6,
        result_timeout_s=WAIT)
    assert not miss["passed"] and miss["ok"] == 30
