"""The port's federation plane (``serving/federation.py``) against
dask_ml_tpu's, on the CPU.

Every test of ``tests/test_federation.py`` runs here on the port: the
policy's edge cases, registry pinning, seq-guarded publishes, routing,
whole-request failover with ``rerouted_from_process``, back-to-back
fan-outs that converge with no graph captured (``graph_captures`` where
the JAX package counts ``recompiles``), dead processes' gauges dropped,
the ``POST /fleet`` surface and the virtual-rank harness. Where a test
compares decisions or numbers, both packages take the same inputs:
the routing order from the same status snapshots (equal), the seq
sequence taken and dropped (equal), the federated answers of two
``LocalEndpoint`` fleets of each package over a JAX fit carried across
with ``convert`` (``predict`` equal, ``decision_function`` within 1e-5).
The publish wire ships host numpy and rebuilds tensors on the receiving
fleet's device; a body naming the JAX package is refused with 400, and a
fresh interpreter shows that jax was never imported. Every wait has a
limit of its own.
"""

import http.client
import json
import math
import os
import pickle
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dask_ml_tpu import linear_model as JL
from dask_ml_tpu import serving as JS
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.serving import federation as jfed
from dask_ml_tpu.serving import policy as jpolicy
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch import serving as TS
from dask_ml_tpu_torch.observability import _requests as rtrace
from dask_ml_tpu_torch.observability.live import (
    TelemetryServer,
    gauges_snapshot,
)
from dask_ml_tpu_torch.serving import federation as tfed
from dask_ml_tpu_torch.serving import policy as tpolicy

WAIT = 30.0          # seconds any single future, join or call may take
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every block in fresh buffers
    (see tests/test_torch_sgd.py): jax's CPU backend aliases 64-byte
    aligned numpy arrays."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu_and_traces():
    rtrace.traces_reset()
    with config.set(device="cpu"):
        yield
    rtrace.traces_reset()


def _data(seed, n=600, d=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def two_logregs():
    """Two same-shape JAX fits, their port copies (the swap pair), and
    the host rows."""
    X, y = _data(0)
    X2, y2 = _data(7)
    with config.set(device="cpu"):
        ja = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
        jb = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X2, y2)
        return ja, jb, convert.convert(ja), convert.convert(jb), X


def _ladder(pkg=TS):
    return pkg.BucketLadder(8, 64, 2.0)


def _pair(a, name="clf", pkg=TS, methods=("predict",)):
    """Two started in-process fleets (own registries: two processes'
    stand-ins), their endpoints and the router."""
    fleets = [pkg.FleetServer(a, name=name, replicas=1, ladder=_ladder(pkg),
                              methods=methods, batch_window_ms=1.0)
              .warmup().start() for _ in range(2)]
    fed = pkg.FederatedFleet(
        [pkg.LocalEndpoint(f, f"p{i}") for i, f in enumerate(fleets)],
        name=name, ladder=_ladder(pkg)).start()
    return fleets[0], fleets[1], fed


def _captures():
    return obs.counters_snapshot().get("graph_captures", 0)


# -- policy edge cases (what the router ranks by) -----------------------------

@pytest.mark.parametrize("pol", [tpolicy, jpolicy], ids=["port", "jax"])
def test_predict_s_empty_window_admits(pol):
    """A predictor that saw nothing gives None, and None admits."""
    ex = pol.ExecStats()
    assert ex.predict_s("predict", 64) is None
    pred = pol.predict_completion_s(1000, 8, 64, ex.predict_s("predict", 64))
    assert pred is None
    assert pol.admission_verdict(pred, 0.001) is True


def test_predict_s_single_sample_stays_usable():
    """One observation is a usable estimate, equal in both packages; an
    unmeasured sibling bucket borrows it."""
    out = []
    for pol in (tpolicy, jpolicy):
        ex = pol.ExecStats()
        ex.observe("predict", 64, 0.25)
        v = ex.predict_s("predict", 64)
        assert v is not None and math.isfinite(v) and v > 0
        assert ex.predict_s("predict", 8) == pytest.approx(v)
        out.append(v)
    assert out[0] == out[1]


@pytest.mark.parametrize("pol", [tpolicy, jpolicy], ids=["port", "jax"])
def test_predict_s_degenerate_mass_collapses_to_none(pol):
    ex = pol.ExecStats()
    for _ in range(20):
        ex.observe("predict", 64, 0.0)
    assert ex.predict_s("predict", 64) is None
    assert ex.predict_s("predict", 8) is None


def test_completion_and_verdict_guards():
    """The completion predictor's and the verdict's guards give the same
    answers in both packages."""
    cases = [(100, 8, 64, None), (100, 8, 64, 0.0),
             (100, 8, 64, float("nan")), (100, 8, 64, -1.0),
             (0, 8, 64, 0.5), (700, 64, 64, 0.01)]
    for c in cases:
        a, b = tpolicy.predict_completion_s(*c), \
            jpolicy.predict_completion_s(*c)
        assert a == b or (a is None and b is None)
    assert tpolicy.predict_completion_s(0, 8, 64, 0.5) == pytest.approx(0.5)
    verdicts = [(None, 1.0), (float("nan"), 1.0), (2.0, 1.0), (0.5, 1.0),
                (99.0, 0.0)]
    assert [tpolicy.admission_verdict(*v) for v in verdicts] == \
        [jpolicy.admission_verdict(*v) for v in verdicts] == \
        [True, True, False, True, True]


def test_exec_from_snapshot_heterogeneous_windows():
    """The remote twin of the predictor over heterogeneous replica
    windows: thin and degenerate windows skipped, other methods ignored,
    the nearest bucket by log-distance, as in the JAX package."""
    snap = {
        "predict:64": {"count": 30, "p50_s": 0.01, "p90_s": 0.02},
        "predict:8": {"count": 2, "p50_s": 5.0, "p90_s": 5.0},
        "predict:16": {"count": 30, "p50_s": 0.0, "p90_s": 0.0},
        "transform:64": {"count": 30, "p50_s": 9.0, "p90_s": 9.0},
    }
    asks = [(snap, "predict", 64), (snap, "predict", 8),
            (snap, "transform", 8), (snap, "decision_function", 64),
            ({}, "predict", 64), (None, "predict", 64)]
    got = [tfed.exec_from_snapshot(*a) for a in asks]
    assert got == [jfed.exec_from_snapshot(*a) for a in asks]
    assert got == [0.02, 0.02, 9.0, None, None, None]


# -- registry pinning and seq-guarded publishes ------------------------------

def test_registry_pinned_publish(two_logregs):
    """publish(version=) stores at the id, points current at it, moves
    the counter past it and overwrites on a replay."""
    _, _, a, b, _ = two_logregs
    reg = TS.ModelRegistry(keep=8)
    assert reg.publish("m", a) == 1
    assert reg.publish("m", b, version=5) == 5
    assert reg.current_version("m") == 5
    assert reg.publish("m", a) == 6
    assert reg.publish("m", b, version=5) == 5
    assert reg.current_version("m") == 5
    assert reg.versions("m") == (1, 5, 6)
    with pytest.raises(ValueError):
        reg.publish("m", a, version=0)


def test_apply_publish_stale_seq_dropped(two_logregs):
    """Out-of-order fan-out delivery: the newer seq wins whatever the
    arrival order."""
    _, _, a, b, _ = two_logregs
    fleet = TS.FleetServer(a, name="clf", ladder=_ladder(), replicas=1)
    try:
        assert tfed.apply_publish(fleet, b, version=7, seq=5) is True
        assert fleet.version == 7
        assert tfed.apply_publish(fleet, a, version=6, seq=4) is False
        assert fleet.version == 7
        assert fleet.registry.current_version("clf") == 7
        assert fleet.registry.publish("clf", a) == 8
    finally:
        fleet.stop(drain=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_publish_seq_sequence_matches_jax(two_logregs, seed):
    """A seeded sequence of seqs and versions, out of order and with
    replays: both packages' apply_publish take and drop the same ones
    and end on the same version and registry."""
    ja, jb, a, b, _ = two_logregs
    rng = np.random.RandomState(seed)
    seqs = rng.randint(1, 12, size=16)
    versions = rng.randint(1, 9, size=16)
    runs = []
    for pkg, fed, ests in ((TS, tfed, (a, b)), (JS, jfed, (ja, jb))):
        fleet = pkg.FleetServer(ests[0], name="clf", ladder=_ladder(pkg),
                                replicas=1)
        try:
            taken = [fed.apply_publish(fleet, ests[i % 2], version=int(v),
                                       seq=int(s))
                     for i, (s, v) in enumerate(zip(seqs, versions))]
            runs.append((taken, fleet.version,
                         fleet.registry.current_version("clf"),
                         fleet.registry.versions("clf")))
        finally:
            fleet.stop(drain=False)
    assert runs[0] == runs[1]
    assert any(runs[0][0]) and not all(runs[0][0])


# -- routing -------------------------------------------------------------------

def _unstarted_router(pkg, pids):
    return pkg.FederatedFleet(
        [pkg.HttpEndpoint("http://127.0.0.1:1", name="clf", process_id=p)
         for p in pids], name="clf", ladder=_ladder(pkg))


def test_ranked_prefers_predicted_fast():
    """Processes ordered by predicted completion from the cached
    /status windows; a cold process ranks after the warm fast one but
    stays routable."""
    fed = _unstarted_router(TS, ("p0", "p1", "p2"))
    warm = {"count": 30, "p50_s": 0.01, "p90_s": 0.01}
    slow = {"count": 30, "p50_s": 1.0, "p90_s": 1.0}
    fed._procs[0].stats = {"queue_rows": 640,
                           "replicas": [{"exec_s": {"predict:64": slow}}]}
    fed._procs[1].stats = {"queue_rows": 0,
                           "replicas": [{"exec_s": {"predict:64": warm}}]}
    fed._procs[2].stats = {"queue_rows": 0, "replicas": [{"exec_s": {}}]}
    order = [p.endpoint.process_id for p in fed._ranked("predict", 8)]
    assert order == ["p1", "p0", "p2"]


@pytest.mark.parametrize("seed", range(3))
def test_ranked_order_matches_jax(seed):
    """The same random status snapshots (queues, windows of several
    replicas and methods, thin and cold ones, dead processes) give the
    same routing order in both packages, for every method and size."""
    rng = np.random.RandomState(seed)
    pids = [f"p{i}" for i in range(6)]
    stats, alive = [], []
    for _ in pids:
        reps = []
        for _ in range(rng.randint(1, 4)):
            ex = {}
            for m in ("predict", "decision_function"):
                for bkt in (8, 16, 32, 64):
                    if rng.rand() < 0.5:
                        p50 = float(rng.choice([0.0, rng.exponential(0.01)]))
                        ex[f"{m}:{bkt}"] = {
                            "count": int(rng.choice([2, 30, 200])),
                            "p50_s": round(p50, 6),
                            "p90_s": round(p50 * 1.5, 6)}
            reps.append({"exec_s": ex})
        stats.append({"queue_rows": int(rng.choice([0, 0, 40, 300, 900])),
                      "replicas": reps})
        alive.append(bool(rng.rand() < 0.85))
    orders = []
    for pkg in (TS, JS):
        fed = _unstarted_router(pkg, pids)
        for p, st, al in zip(fed._procs, stats, alive):
            p.stats, p.alive = st, al
        orders.append([[p.endpoint.process_id
                        for p in fed._ranked(m, n)]
                       for m in ("predict", "decision_function")
                       for n in (1, 8, 63, 200)])
    assert orders[0] == orders[1]


def test_rows_in_flight_join_the_polled_queue():
    """Between two polls the port's router adds the rows it has in
    flight on a process to that process's polled queue: two equally
    warm processes, 400 rows in flight on p0, and a 200-row request goes
    to p1; the order is JAX's for snapshots whose queues hold those
    rows."""
    warm = {"count": 30, "p50_s": 0.01, "p90_s": 0.01}
    stats = [{"queue_rows": 0,
              "replicas": [{"exec_s": {"predict:64": warm}}]}
             for _ in range(2)]
    fed = _unstarted_router(TS, ("p0", "p1"))
    for p, st in zip(fed._procs, stats):
        p.stats = st
    assert [p.endpoint.process_id for p in fed._ranked("predict", 200)] \
        == ["p0", "p1"]
    fed._procs[0].inflight_rows = 400
    got = [p.endpoint.process_id for p in fed._ranked("predict", 200)]
    jfed_ = _unstarted_router(JS, ("p0", "p1"))
    for p, st, extra in zip(jfed_._procs, stats, (400, 0)):
        p.stats = dict(st, queue_rows=st["queue_rows"] + extra)
    assert got == [p.endpoint.process_id
                   for p in jfed_._ranked("predict", 200)] == ["p1", "p0"]
    assert fed.stats()["processes"][0]["inflight_rows"] == 400


def test_router_without_a_card_raises():
    """The router runs on config.device like every entry point: asking
    for the card on a machine without one raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with config.set(device="cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _unstarted_router(TS, ("p0",))


# -- answers against the JAX package -------------------------------------------

def test_federated_answers_match_jax(two_logregs):
    """A federation over two LocalEndpoint fleets of each package, the
    JAX fit and its port copy: predict equal, decision_function within
    1e-5 (float32 products of two libraries)."""
    ja, _, a, _, X = two_logregs
    methods = ("predict", "decision_function")
    out = {}
    for pkg, est in ((TS, a), (JS, ja)):
        f1, f2, fed = _pair(est, name="ans", pkg=pkg, methods=methods)
        try:
            out[pkg.__name__] = [
                (np.asarray(fed.predict(X[i:i + n])),
                 np.asarray(fed.decision_function(X[i:i + n])))
                for i, n in ((0, 1), (3, 7), (40, 64), (100, 150))]
        finally:
            fed.stop()
            f1.stop()
            f2.stop()
    for (tp, td), (jp, jd) in zip(out[TS.__name__], out[JS.__name__]):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)


# -- failover --------------------------------------------------------------------

def test_federated_failover_zero_lost_with_process_tag(two_logregs):
    """One process dies mid-traffic: every admitted request still
    resolves on the survivor, whose trace names the dead process, and
    the reroute and failover counters move."""
    _, _, a, _, X = two_logregs
    with config.set(obs_trace_sample=1.0):
        f1, f2, fed = _pair(a)
        try:
            want = a.predict(X[:6])
            before = obs.counters_snapshot()
            np.testing.assert_array_equal(fed.predict(X[:6]), want)
            f1.stop(drain=False)          # a SIGKILL's stand-in
            futs = [fed.submit(X[i:i + 4]) for i in range(0, 24, 4)]
            for i, fut in enumerate(futs):
                np.testing.assert_array_equal(
                    fut.result(WAIT), a.predict(X[4 * i:4 * i + 4]))
            after = obs.counters_snapshot()
            for k in ("serving_process_reroutes",
                      "serving_process_failovers"):
                assert after.get(k, 0) > before.get(k, 0), k
            assert fed.stats()["live_processes"] == 1
        finally:
            fed.stop()
            f1.stop(drain=False)
            f2.stop()
    tagged = [t for t in rtrace.traces_data()["traces"]
              if t.get("rerouted_from_process") == "p0"
              and t["outcome"] == "ok"]
    assert tagged, "no survivor trace carried rerouted_from_process"


def test_all_processes_down_is_typed(two_logregs):
    _, _, a, _, X = two_logregs
    f1, f2, fed = _pair(a)
    try:
        f1.stop(drain=False)
        f2.stop(drain=False)
        with pytest.raises(TS.NoLiveProcesses):
            fed.submit(X[:4]).result(WAIT)
    finally:
        fed.stop()


# -- publish fan-out -------------------------------------------------------------

def test_fanout_back_to_back_converges_and_captures_nothing(two_logregs):
    """Back-to-back fan-outs and a rollback: every process lands on the
    control registry's current version with equal ids, serves it, and
    the warmed fleets capture no graph (graph_captures, where the JAX
    package counts recompiles)."""
    _, _, a, b, X = two_logregs
    f1, f2, fed = _pair(a)
    try:
        before = _captures()
        for est in (b, a, b, a):
            v = fed.publish(est)
        assert fed.registry.current_version("clf") == v
        for f in (f1, f2):
            assert f.version == v and f.registry.current_version("clf") == v
        np.testing.assert_array_equal(fed.predict(X[:8]), a.predict(X[:8]))
        back = fed.rollback()
        assert back == v - 1 and f1.version == f2.version == back
        np.testing.assert_array_equal(fed.predict(X[:8]), b.predict(X[:8]))
        assert _captures() - before == 0
    finally:
        fed.stop()
        f1.stop()
        f2.stop()


def test_fanout_skips_dead_and_reconverges_on_next_publish(two_logregs):
    """A publish while a process is down skips it; once it is back, the
    next publish converges it."""
    _, _, a, b, _ = two_logregs
    f1, f2, fed = _pair(a)
    try:
        fed._poll_once()
        v0 = fed.publish(a)
        f2.stop(drain=False)
        v1 = fed.publish(b)
        assert v1 > v0 and f1.version == v1 and f2.version == v0
        f2b = TS.FleetServer(a, name="clf", replicas=1, ladder=_ladder(),
                             batch_window_ms=1.0).warmup().start()
        try:
            fed._procs[1].endpoint.fleet = f2b
            fed._procs[1].alive = True
            v2 = fed.publish(a)
            assert f1.version == v2 and f2b.version == v2
            assert f2b.registry.current_version("clf") == v2
        finally:
            f2b.stop()
    finally:
        fed.stop()
        f1.stop(drain=False)
        f2.stop(drain=False)


def test_process_failover_drops_process_gauges(two_logregs):
    """A process marked dead leaves no serving_process_* series on
    /metrics."""
    _, _, a, _, _ = two_logregs

    def have():
        return {(n, dict(ls).get("process")) for (n, ls) in gauges_snapshot()}

    with TelemetryServer(port=0):
        f1, f2, fed = _pair(a)
        try:
            fed._poll_once()
            assert {("serving_process_healthy", "p0"),
                    ("serving_process_healthy", "p1")} <= have()
            f1.stop(drain=False)
            fed._poll_once()
            assert ("serving_process_healthy", "p0") not in have()
            assert ("serving_process_replicas", "p0") not in have()
            assert ("serving_process_healthy", "p1") in have()
        finally:
            fed.stop()
            f1.stop(drain=False)
            f2.stop()


# -- the HTTP surface --------------------------------------------------------------

def test_http_endpoint_roundtrip_publish_and_errors(two_logregs):
    """POST /fleet against a real exporter: status, an npy round trip, a
    version-pinned publish, a stale one, an unknown fleet and a dead
    exporter both ProcessDown."""
    _, _, a, b, X = two_logregs
    ts = TelemetryServer(port=0).start()
    fleet = TS.FleetServer(a, name="clf", replicas=1, ladder=_ladder(),
                           batch_window_ms=1.0).warmup().start()
    try:
        ep = TS.HttpEndpoint(ts.url, name="clf", process_id="h0",
                             timeout_s=WAIT)
        assert ep.status()["fleet"] == "clf"
        np.testing.assert_array_equal(ep.submit(X[:7]), a.predict(X[:7]))
        assert ep.apply_publish(b, version=9, seq=1) is True
        assert fleet.version == 9
        assert fleet.registry.current_version("clf") == 9
        np.testing.assert_array_equal(ep.submit(X[:7]), b.predict(X[:7]))
        assert ep.apply_publish(a, version=8, seq=1) is False
        assert fleet.version == 9
        with pytest.raises(TS.ProcessDown):
            TS.HttpEndpoint(ts.url, name="ghost").submit(X[:2])
    finally:
        fleet.stop()
        ts.stop()
    with pytest.raises(TS.ProcessDown):
        ep.status()


class _Raising:
    """A stand-in fleet registered on the live plane whose submit raises
    one typed serving error."""

    replicas = ()

    def __init__(self, name, exc):
        self.name, self.exc = name, exc

    def submit(self, X, method="predict"):
        raise self.exc

    def stats(self):
        return {"fleet": self.name}


@pytest.mark.parametrize("exc,code,kind,back", [
    (TS.SloShed("shed"), 429, "slo_shed", TS.SloShed),
    (TS.ServerOverloaded("full"), 429, "overloaded", TS.ServerOverloaded),
    (TS.ServerClosed("closed"), 503, "closed", TS.ProcessDown),
    (TS.NoHealthyReplicas("none"), 503, "closed", TS.ProcessDown),
    (TS.RequestTimeout("late"), 504, "timeout", TS.RequestTimeout),
    (TS.ServingError("broke"), 500, "error", TS.ProcessDown),
], ids=["slo_shed", "overloaded", "closed", "no_replicas", "timeout",
        "error"])
def test_http_typed_errors_map_to_codes_and_back(monkeypatch, exc, code,
                                                 kind, back):
    """Each typed serving error answers its status and X-Fed-Error kind,
    the same pair dask_ml_tpu's handler gives, and HttpEndpoint raises
    the matching error again."""
    from dask_ml_tpu_torch.observability import live

    name = f"raising-{kind}"
    stub = _Raising(name, exc)
    live.register_server(stub)
    ts = TelemetryServer(port=0).start()
    try:
        body = tfed._npy_bytes(np.zeros((2, 3), np.float32))
        got = tfed.handle_http(f"/fleet/{name}/predict", {}, body)
        assert got[0] == code and got[3] == {"X-Fed-Error": kind}
        jexc = getattr(JS, type(exc).__name__)(str(exc))
        jstub = _Raising(name, jexc)
        monkeypatch.setattr(jfed, "_find_fleet", lambda n: jstub)
        jgot = jfed.handle_http(f"/fleet/{name}/predict", {}, body)
        assert (jgot[0], jgot[3]) == (got[0], got[3])
        with pytest.raises(back):
            TS.HttpEndpoint(ts.url, name=name, timeout_s=WAIT).submit(
                np.zeros((2, 3), np.float32))
    finally:
        ts.stop()
        live.unregister_server(stub)


def test_http_surface_refusals(two_logregs):
    """A path that is not /fleet/<name>/<op> is 404, an unknown fleet
    503 (kind unknown), a body that is not npy 400, an unknown method
    500, each as the JAX handler answers."""
    _, _, a, _, X = two_logregs
    fleet = TS.FleetServer(a, name="clf", replicas=1, ladder=_ladder(),
                           batch_window_ms=1.0).warmup().start()
    try:
        npy = tfed._npy_bytes(X[:2])
        cases = [("/fleet/clf", npy), ("/fleet/ghost/predict", npy),
                 ("/fleet/clf/predict", b"not npy"),
                 ("/fleet/clf/publish", b"not a pickle"),
                 ("/fleet/clf/transform", npy)]
        got = [tfed.handle_http(p, {}, b)[0] for p, b in cases]
        assert got == [404, 503, 400, 400, 500]
        assert tfed.handle_http("/fleet/ghost/predict", {}, npy)[3] == \
            {"X-Fed-Error": "unknown"}
    finally:
        fleet.stop()


@pytest.mark.parametrize("err", [
    http.client.IncompleteRead(b"", 464),
    http.client.RemoteDisconnected("closed"),
    ConnectionResetError("reset"),
    ConnectionRefusedError("refused"),
], ids=["incomplete_read", "remote_disconnected", "reset", "refused"])
def test_http_dying_process_is_process_down(monkeypatch, err):
    """A process killed before or during its answer surfaces as any of
    these exceptions; each maps to ProcessDown, so the router re-issues
    the request whole."""
    def boom(*args, **kwargs):
        raise err

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    ep = TS.HttpEndpoint("http://127.0.0.1:1", name="clf",
                         process_id="h0", timeout_s=1.0)
    with pytest.raises(TS.ProcessDown):
        ep.submit(np.zeros((2, 3), np.float32))
    with pytest.raises(TS.ProcessDown):
        ep.status()
    with pytest.raises(TS.ProcessDown):
        ep.apply_publish(object(), version=1, seq=1)


def test_http_reroute_header_tags_survivor_trace(two_logregs):
    """X-Fed-Reroute carries the dead process's id into the survivor's
    trace."""
    _, _, a, _, X = two_logregs
    with config.set(obs_trace_sample=1.0):
        with TelemetryServer(port=0) as ts:
            fleet = TS.FleetServer(a, name="clf", replicas=1,
                                   ladder=_ladder(),
                                   batch_window_ms=1.0).warmup().start()
            try:
                ep = TS.HttpEndpoint(ts.url, name="clf", timeout_s=WAIT)
                got = ep.submit(X[:3], rerouted_from="proc-dead")
                assert got.shape == (3,)
            finally:
                fleet.stop()
    tagged = [t for t in rtrace.traces_data()["traces"]
              if t.get("rerouted_from_process") == "proc-dead"]
    assert tagged and tagged[-1]["outcome"] == "ok"


# -- the publish wire ------------------------------------------------------------

def test_publish_wire_rebuilds_tensors_on_the_fleet_device(two_logregs):
    """An SGDClassifier holds its weights as a tensor. Its publish body
    holds host numpy and no tensor storage; handled on a thread whose own
    config asks for the card, it lands on the receiving fleet's device
    (the CPU here) and serves the sender's answers."""
    from dask_ml_tpu_torch.linear_model import SGDClassifier

    _, _, a, _, X = two_logregs
    Xs, ys = _data(3)
    sgd = SGDClassifier(max_iter=3, random_state=0).fit(Xs, ys)
    assert isinstance(sgd._w, torch.Tensor)
    body = tfed._publish_bytes(sgd)
    assert b"torch._utils" not in body and b"_rebuild_tensor" not in body
    fleet = TS.FleetServer(a, name="wire", replicas=1, ladder=_ladder(),
                           batch_window_ms=1.0).warmup().start()
    out = {}
    try:
        def handler_thread():
            # the default config of a fresh thread: device "cuda"
            out["reply"] = tfed.handle_http(
                "/fleet/wire/publish", {"X-Fed-Version": "4",
                                        "X-Fed-Seq": "1"}, body)

        t = threading.Thread(target=handler_thread)
        t.start()
        t.join(WAIT)
        assert not t.is_alive()
        code, reply, _, _ = out["reply"]
        assert code == 200, reply
        assert json.loads(reply) == {"applied": True, "version": 4}
        got = fleet.registry.get("wire").estimator
        assert got._w.device == fleet.replicas[0].device
        np.testing.assert_array_equal(got._w.numpy(), sgd._w.numpy())
        np.testing.assert_array_equal(fleet.predict(X[:9]),
                                      sgd.predict(X[:9]))
    finally:
        fleet.stop()


def test_publish_refuses_jax_package_bodies(two_logregs):
    """A body pickling a dask_ml_tpu estimator is refused with 400 and
    names the package; nothing is published."""
    ja, _, a, _, _ = two_logregs
    fleet = TS.FleetServer(a, name="refuse", replicas=1, ladder=_ladder())
    try:
        fleet.start()
        code, reply, _, _ = tfed.handle_http(
            "/fleet/refuse/publish", {"X-Fed-Version": "2",
                                      "X-Fed-Seq": "1"},
            pickle.dumps(ja))
        assert code == 400 and b"names dask_ml_tpu." in reply
        assert fleet.version == 1 and not hasattr(fleet, "_fed_seq")
    finally:
        fleet.stop(drain=False)


_CHILD_REFUSAL = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.serving import BucketLadder, FleetServer
from dask_ml_tpu_torch.serving.federation import handle_http
with config.set(device="cpu"):
    rng = np.random.RandomState(0)
    X = rng.randn(100, 4).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(
        X, (X[:, 0] > 0) * 1.0)
    fleet = FleetServer(clf, name="m", replicas=1,
                        ladder=BucketLadder(8, 16, 2.0)).start()
    body = open(sys.argv[1], "rb").read()
    code = handle_http("/fleet/m/publish", {{"X-Fed-Seq": "1"}}, body)[0]
    fleet.stop(drain=False)
print(code, "jax" in sys.modules, "jaxlib" in sys.modules,
      "dask_ml_tpu" in sys.modules)
"""


def test_refused_body_never_imports_jax(two_logregs, tmp_path):
    """In a fresh interpreter of the port, a publish body that names the
    JAX package's estimator is refused (400) and neither jax nor
    dask_ml_tpu was ever imported."""
    ja, _, _, _, _ = two_logregs
    path = tmp_path / "body.pkl"
    path.write_bytes(pickle.dumps(ja))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD_REFUSAL.format(repo=REPO),
         str(path)], capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["400", "False", "False", "False"]


# -- the virtual-rank harness ----------------------------------------------------

def test_virtual_rank_federation_roundtrip(two_logregs):
    """Each virtual rank builds its own fleet; the router federates the
    ranks' endpoints, and a publish converges every rank's registry to
    the pinned version."""
    from dask_ml_tpu_torch.parallel.distributed import run_virtual_processes

    _, _, a, b, X = two_logregs

    def build(rank):
        fleet = TS.FleetServer(a, name="clf", replicas=1, ladder=_ladder(),
                               batch_window_ms=1.0).warmup().start()
        return TS.LocalEndpoint(fleet, f"rank{rank}")

    eps = run_virtual_processes(build, world=2)
    fed = TS.FederatedFleet(eps, name="clf", ladder=_ladder()).start()
    try:
        np.testing.assert_array_equal(fed.predict(X[:10]), a.predict(X[:10]))
        # the served model goes through the control registry first: a
        # fleet born from its own version 1 does not swap when a pinned
        # version 1 arrives
        fed.publish(a)
        v = fed.publish(b)
        assert all(ep.fleet.version == v for ep in eps)
        assert all(ep.fleet.registry.current_version("clf") == v
                   for ep in eps)
        np.testing.assert_array_equal(fed.predict(X[:10]), b.predict(X[:10]))
    finally:
        fed.stop()
        for ep in eps:
            ep.fleet.stop()
