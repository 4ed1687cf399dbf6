"""The port's request traces (``observability/_requests.py``) against
dask_ml_tpu's, on the CPU: the tail sampler on one seeded latency
sequence, traces served by both packages' ModelServer under the same
requests (stage sets, tags, outcomes), the fleet's reroute and SLO-shed
traces, the request capture and its replay, and the zero-cost default.
Every wait has a limit of its own; no sleep is longer than 0.2 s."""

import threading

import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import linear_model as JL
from dask_ml_tpu import serving as JS
from dask_ml_tpu.observability import _requests as jrtrace
from dask_ml_tpu.reliability import faults as jfaults
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import serving as TS
from dask_ml_tpu_torch.observability import _requests as rtrace
from dask_ml_tpu_torch.observability import alerts, drift
from dask_ml_tpu_torch.reliability import faults as tfaults
from dask_ml_tpu_torch.serving import loadtest

WAIT = 30.0


def _reset():
    for m in (rtrace, jrtrace):
        m.traces_reset()
    tfaults.reset_plans()
    jfaults.reset_plans()
    alerts.reset()
    drift.reset()


@pytest.fixture(autouse=True)
def _clean():
    # the planes are process-wide: a server of another file may have
    # left a drift monitor or events behind
    _reset()
    with config.set(device="cpu"):
        yield
    _reset()


@pytest.fixture(scope="module")
def models():
    """A JAX fit and its port copy, a second pair for the hot swap, and
    the rows both packages serve."""
    rng = np.random.RandomState(0)
    X = rng.randn(600, 12).astype(np.float32)
    y = (X @ rng.randn(12) + 0.3 * rng.randn(600) > 0).astype(np.float32)
    y2 = (X @ rng.randn(12) > 0).astype(np.float32)
    with config.set(device="cpu"):
        a = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
        b = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y2)
        return a, b, convert.convert(a), convert.convert(b), X


def _ladder(pkg):
    return pkg.BucketLadder(8, 64, 2.0)


# -- the tail sampler ---------------------------------------------------------

def _fake_finish(mod, e2e, outcome="ok", **tags):
    tr = mod.RequestTrace("predict", 4, t_admit=100.0)
    tr.stages["complete"] = 100.0 + e2e
    tr.tag(**tags)
    tr.finish(outcome)


@pytest.mark.parametrize("p", [0.05, 0.3, 1.0])
def test_tail_sampler_keeps_the_same_traces_as_jax(p):
    """One seeded latency sequence through both samplers keeps the same
    traces (by e2e and outcome), with the same rolling thresholds."""
    rng = np.random.RandomState(5)
    lat = np.exp(rng.randn(300) - 6.0)
    outcomes = ["ok"] * 300
    for i in rng.choice(300, 7, replace=False):
        outcomes[i] = "error"
    with config.set(obs_trace_sample=p), jconfig.set(obs_trace_sample=p):
        for e2e, out in zip(lat, outcomes):
            for mod in (rtrace, jrtrace):
                _fake_finish(mod, float(e2e), out)
        _fake_finish(rtrace, 1e-9, rerouted_from=3)
        _fake_finish(jrtrace, 1e-9, rerouted_from=3)
        got, want = rtrace.traces_data(), jrtrace.traces_data()
    assert got["counts"] == want["counts"]
    assert [(t["e2e_s"], t["outcome"]) for t in got["traces"]] == \
        [(t["e2e_s"], t["outcome"]) for t in want["traces"]]
    assert got["traces"][-1]["rerouted_from"] == 3
    assert rtrace._thresh == jrtrace._thresh
    assert rtrace._ring == jrtrace._ring


def test_slow_threshold_matches_jax():
    rng = np.random.RandomState(9)
    for e2e in rng.exponential(0.01, 200):
        a = rtrace._slow_threshold(float(e2e), 0.1)
        b = jrtrace._slow_threshold(float(e2e), 0.1)
        assert a == b


def test_ids_tags_and_context():
    """Ids carry the pid in their high bits; pending tags and a
    continued trace id apply to traces made inside their scopes."""
    import os

    with rtrace.tagging(rerouted_from=2), rtrace.tagging(replica=1):
        tr = rtrace.new_trace("predict", 3)
    assert tr.tags == {"rerouted_from": 2, "replica": 1}
    assert tr.trace_id >> 24 == os.getpid() & 0xFFFFFF
    with rtrace.trace_context(12345):
        assert rtrace.RequestTrace("predict", 1).trace_id == 12345
    assert rtrace.new_trace("predict", 1).tags == {}
    tr.finish("ok")
    tr.finish("error")           # finishes once, with the first outcome
    assert rtrace.traces_data()["counts"]["completed"] == 1


# -- served traces against JAX's ----------------------------------------------

def _serve_script(pkg, cfgmod, rtmod, faultsmod, est, est2, X):
    """The same request script on one package's ModelServer: sequential
    requests, an injected batch failure, a shed, a hot swap with its
    canary, then more requests. Returns the kept traces in order."""
    faultsmod.reset_plans()
    with cfgmod.set(obs_trace_sample=1.0, obs_shadow_fraction=1.0,
                    obs_drift_interval_s=0.0,
                    fault_plan="serving_execute:crash@3"):
        srv = pkg.ModelServer(est, ladder=_ladder(pkg), max_queue=2,
                              batch_window_ms=0.0, timeout_ms=0,
                              replica_id=0)
        srv.warmup()
        with srv:
            for i in range(6):
                try:
                    srv.submit(X[i:i + 1 + 3 * i]).result(WAIT)
                except pkg.ServingError:
                    assert i == 3
            srv.pause()
            held = [srv.submit(X[:4]) for _ in range(2)]
            with pytest.raises(pkg.ServerOverloaded):
                srv.submit(X[:4])
            srv.resume()
            for f in held:
                f.result(WAIT)
            srv.swap_model(est2)
            for i in range(3):
                srv.submit(X[i:i + 9]).result(WAIT)
    faultsmod.reset_plans()
    return rtmod.traces_data()


_TAGS = ("bucket", "flavor", "version", "replica", "canary_scored",
         "fault_injected", "rerouted_from", "slo_violation")


def _shape(trace):
    return (trace["method"], trace["n_rows"], trace["outcome"],
            sorted(trace["stages"]), {k: trace.get(k) for k in _TAGS})


def test_served_traces_match_jax(models):
    """One fitted model carried across, served by both packages under the
    same requests: the same traces, stage sets, tags and outcomes, in
    the same order, and the same per-stage histogram counts."""
    a, b, ta, tb, X = models
    want = _serve_script(JS, jconfig, jrtrace, jfaults, a, b, X)
    got = _serve_script(TS, config, rtrace, tfaults, ta, tb, X)
    assert got["counts"] == want["counts"]
    assert [_shape(t) for t in got["traces"]] == \
        [_shape(t) for t in want["traces"]]
    outcomes = [t["outcome"] for t in got["traces"]]
    assert outcomes.count("error") == 1 and outcomes.count("shed") == 1
    err = next(t for t in got["traces"] if t["outcome"] == "error")
    assert err["fault_injected"] is True
    assert got["traces"][-1]["canary_scored"] is True
    assert got["traces"][-1]["version"] == 1
    for t in got["traces"]:
        if t["outcome"] == "ok":
            assert set(t["stages"]) == set(rtrace.STAGES)
            order = [t["stages"][s] for s in rtrace.STAGES]
            assert order == sorted(order)
    assert {k: h["count"] for k, h in got["stage_histograms"].items()} == \
        {k: h["count"] for k, h in want["stage_histograms"].items()}


def test_sparse_lane_is_stamped_like_the_dense_one(models):
    import scipy.sparse as sp

    _, _, ta, _, X = models
    with config.set(obs_trace_sample=1.0):
        with TS.ModelServer(ta, ladder=_ladder(TS)) as srv:
            srv.submit(sp.csr_matrix(X[:5])).result(WAIT)
    (t,) = rtrace.traces_data()["traces"]
    assert t["method"] == "predict#sparse" and t["outcome"] == "ok"
    assert set(t["stages"]) == set(rtrace.STAGES) and t["bucket"] == 8


def test_knobs_off_allocate_nothing_and_answer_alike(models):
    """Trace, alert and incident knobs at their defaults and obs_drift
    off: no trace on any request, no engine, no monitor thread, and the
    answers bit-equal to those of a server with every knob on."""
    _, _, ta, _, X = models
    before = set(threading.enumerate())
    seen = []
    with config.set(obs_drift=False):
        srv = TS.ModelServer(ta, ladder=_ladder(TS), batch_window_ms=0.0)
        assert srv._trace_on is False and srv._drift_on is False
        orig = srv._admit

        def spy(reqs):
            out = orig(reqs)
            seen.extend(r.trace for r in reqs)
            return out

        srv._admit = spy
        with srv:
            off = [srv.submit(X[i:i + 7]).result(WAIT) for i in range(20)]
            assert alerts.engine() is None
            assert not drift.monitor_active()
            new = set(threading.enumerate()) - before
            assert {t.name for t in new} == {"dask-ml-tpu-torch-serving"}
    assert seen and all(t is None for t in seen)
    assert rtrace.traces_data()["counts"]["started"] == 0
    with config.set(obs_trace_sample=1.0, obs_drift_interval_s=5.0,
                    obs_alert_rules="drift_score_max:gauge>0.2",
                    obs_alert_interval_s=5.0):
        with TS.ModelServer(ta, ladder=_ladder(TS),
                            batch_window_ms=0.0) as srv:
            on = [srv.submit(X[i:i + 7]).result(WAIT) for i in range(20)]
            assert alerts.engine() is not None and drift.monitor_active()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the fleet ------------------------------------------------------------------

def test_fleet_reroute_and_slo_shed_traces(models):
    """A replica dying between the health check and the put reroutes the
    request, and the survivor's trace names the corpse; an SLO shed at
    the door leaves one kept slo_shed trace."""
    _, _, ta, _, X = models
    with config.set(obs_trace_sample=1.0):
        fleet = TS.FleetServer(ta, name="clf", replicas=2,
                               ladder=_ladder(TS)).warmup()
        with fleet:
            def dead(X, method="predict"):
                raise TS.ServerClosed("replica 0 died")

            fleet.replicas[0].submit = dead
            assert fleet.predict(X[:6]).shape == (6,)
    done = [t for t in rtrace.traces_data()["traces"]
            if t["outcome"] == "ok"]
    assert done[-1]["rerouted_from"] == 0 and done[-1]["replica"] == 1
    rtrace.traces_reset()
    from dask_ml_tpu_torch.serving._batching import Request

    with config.set(obs_trace_sample=1.0, serving_slo_ms=30.0):
        fleet = TS.FleetServer(ta, name="clf", replicas=1,
                               ladder=_ladder(TS), timeout_ms=0).warmup()
        with fleet:
            r = fleet.replicas[0]
            r.pause()
            for _ in range(13):
                r._exec.observe("predict", 64, 0.5)
            for _ in range(8):
                r._queue.put_many([Request(X[:60], "predict")])
            with pytest.raises(TS.SloShed):
                fleet.submit(X[:60])
            r._queue.drain_all()
            r.resume()
    shed = [t for t in rtrace.traces_data()["traces"]
            if t["outcome"] == "slo_shed"]
    assert len(shed) == 1 and shed[0]["slo_shed"] is True


def test_supervisor_requeue_tags_the_traces(models):
    from dask_ml_tpu_torch.reliability.supervisor import ReplicaSupervisor
    from dask_ml_tpu_torch.serving._batching import Request

    _, _, ta, _, X = models
    with config.set(obs_trace_sample=1.0):
        fleet = TS.FleetServer(ta, name="clf", replicas=2,
                               ladder=_ladder(TS))
        dead, fresh = fleet.replicas
        reqs = [Request(X[:3], "predict") for _ in range(2)]
        for r in reqs:
            r.trace = rtrace.new_trace("predict", 3)
        dead._queue.put_many(reqs)
        ReplicaSupervisor(fleet)._requeue(dead, fresh)
    assert all(r.trace.tags["rerouted_from"] == dead.replica_id
               and r.trace.tags["replica"] == fresh.replica_id
               for r in reqs)
    assert fresh._queue.depth == 2


# -- capture and replay -------------------------------------------------------

def test_capture_replays_through_the_load_test(models, tmp_path):
    """The servers' req_capture records read back by load_capture (the
    same records JAX's reader reads) and replayed by the load test."""
    _, _, ta, _, X = models
    with config.set(obs_trace_sample=1.0, trace_dir=str(tmp_path)):
        with TS.ModelServer(ta, ladder=_ladder(TS)) as srv:
            for n in (1, 5, 9, 3):
                srv.submit(X[:n]).result(WAIT)
    path = str(tmp_path / "trace.jsonl")
    recs = rtrace.load_capture(path)
    assert [r["n_rows"] for r in recs] == [1, 5, 9, 3]
    assert recs == jrtrace.load_capture(path)
    assert loadtest.load_capture is rtrace.load_capture
    mix = rtrace.replay(recs, lambda m, n: None, speed=1e6)
    assert mix["requests"] == 4 and mix["rows"] == 18
    with config.set(obs_trace_sample=0.0):
        with TS.ModelServer(ta, ladder=_ladder(TS)) as srv:
            out = loadtest.replay_load_test(srv, X, capture_path=path,
                                            speed=1e6)
    assert out["ok"] == 4 and out["passed"]
