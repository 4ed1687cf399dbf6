"""The port's fleet-scope observability (``observability/fleet.py``, the
fleet providers of ``observability/live.py`` and the trace continuation
of ``serving/federation.py``) against dask_ml_tpu's, on the CPU.

The tests of ``tests/test_fleet_observability.py`` that
``test_torch_request_traces.py``, ``test_torch_serving.py`` and
``test_torch_live_telemetry.py`` do not cover run here on the port: a federated request is one trace
across the process boundary (router and worker share the router's id,
a reroute chains through it with ``rerouted_from_process``), histograms
merge bucket for bucket, the federator shares the poller's one scrape,
a dead process's series drop, the exposition keeps one TYPE line a
family, the SLO burn latches its alert, ``/status/fleet`` serves the
block, and federation off builds nothing and starts no thread. The same
list of status documents ingested by both packages' MetricsFederator
gives equal exposition text, an equal fleet block and the same
``builtin:fleet_slo_burn`` transitions. One test starts two real child
interpreters serving over HTTP on the CPU: a trace joins across the
process boundary, then a SIGKILLed child fails over with no request lost.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.observability import _hist as jhist
from dask_ml_tpu.observability import alerts as jalerts
from dask_ml_tpu.observability import export as jexport
from dask_ml_tpu.observability import fleet as jfleet
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch.observability import _requests as rtrace
from dask_ml_tpu_torch.observability import alerts, export, fleet, live, \
    report
from dask_ml_tpu_torch.observability._hist import (
    Histogram,
    merge_snapshots,
    percentiles_from,
)
from dask_ml_tpu_torch.observability.fleet import MetricsFederator
from dask_ml_tpu_torch.serving import (
    BucketLadder,
    FederatedFleet,
    FleetServer,
    HttpEndpoint,
    LocalEndpoint,
    ProcessDown,
)
from dask_ml_tpu_torch.serving.federation import FleetEndpoint

WAIT = 30.0          # seconds any single future, join or call may take
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every block in fresh buffers
    (see tests/test_torch_sgd.py): jax's CPU backend aliases 64-byte
    aligned numpy arrays."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _isolation():
    rtrace.traces_reset()
    with config.set(device="cpu"):
        yield
    rtrace.traces_reset()


@pytest.fixture(scope="module")
def fitted():
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    rng = np.random.RandomState(0)
    X = rng.randn(400, 10).astype(np.float32)
    y = (X @ rng.randn(10) > 0).astype(np.float32)
    with config.set(device="cpu"):
        clf = LogisticRegression(solver="lbfgs", max_iter=25).fit(X, y)
    return clf, X


def _ladder():
    return BucketLadder(8, 64, 2.0)


def _pair(clf, name="fobs"):
    fleets = [FleetServer(clf, name=name, replicas=1, ladder=_ladder(),
                          batch_window_ms=1.0).warmup().start()
              for _ in range(2)]
    fed = FederatedFleet(
        [LocalEndpoint(f, f"p{i}") for i, f in enumerate(fleets)],
        name=name, ladder=_ladder()).start()
    return fleets[0], fleets[1], fed


def _get(url, timeout=WAIT):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


# -- trace continuation --------------------------------------------------------

def test_trace_context_nests_and_is_thread_local():
    """A nested trace_context restores the outer id; rank threads never
    see each other's continuation ids."""
    from dask_ml_tpu_torch.parallel.distributed import run_virtual_processes

    with rtrace.trace_context(424242):
        with rtrace.trace_context(777):
            assert rtrace.RequestTrace("predict", 1).trace_id == 777
        assert rtrace.RequestTrace("predict", 1).trace_id == 424242

    def rank_trace(rank):
        with rtrace.trace_context(1000 + rank):
            return rtrace.RequestTrace("predict", 1).trace_id

    assert run_virtual_processes(rank_trace, world=2) == [1000, 1001]
    assert rtrace._pending_ctx() is None


def test_local_endpoint_joins_router_and_worker_traces(fitted):
    """A federated request is one trace: the router's record (admit,
    dispatch, complete, the chosen process) and the worker fleet's
    full-stage record share the router's id, and the worker's window
    lies inside the router's."""
    clf, X = fitted
    with config.set(obs_trace_sample=1.0):
        f1, f2, fed = _pair(clf)
        try:
            fed.predict(X[:8])
        finally:
            fed.stop()
            f1.stop(drain=False)
            f2.stop(drain=False)
    recs = rtrace.traces_data()["traces"]
    router = [r for r in recs if r.get("federation") == "fobs"]
    assert len(router) == 1, recs
    rt = router[0]
    assert rt["outcome"] == "ok" and rt.get("process") in ("p0", "p1")
    assert set(rt["stages"]) >= {"admit", "dispatch", "complete"}
    workers = [r for r in recs if r["trace_id"] == rt["trace_id"]
               and r.get("federation") != "fobs"]
    assert len(workers) == 1, recs
    wk = workers[0]
    assert set(wk["stages"]) >= {"admit", "queue_pop", "complete"}
    assert sum(wk["durations"].values()) == pytest.approx(
        wk["e2e_s"], abs=5e-5)
    assert wk["e2e_s"] <= rt["e2e_s"] + 1e-4


def test_trace_propagate_toggle_mints_fresh_worker_ids(fitted):
    """obs_trace_propagate=False keeps the traces but not the join:
    router and worker record different ids."""
    clf, X = fitted
    with config.set(obs_trace_sample=1.0, obs_trace_propagate=False):
        f1, f2, fed = _pair(clf, name="fobs-off")
        try:
            fed.predict(X[:8])
        finally:
            fed.stop()
            f1.stop(drain=False)
            f2.stop(drain=False)
    recs = rtrace.traces_data()["traces"]
    assert len(recs) == 2, recs
    assert len({r["trace_id"] for r in recs}) == 2


def test_http_endpoint_continues_trace_over_wire(fitted):
    """X-Trace-Context over a real HTTP hop: the receiving handler
    continues the router's id around its fleet submit."""
    clf, X = fitted
    ts = live.TelemetryServer(port=0).start()
    with config.set(obs_trace_sample=1.0):
        fleet = FleetServer(clf, name="fobs-http", replicas=1,
                            ladder=_ladder(), batch_window_ms=1.0) \
            .warmup().start()
        try:
            ep = HttpEndpoint(ts.url, name="fobs-http", process_id="h0",
                              timeout_s=WAIT)
            with FederatedFleet([ep], name="fobs-http",
                                ladder=_ladder()) as fed:
                fed.predict(X[:8])
        finally:
            fleet.stop()
            ts.stop()
    recs = rtrace.traces_data()["traces"]
    router = [r for r in recs if r.get("federation") == "fobs-http"]
    assert len(router) == 1, recs
    workers = [r for r in recs if r["trace_id"] == router[0]["trace_id"]
               and r.get("federation") != "fobs-http"]
    assert len(workers) == 1 and "queue_pop" in workers[0]["stages"]


class _DyingEndpoint(FleetEndpoint):
    """Ranks first as a live, instant process and dies on every
    submit."""

    def __init__(self, process_id, fleet_name):
        self.process_id = str(process_id)
        self.fleet_name = str(fleet_name)

    def status(self):
        return {"fleet": self.fleet_name, "queue_rows": 0,
                "replicas": [{"exec_s": {"predict:64": {
                    "count": 50, "p50_s": 1e-6, "p90_s": 1e-6}}}],
                "healthy_replicas": 1}

    def status_doc(self):
        return {"serving": [self.status()], "counters": {},
                "telemetry": {"gauges": [], "histograms": []}}

    def submit(self, X, method="predict", rerouted_from=None,
               trace_ctx=None):
        raise ProcessDown(f"{self.process_id}: killed mid-flight")


def test_killed_process_reroute_chains_parent_trace(fitted):
    """A process dying mid-flight leaves one joined trace: the router's
    record names the dead process, and the survivor's record continues
    the same id with the same tag."""
    clf, X = fitted
    with config.set(obs_trace_sample=1.0):
        f1 = FleetServer(clf, name="fobs-kill", replicas=1,
                         ladder=_ladder(), batch_window_ms=1.0) \
            .warmup().start()
        try:
            with FederatedFleet(
                    [_DyingEndpoint("corpse", "fobs-kill"),
                     LocalEndpoint(f1, "survivor")],
                    name="fobs-kill", ladder=_ladder()) as fed:
                assert fed.predict(X[:8]).shape[0] == 8
        finally:
            f1.stop(drain=False)
    recs = rtrace.traces_data()["traces"]
    router = [r for r in recs if r.get("federation") == "fobs-kill"]
    assert len(router) == 1, recs
    rt = router[0]
    assert rt["outcome"] == "ok"
    assert rt.get("rerouted_from_process") == "corpse"
    assert rt.get("process") == "survivor"
    legs = [r for r in recs if r["trace_id"] == rt["trace_id"]
            and r.get("federation") != "fobs-kill"]
    assert len(legs) == 1 and legs[0]["rerouted_from_process"] == "corpse"


# -- histogram merge -------------------------------------------------------------

def test_histogram_merge_exact_sums():
    """An object and a snapshot merge bucket for bucket into the pooled
    counts, as dask_ml_tpu's Histogram merges them."""
    parts = ((1e-4, 0.003, 0.02, 0.7), (0.005, 5.0))
    snaps = []
    for mod in (obs._hist, jhist):
        a, b = mod.Histogram(), mod.Histogram()
        for v in parts[0]:
            a.observe(v)
        for v in parts[1]:
            b.observe(v)
        m = mod.Histogram().merge(a).merge(b.snapshot())
        assert m.count == 6 and m.sum == pytest.approx(a.sum + b.sum)
        snaps.append(m.snapshot())
    pooled = Histogram()
    for v in parts[0] + parts[1]:
        pooled.observe(v)
    assert snaps[0]["counts"] == pooled.snapshot()["counts"]
    assert snaps[0]["min"] == pytest.approx(1e-4)
    assert snaps[0]["max"] == pytest.approx(5.0)
    assert snaps[0] == snaps[1]


def test_histogram_merge_bounds_mismatch_raises():
    a = Histogram((0.1, 1.0))
    with pytest.raises(ValueError):
        a.merge(Histogram((0.1, 2.0)))
    with pytest.raises(ValueError):
        a.merge(Histogram())


@pytest.mark.parametrize("seed", range(3))
def test_merged_percentiles_match_pooled_within_bucket_width(seed):
    """Observations split over three processes: the merged counts equal
    the pooled histogram's and dask_ml_tpu's merge, the merged quantiles
    equal the pooled ones, and both sit within one 1-2-5 bucket width
    (a factor of 2.5) of the sample quantile."""
    rng = np.random.default_rng(7 + seed)
    obs_ = rng.lognormal(mean=-4.0, sigma=1.5, size=300)
    snaps, pooled = [], Histogram()
    for part in np.array_split(obs_, 3):
        h = Histogram()
        for v in part:
            h.observe(float(v))
            pooled.observe(float(v))
        snaps.append(h.snapshot())
    merged = merge_snapshots(snaps)
    assert merged == jhist.merge_snapshots(snaps)
    assert merged["counts"] == pooled.snapshot()["counts"]
    mp, pp = percentiles_from(merged, (50, 99)), pooled.percentiles((50, 99))
    for q in ("p50", "p99"):
        assert mp[q] == pytest.approx(pp[q])
        exact = float(np.percentile(obs_, int(q[1:])))
        assert exact / 2.5 - 1e-12 <= mp[q] <= exact * 2.5 + 1e-12


def test_merge_snapshots_none_tolerant_and_empty():
    assert merge_snapshots([]) is None
    assert merge_snapshots([None, None]) is None
    h = Histogram()
    h.observe(0.01)
    assert merge_snapshots([None, h.snapshot(), None])["count"] == 1


# -- the federator ---------------------------------------------------------------

def _doc(requests=0, violations=0, queue=0.0, obs_=(), hist=Histogram):
    h = hist()
    for v in obs_:
        h.observe(v)
    snap = h.snapshot()
    snap["bounds"] = list(snap["bounds"])
    return {
        "counters": {"serving_requests": requests,
                     "serving_slo_violations": violations},
        "telemetry": {
            "gauges": [["serving_queue_rows", [], float(queue)]],
            "histograms": [["serving_latency_seconds",
                            [["method", "predict"]], snap]],
        },
    }


def test_federator_counters_sum_gauges_labeled_hists_merge():
    fed = MetricsFederator(name="m")
    assert fed.ingest([("p0", _doc(10, 1, 3.0, (0.01, 0.02))),
                       ("p1", _doc(5, 0, 1.0, (0.5,)))], scrape_s=0.002)
    txt = "\n".join(fed.render_lines())
    assert "dask_ml_tpu_fleet_serving_requests_total 15" in txt
    assert "dask_ml_tpu_fleet_serving_slo_violations_total 1" in txt
    assert 'dask_ml_tpu_fleet_serving_queue_rows{process="p0"} 3' in txt
    assert 'dask_ml_tpu_fleet_serving_queue_rows{process="p1"} 1' in txt
    assert ('dask_ml_tpu_fleet_serving_latency_seconds_count'
            '{method="predict"} 3') in txt
    blk = fed.fleet_block()
    assert blk["n_scraped"] == 2 and blk["processes"] == ["p0", "p1"]
    assert blk["histograms"][
        'serving_latency_seconds{method="predict"}']["count"] == 3
    assert blk["scrape_seconds"] == pytest.approx(0.002)


def test_federator_dead_series_dropped_not_latched():
    fed = MetricsFederator(name="m")
    fed.ingest([("p0", _doc(1, queue=2.0)), ("p1", _doc(1, queue=5.0))])
    assert 'process="p1"' in "\n".join(fed.render_lines())
    fed.ingest([("p0", _doc(2, queue=2.0)), ("p1", None)])
    assert 'process="p1"' not in "\n".join(fed.render_lines())
    assert fed.fleet_block()["processes"] == ["p0"]
    # a process missing from the list entirely (a retired endpoint)
    fed.ingest([("p1", _doc(9, queue=1.0))])
    assert fed.fleet_block()["processes"] == ["p1"]


def test_federator_throttle_still_drops_dead():
    fed = MetricsFederator(name="m", min_interval_s=3600.0)
    assert fed.ingest([("p0", _doc(1)), ("p1", _doc(1))])
    assert fed.ingest([("p0", _doc(2)), ("p1", None)]) is False
    assert fed.fleet_block()["processes"] == ["p0"]


def _types_of(page):
    types = {}
    for ln in page.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split()
            assert fam not in types, f"duplicate TYPE for {fam}"
            types[fam] = kind
    for ln in page.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name = ln.split("{")[0].split(" ")[0]
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                fam = name[:-len(suffix)]
                break
        assert fam in types, f"sample {name} has no TYPE line"
    return types


def test_federated_exposition_grammar_one_type_per_family():
    """The router's whole /metrics page with a federator registered:
    every sample under a declared family, no TYPE twice, every fleet
    family namespaced; a provider that raises does not fail it."""
    class Broken:
        def render_lines(self):
            raise RuntimeError("provider down")

        def fleet_block(self):
            raise RuntimeError("provider down")

    fed = MetricsFederator(name="m")
    fed.ingest([("p0", _doc(10, 1, 3.0, (0.01,))),
                ("p1", _doc(5, 0, 1.0, (0.5,)))], scrape_s=0.001)
    broken = Broken()
    live.register_fleet_provider(broken)
    live.register_fleet_provider(fed)
    try:
        page = live.render_prometheus()
        block = live.fleet_status_data()
    finally:
        live.unregister_fleet_provider(fed)
        live.unregister_fleet_provider(broken)
    types = _types_of(page)
    assert types["dask_ml_tpu_fleet_serving_requests_total"] == "counter"
    assert types["dask_ml_tpu_fleet_processes"] == "gauge"
    assert types["dask_ml_tpu_fleet_serving_latency_seconds"] == "histogram"
    assert block["n_scraped"] == 2
    assert "dask_ml_tpu_fleet_" not in live.render_prometheus()


def test_slo_burn_rate_latches_alerts():
    """A window burning past the budget latches an alert that outlives
    the burn; the burn gauge recovers."""
    fed = MetricsFederator(name="m", slo_ms=50.0)
    fed.ingest([("p0", _doc(100, 0))])
    assert fed.fleet_block()["slo"]["burn_rate"] == 0.0
    fed.ingest([("p0", _doc(200, 10))])
    blk = fed.fleet_block()["slo"]
    assert blk["burn_rate"] == pytest.approx(10.0)
    assert len(blk["alerts"]) == 1 and blk["alerts"][0]["violations"] == 10
    fed.ingest([("p0", _doc(300, 10))])
    blk = fed.fleet_block()["slo"]
    assert blk["burn_rate"] == 0.0 and len(blk["alerts"]) == 1
    alerts.reset()


def _rounds(seed):
    """A seeded list of poll rounds over three processes: growing
    counters with violation bursts, labeled gauges, histograms (one
    process on another ladder now and then), deaths and returns."""
    rng = np.random.RandomState(seed)
    totals = {p: [0, 0] for p in ("p0", "p1", "p2")}
    rounds = []
    for k in range(8):
        snaps = []
        for p in totals:
            if rng.rand() < 0.2:
                snaps.append((p, None))
                continue
            n = int(rng.randint(20, 200))
            totals[p][0] += n
            totals[p][1] += int(rng.binomial(n, rng.choice([0.0, 0.05])))
            h = Histogram((0.01, 0.1, 1.0)) if rng.rand() < 0.15 \
                else Histogram()
            for v in rng.lognormal(-5.0, 1.0, size=int(rng.randint(0, 30))):
                h.observe(float(v))
            snap = h.snapshot()
            snap["bounds"] = list(snap["bounds"])
            snaps.append((p, {
                "counters": {"serving_requests": totals[p][0],
                             "serving_slo_violations": totals[p][1],
                             "serving_rows": 8 * totals[p][0],
                             "flag": True},
                "telemetry": {
                    "gauges": [
                        ["serving_queue_depth", [["replica", "0"]],
                         float(rng.randint(0, 9))],
                        ["serving_process_healthy", [], 1.0],
                        ["serving_latency_seconds", [], 0.5]],
                    "histograms": [
                        ["serving_latency_seconds",
                         [["method", "predict"], ["bucket", "8"]], snap]],
                },
            }))
        rounds.append((snaps, 0.001 * (k + 1)))
    return rounds


def _strip(x):
    """The federator's outputs without their wall-clock stamps."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("t_unix", "t_scrape_unix")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


@pytest.mark.parametrize("seed", range(3))
def test_federator_matches_jax(seed):
    """The same poll rounds ingested by both packages' MetricsFederator
    (the alert engines armed with the built-ins): equal exposition text
    and fleet block after every round, and the same
    builtin:fleet_slo_burn transitions."""
    outs = []
    for mod, cfgmod, alertmod in ((fleet, config, alerts),
                                  (jfleet, jconfig, jalerts)):
        alertmod.reset()
        with cfgmod.set(obs_alert_rules="builtin",
                        obs_alert_interval_s=3600.0):
            eng = alertmod.ensure_engine()
        fed = mod.MetricsFederator(name="m", slo_ms=20.0)
        seen = []
        try:
            for snaps, scrape_s in _rounds(seed):
                fed.ingest(snaps, scrape_s=scrape_s)
                seen.append(("\n".join(fed.render_lines()),
                             _strip(fed.fleet_block())))
            # the event rule resolves once its event ages out
            eng.tick(now=time.time() + 4 * 3600.0)
            trans = [(t["rule"], t["state"], t.get("burn_rate"))
                     for t in eng.data()["transitions"]
                     if t["rule"] == "builtin:fleet_slo_burn"]
        finally:
            alertmod.reset()
        outs.append((seen, trans))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
    assert [t[1] for t in outs[0][1]][-2:] == ["firing", "resolved"]


def test_status_fleet_http_surface():
    """/status/fleet serves the registered federator's block and /status
    embeds it under "fleet"; without one, {} and no key."""
    ts = live.TelemetryServer(port=0).start()
    try:
        assert json.loads(_get(f"{ts.url}/status/fleet")) == {}
        assert "fleet" not in json.loads(_get(f"{ts.url}/status"))
        fed = MetricsFederator(name="m")
        fed.ingest([("p0", _doc(3))])
        live.register_fleet_provider(fed)
        try:
            doc = json.loads(_get(f"{ts.url}/status/fleet"))
            assert doc["n_scraped"] == 1
            assert doc["counters"]["serving_requests"] == 3
            assert json.loads(_get(f"{ts.url}/status"))["fleet"][
                "n_scraped"] == 1
        finally:
            live.unregister_fleet_provider(fed)
    finally:
        ts.stop()


def test_metrics_reset_clears_the_providers():
    fed = MetricsFederator(name="m")
    live.register_fleet_provider(fed)
    live.metrics_reset()
    assert live.fleet_status_data() == {}


# -- one scrape feeds routing and the federator -------------------------------------

class _CountingEndpoint(FleetEndpoint):
    def __init__(self, process_id):
        self.process_id = str(process_id)
        self.doc_calls = 0
        self.status_calls = 0

    def status_doc(self):
        self.doc_calls += 1
        return {"serving": [{"fleet": "cnt", "queue_rows": 0,
                             "replicas": [], "healthy_replicas": 1}],
                "counters": {"serving_requests": 7,
                             "serving_slo_violations": 0},
                "telemetry": {"gauges": [], "histograms": []}}

    def status(self):
        self.status_calls += 1
        return self.status_doc()["serving"][0]


def test_poller_single_scrape_feeds_routing_and_federator():
    ep = _CountingEndpoint("p0")
    with config.set(obs_fleet_federate=True):
        fed = FederatedFleet([ep], name="cnt", ladder=_ladder())
    assert fed._federator is not None
    fed._poll_once()
    assert ep.doc_calls == 1 and ep.status_calls == 0
    assert fed._federator.fleet_block()["counters"]["serving_requests"] == 7
    fed._poll_once()
    assert ep.doc_calls == 2


# -- the zero-cost default -----------------------------------------------------------

def test_federation_off_by_default_builds_nothing(fitted):
    clf, _ = fitted
    before = live.render_prometheus()
    f1 = FleetServer(clf, name="fobs-zero", replicas=1, ladder=_ladder(),
                     batch_window_ms=1.0).start()
    try:
        fed = FederatedFleet([LocalEndpoint(f1, "p0")], name="fobs-zero",
                             ladder=_ladder())
        assert fed._federator is None
        with fed:
            assert not live._fleet_providers
            assert "fleet_" not in live.render_prometheus()
    finally:
        f1.stop(drain=False)
    assert "dask_ml_tpu_fleet_" not in before


def test_federator_rides_poller_no_new_threads(fitted):
    """Federation on adds no thread besides the poller and submit pool
    the router owns."""
    clf, _ = fitted
    f1 = FleetServer(clf, name="fobs-thr", replicas=1, ladder=_ladder(),
                     batch_window_ms=1.0).start()
    try:
        with config.set(obs_fleet_federate=True):
            fed = FederatedFleet([LocalEndpoint(f1, "p0")],
                                 name="fobs-thr", ladder=_ladder())
        before = set(threading.enumerate())
        with fed:
            new = {t.name for t in set(threading.enumerate()) - before}
            assert all(n.startswith(("fed-poller", "fed-submit"))
                       for n in new), new
            assert fed._federator in live._fleet_providers
        assert fed._federator not in live._fleet_providers
    finally:
        f1.stop(drain=False)


# -- the Perfetto flow chain and report --watch -------------------------------------

def test_export_flow_chain_joins_processes():
    """Three legs of one trace over two pids chain as s -> t -> f flow
    events on pid lanes, as dask_ml_tpu's export draws them."""
    rid = (77 << 24) | 5
    records = [
        {"req_trace": True, "trace_id": rid, "pid": 77,
         "method": "predict", "n_rows": 8, "t_unix": 100.0,
         "e2e_s": 0.05, "outcome": "ok",
         "stages": {"admit": 0.0, "dispatch": 0.001, "complete": 0.05},
         "durations": {}, "threads": {"admit": "MainThread"}},
        {"req_trace": True, "trace_id": rid, "pid": 99,
         "method": "predict", "n_rows": 8, "t_unix": 100.002,
         "e2e_s": 0.04, "outcome": "ok", "rerouted_from_process": "p0",
         "stages": {"admit": 0.0, "queue_pop": 0.001, "pack": 0.002,
                    "dispatch": 0.003, "execute_done": 0.03,
                    "demux": 0.035, "complete": 0.04},
         "durations": {}, "threads": {"admit": "http", "worker": "w0"}},
        {"req_trace": True, "trace_id": (77 << 24) | 9, "pid": 77,
         "method": "predict", "n_rows": 1, "t_unix": 101.0,
         "e2e_s": 0.01, "outcome": "ok",
         "stages": {"admit": 0.0, "complete": 0.01},
         "durations": {}, "threads": {"admit": "MainThread"}},
    ]
    trace = export.to_chrome_trace(records)
    assert trace == jexport.to_chrome_trace(records)
    flows = [e for e in trace["traceEvents"]
             if e.get("cat") == "request" and e["ph"] in "stf"
             and e["id"] == rid]
    phases = [e["ph"] for e in flows]
    assert phases.count("s") == 1 and phases.count("f") == 1
    assert phases.count("t") == 2 and phases[0] == "s"
    assert flows[-1]["ph"] == "f" and flows[-1]["bp"] == "e"
    lanes = [e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"]
    assert any(v.startswith("pid77.") for v in lanes)
    assert any(v.startswith("pid99.") for v in lanes)
    other = [e["ph"] for e in trace["traceEvents"]
             if e.get("cat") == "request" and e.get("ph") in "stf"
             and e.get("id") == ((77 << 24) | 9)]
    assert other == ["s", "f"]


def test_report_watch_once_renders_the_fleet_block(capsys):
    fed = MetricsFederator(name="m")
    fed.ingest([("p0", _doc(3, 1))])
    live.register_fleet_provider(fed)
    ts = live.TelemetryServer(port=0).start()
    try:
        rc = report.main(["--watch", ts.url, "--once"])
    finally:
        ts.stop()
        live.unregister_fleet_provider(fed)
    out = capsys.readouterr().out
    assert rc == 0
    assert f"live: {ts.url}" in out and "fleet federation" in out
    assert "run report:" in out and "\x1b[2J" not in out


def test_report_watch_once_unreachable_is_nonzero(capsys):
    rc = report.main(["--watch", "http://127.0.0.1:9", "--once",
                      "--interval", "0.2"])
    assert rc == 1
    assert "unreachable" in capsys.readouterr().out


# -- a real process boundary ---------------------------------------------------------

_CHILD = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.observability.live import TelemetryServer
from dask_ml_tpu_torch.serving import BucketLadder, FleetServer
port_path, stop_path = sys.argv[1], sys.argv[2]
# each process owns its trace knob; the router's id joins them
with config.set(device="cpu", obs_trace_sample=1.0):
    rng = np.random.RandomState(0)
    X = rng.randn(400, 10).astype(np.float32)
    y = (X @ rng.randn(10) > 0).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=25).fit(X, y)
    fleet = FleetServer(clf, name="fedproc", replicas=1,
                        ladder=BucketLadder(8, 64, 2.0),
                        batch_window_ms=1.0).warmup().start()
    ts = TelemetryServer(port=0).start()
    with open(port_path + ".tmp", "w") as f:
        f.write(str(ts.port))
    os.replace(port_path + ".tmp", port_path)
    deadline = time.monotonic() + 110.0
    while not os.path.exists(stop_path) and time.monotonic() < deadline:
        time.sleep(0.05)
    ts.stop()
    fleet.stop(drain=False)
"""


def test_trace_join_and_sigkill_failover_across_real_processes(
        fitted, tmp_path):
    """Two child interpreters each serve the fleet behind their exporter.
    The router publishes a fit of other labels to both over the wire; a routed
    request's trace id appears in the chosen child's /traces with the
    worker stages, under the child's pid; then a child is SIGKILLed
    while four clients stream requests and it holds some of them in
    flight, and every request is
    answered with the published model's labels: none lost, one failover,
    at least one reroute. Everything runs under a 120 s limit."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    t_end = time.monotonic() + 120.0
    clf, X = fitted               # the fit each child makes for itself
    y_pub = (X @ np.random.RandomState(5).randn(10) > 0).astype(np.float32)
    pub = LogisticRegression(solver="lbfgs", max_iter=25).fit(X, y_pub)
    assert not np.array_equal(pub.predict(X), clf.predict(X))
    stop_path = str(tmp_path / "stop")
    procs, ports, logs = [], [], []
    try:
        for i in range(2):
            logs.append(open(tmp_path / f"child{i}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD.format(repo=REPO),
                 str(tmp_path / f"port{i}"), stop_path],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for i, p in enumerate(procs):
            path = tmp_path / f"port{i}"
            while not path.exists():
                if p.poll() is not None or time.monotonic() > t_end:
                    raise AssertionError(
                        f"child {i} never came up: {p.poll()}\n"
                        + (tmp_path / f"child{i}.log").read_text()[-2000:])
                time.sleep(0.05)
            ports.append(int(path.read_text()))
        urls = [f"http://127.0.0.1:{port}" for port in ports]
        eps = [HttpEndpoint(u, name="fedproc", process_id=f"c{i}",
                            timeout_s=WAIT) for i, u in enumerate(urls)]
        before = obs.counters_snapshot()
        # a long poll period: routing reads the start() poll (both cold)
        # and the rows in flight, and only a failed request marks c0 dead
        with config.set(obs_trace_sample=1.0):
            with FederatedFleet(eps, name="fedproc", ladder=_ladder(),
                                poll_s=60.0) as fed:
                # version 1 is the model the children were born with; a
                # pinned version 1 would not swap them
                fed.publish(clf)
                fed.publish(pub)
                out = fed.predict(X[:8])
                np.testing.assert_array_equal(out, pub.predict(X[:8]))
                router = [r for r in rtrace.traces_data()["traces"]
                          if r.get("federation") == "fedproc"]
                assert len(router) == 1, router
                rt = router[0]
                chosen = int(rt["process"][1:])
                legs = [t for t in json.loads(
                    _get(f"{urls[chosen]}/traces"))["traces"]
                    if t["trace_id"] == rt["trace_id"]]
                assert len(legs) == 1, legs
                assert set(legs[0]["stages"]) >= {"admit", "queue_pop",
                                                  "complete"}
                assert legs[0]["pid"] == procs[chosen].pid != os.getpid()

                answers, errors = {}, []
                n_req, answered = 48, threading.Semaphore(0)

                def client(c):
                    for k in range(c, n_req, 4):
                        try:
                            answers[k] = fed.predict(X[k:k + 5])
                        except Exception as exc:  # reported below
                            errors.append(repr(exc))
                        answered.release()

                threads = [threading.Thread(
                    target=config.in_caller_config(client), args=(c,))
                    for c in range(4)]
                for t in threads:
                    t.start()
                for _ in range(8):
                    assert answered.acquire(timeout=WAIT)
                # killed while it holds requests of the router in flight
                while fed._procs[0].inflight_rows == 0:
                    assert time.monotonic() < t_end, "c0 took no request"
                    time.sleep(0.0005)
                procs[0].send_signal(signal.SIGKILL)
                for t in threads:
                    t.join(max(t_end - time.monotonic(), 1.0))
                assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert sorted(answers) == list(range(n_req))
        for k, got in answers.items():
            np.testing.assert_array_equal(got, pub.predict(X[k:k + 5]))
        after = obs.counters_snapshot()
        assert after.get("serving_process_failovers", 0) \
            - before.get("serving_process_failovers", 0) == 1
        assert after.get("serving_process_reroutes", 0) \
            > before.get("serving_process_reroutes", 0)
        hops = [r for r in rtrace.traces_data()["traces"]
                if r.get("rerouted_from_process") == "c0"]
        assert hops and all(r["outcome"] == "ok" for r in hops)
        assert procs[0].wait(timeout=10) == -signal.SIGKILL
    finally:
        open(stop_path, "w").close()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for f in logs:
            f.close()
