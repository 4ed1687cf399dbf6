"""The port's alert engine (``observability/alerts.py``) and incident
plane (``observability/incidents.py``) against dask_ml_tpu's, on the
CPU: the rule grammar and its refusals, one scripted tick sequence
through both engines (``tick(now=...)``, no ticker), the event rules fed
by drift, the watchdog, a failed serving batch and a stream's exhausted
retries, the bundles (contents, rate limit, retention, atomic write),
``report --incidents`` on bundles JAX wrote, and ``deep_profile`` on the
CPU. No sleep is longer than 0.2 s."""

import json
import os
import time

import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.observability import _counters as jcounters
from dask_ml_tpu.observability import alerts as jalerts
from dask_ml_tpu.observability import incidents as jincidents
from dask_ml_tpu.observability import live as jlive
from dask_ml_tpu.observability import report as jreport
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch.observability import _counters, alerts, drift, \
    incidents, live, report
from dask_ml_tpu_torch.reliability import faults

WAIT = 30.0


def _reset():
    for m in (alerts, jalerts):
        m.reset()
    for m in (incidents, jincidents):
        m.reset()
    for m in (_counters, jcounters):
        m.counters_reset()
    for m in (live, jlive):
        m.metrics_reset()
    drift.reset()
    faults.reset_plans()


@pytest.fixture(autouse=True)
def _clean():
    # the planes are process-wide: another file's servers and watchdogs
    # may have left events, counters or a monitor behind
    _reset()
    with config.set(device="cpu"):
        yield
    _reset()


# -- the rule grammar -----------------------------------------------------------

_SPECS = [
    "serving_slo_violations:rate>5/60s, drift_score_max:gauge>0.2;"
    "fit_eta_seconds:gauge>1800, boom:counter>=10",
    "a:gauge<=-1e-3; b:rate>=0.5/2.5s",
    "",
    " builtin , ",
]
_BAD = ["nocolon", "x:bogus>1", "x:rate>1", "x:gauge>1/30s", "x:rate>1/0s",
        "x:gauge!1", "x:gauge>abc"]


def _rule_tuple(r):
    return (r.name, r.metric, r.kind, r.op, r.threshold, r.window_s)


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_rules_matches_jax(spec):
    assert [_rule_tuple(r) for r in alerts.parse_rules(spec)] == \
        [_rule_tuple(r) for r in jalerts.parse_rules(spec)]


@pytest.mark.parametrize("bad", _BAD)
def test_bad_rules_refuse_as_jax(bad):
    with pytest.raises(alerts.AlertRuleError) as got:
        alerts.parse_rules(bad)
    with pytest.raises(jalerts.AlertRuleError) as want:
        jalerts.parse_rules(bad)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_builtin_rules_swap_recompiles_for_graph_captures():
    got = [_rule_tuple(r) for r in alerts._builtin_rules()]
    want = [_rule_tuple(r) for r in jalerts._builtin_rules()]
    assert got[1] == ("builtin:graph_captures", "graph_captures", "rate",
                      ">", 0.0, 60.0)
    assert want[1][:2] == ("builtin:recompiles", "recompiles")
    assert got[:1] + got[2:] == want[:1] + want[2:]


# -- one tick sequence through both engines ------------------------------------

_SCRIPT = [
    # (dt, counter adds, gauge sets)
    (0, {"ev": 100}, {}),
    (1, {}, {"g": 0.9}),
    (1, {"ev": 5}, {"g": 0.1}),
    (1, {}, {"g": 0.1, "h": -2.0}),
    (1, {"boom": 3}, {"h": 1.0}),
    (12, {}, {}),
    (1, {"ev": 1}, {"g": 0.6}),
    (1, {}, {}),
    (20, {}, {"g": 0.0}),
    (1, {}, {}),
]


def _drive(alerts_mod, counters_mod, live_mod):
    eng = alerts_mod.AlertEngine(alerts_mod.parse_rules(
        "ev:rate>2/10s, g:gauge>0.5, h:gauge<0.0, boom:counter>=3"), 1.0)
    now, out = 1000.0, []
    for dt, adds, sets in _SCRIPT:
        now += dt
        for k, v in adds.items():
            counters_mod.counter_add(k, v)
        for k, v in sets.items():
            live_mod.gauge_set(k, v)
        out.append([(r.name, tr) for r, tr in eng.tick(now=now)])
    return out, [{k: v for k, v in r.items()} for r in eng.rows()]


def test_tick_sequence_gives_jax_transitions():
    got = _drive(alerts, _counters, live)
    want = _drive(jalerts, jcounters, jlive)
    assert got == want
    flat = [t for step in got[0] for t in step]
    assert ("g:gauge>0.5", "firing") in flat
    assert ("g:gauge>0.5", "resolved") in flat
    assert ("ev:rate>2.0/10s", "firing") in flat


def test_event_rules_fire_and_age_out_as_jax(tmp_path):
    """builtin:drift fires at the event (one incident captured) and
    resolves after EVENT_RESOLVE_TICKS intervals, in both packages."""
    outs = []
    for mod, cfgmod in ((alerts, config), (jalerts, jconfig)):
        with cfgmod.set(obs_alert_rules="builtin", obs_alert_interval_s=60):
            eng = mod.ensure_engine()
        rec = mod.note_event("drift", value=0.7, meta={"feature": "f0"})
        row = {r["rule"]: r for r in eng.rows()}["builtin:drift"]
        now = time.time()
        late = eng.tick(now=now + 3 * 60 + 5)
        outs.append((rec["event"], rec["value"], row["state"],
                     [(r.name, t) for r, t in late],
                     eng.data()["firing"]))
        mod.stop_engine()
    assert outs[0] == outs[1]
    assert outs[0][2] == "firing"
    assert outs[0][3] == [("builtin:drift", "resolved")]


def test_graph_captures_after_arming_fire():
    with config.set(obs_alert_rules="builtin", obs_alert_interval_s=60):
        eng = alerts.ensure_engine()
    _counters.record_graph_capture()       # before the baseline: warmup
    now = time.time()
    assert eng.tick(now=now) == []
    _counters.record_graph_capture()
    assert [(r.name, t) for r, t in eng.tick(now=now + 1)] == \
        [("builtin:graph_captures", "firing")]


def test_disarmed_by_default_and_ledger_without_engine():
    assert alerts.ensure_engine() is None and alerts.engine() is None
    alerts.note_error(RuntimeError("x"), "serving_execute")
    assert alerts.events() == []           # inert: one global check
    rec = alerts.note_event("fleet_slo_burn", value=2.5)
    assert alerts.events() == [rec]
    data = obs.alerts_data()
    assert data["armed"] is False and data["events"] == [rec]


def test_bad_rule_raises_in_the_arming_caller():
    with config.set(obs_alert_rules="x:gauge!1"):
        with pytest.raises(alerts.AlertRuleError):
            live.ensure_telemetry()
    assert alerts.engine() is None


# -- the event sources -----------------------------------------------------------

def test_watchdog_stall_feeds_the_ledger():
    with config.set(watchdog_timeout_s=0.05):
        with obs.watchdog():
            with obs.span("held"):
                time.sleep(0.2)
    (ev,) = alerts.events("watchdog_stall")
    assert ev["span"] == "held" and ev["timeout_s"] == 0.05


def test_failed_batch_fires_typed_error_and_captures(tmp_path):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.serving import ModelServer, ServingError

    rng = np.random.RandomState(0)
    X = rng.randn(200, 4).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(
        X, (X[:, 0] > 0).astype(np.float32))
    idir = str(tmp_path / "inc")
    with config.set(incident_dir=idir, obs_alert_interval_s=60,
                    obs_trace_sample=1.0,
                    fault_plan="serving_execute:crash@1"):
        with ModelServer(clf) as srv:
            srv.submit(X[:3]).result(WAIT)
            with pytest.raises(ServingError):
                srv.submit(X[:3]).result(WAIT)
    data = alerts.alerts_data()
    assert "builtin:typed_error" in data["firing"]
    (ev,) = alerts.events("typed_error")
    assert ev["site"] == "serving_execute" and ev["error"] == "InjectedCrash"
    (b,) = incidents.load_bundles(idir)
    assert b["reason"] == "alert:builtin:typed_error"
    # captured at the failure, before the failed request's trace ends
    assert b["traces"]["counts"]["completed"] == 1
    assert b["fault_plan"]["fault_plan"] == "serving_execute:crash@1"


def test_exhausted_stream_retries_fire_typed_error(tmp_path):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.reliability import StreamIORetriesExhausted

    rng = np.random.RandomState(1)
    X = rng.randn(300, 4).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with config.set(obs_alert_rules="builtin", obs_alert_interval_s=60):
        alerts.ensure_engine()
    with config.set(stream_block_rows=128, stream_io_retries=0,
                    fault_plan="staging_read:io@1"):
        with pytest.raises(StreamIORetriesExhausted):
            LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    (ev,) = alerts.events("typed_error")
    assert ev["site"] == "stream_io"
    assert ev["error"] == "StreamIORetriesExhausted"


# -- the bundles ---------------------------------------------------------------------

_BLOCKS = ("open_spans", "recent_spans", "traces", "counters", "gauges",
           "histograms", "programs", "device_memory", "fault_plan",
           "alerts", "watchdog_stalls", "config")


def test_bundle_blocks_rate_limit_and_retention(tmp_path):
    idir = str(tmp_path / "inc")
    with config.set(incident_dir=idir, incident_keep=2):
        path = incidents.capture_incident("test", rule="r1",
                                          meta={"k": "v"})
        with open(path) as f:
            bundle = json.load(f)
        assert incidents.capture_incident("again") is None
        paths = [incidents.capture_incident(f"r{i}", force=True)
                 for i in range(3)]
    with jconfig.set(incident_dir=str(tmp_path / "j")):
        jpath = jincidents.capture_incident("test", rule="r1",
                                            meta={"k": "v"})
    with open(jpath) as f:
        jbundle = json.load(f)
    assert set(bundle) == set(jbundle)
    assert all(k in bundle for k in _BLOCKS)
    assert (bundle["incident"], bundle["schema"], bundle["reason"],
            bundle["rule"], bundle["meta"]) == (1, 1, "test", "r1",
                                                {"k": "v"})
    assert isinstance(bundle["programs"], list)
    assert {r["program"] for r in bundle["programs"]} >= {
        "fused_glm_value_grad", "fused_lloyd_stats"}
    assert len(bundle["config"]["fingerprint"]) == 64
    snap = _counters.counters_snapshot()
    assert snap["incidents_captured"] == 4
    assert snap["incidents_rate_limited"] == 1
    left = sorted(os.listdir(idir))
    assert left == sorted(os.path.basename(p) for p in paths[-2:])
    assert not [n for n in left if ".tmp." in n]
    assert [c["reason"] for c in incidents.incidents_data()["captured"]] \
        == ["test", "r0", "r1", "r2"]


def test_bundles_are_written_atomically(tmp_path, monkeypatch):
    """A dump that dies half-way publishes nothing and leaves no temp."""
    idir = str(tmp_path / "inc")

    def torn(obj, f):
        f.write(b'{"incident": 1, ')
        raise OSError("disk full")

    monkeypatch.setattr(incidents, "_json_dump", torn)
    with config.set(incident_dir=idir):
        assert incidents.capture_incident("x") is None
    assert os.listdir(idir) == []


def test_load_bundles_and_fingerprint_match_jax(tmp_path):
    idir = str(tmp_path / "inc")
    with jconfig.set(incident_dir=idir):
        jincidents.capture_incident("good", force=True)
    with open(os.path.join(idir, "incident_9999_bad.json"), "w") as f:
        f.write("{truncated")
    got = incidents.load_bundles(idir)
    want = jincidents.load_bundles(idir)
    assert [sorted(b) for b in got] == [sorted(b) for b in want]
    assert "error" in got[1] and got[0]["reason"] == "good"
    assert "error" in incidents.load_bundles(str(tmp_path / "none"))[0]
    fp1, _ = incidents.config_fingerprint()
    with config.set(incident_keep=3):
        fp2, values = incidents.config_fingerprint()
    assert fp1 != fp2 and values["incident_keep"] == 3


def test_report_incidents_prints_jax_text(tmp_path, capsys):
    """report --incidents on bundles JAX's capture_incident wrote: the
    same text, and the same --json, from both CLIs."""
    idir = str(tmp_path / "inc")
    with jconfig.set(incident_dir=idir, obs_alert_rules="builtin",
                     obs_alert_interval_s=60):
        jalerts.ensure_engine()
        jalerts.note_event("drift", value=0.5, meta={"feature": "f3"})
        jincidents.capture_incident("operator", force=True)
    jalerts.stop_engine()
    for args in (["--incidents", idir], ["--incidents", idir, "--json"]):
        assert report.main(args) == 0
        got = capsys.readouterr().out
        assert jreport.main(args) == 0
        want = capsys.readouterr().out
        assert got == want and "alert:builtin:drift" in got


# -- deep profiling on the CPU ----------------------------------------------------

def test_deep_profile_is_a_no_op_with_a_reason_on_the_cpu(tmp_path):
    with config.set(incident_dir=str(tmp_path)):
        out = incidents.deep_profile(1)
        assert out["profiled"] is False and out["device"] == "cpu"
        assert "card" in out["reason"]
        for bad in (0, -3, "soon"):
            assert incidents.deep_profile(bad)["profiled"] is False
    assert os.listdir(tmp_path) == []
