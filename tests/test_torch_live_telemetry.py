"""The port's live plane on the CPU: the HTTP exporter (/healthz,
/metrics, /status, /traces, /alerts, POST /profile and the paths it does
not serve), the watchdog, the report CLI's kernel table and live mode,
the Chrome-trace export, and
the names the port exports or still owes, held against dask_ml_tpu's
where both packages have them. Every server binds an ephemeral port and
every thread is joined under its own limit."""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

import dask_ml_tpu.observability as jobs
from dask_ml_tpu.observability import export as jexport
from dask_ml_tpu.observability import live as jlive
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch.observability import _peak, _programs, _watchdog, \
    export, live, report

WAIT = 10.0   # seconds any one HTTP call or join may take

_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'([-+]?[0-9.eE+-]+|[+-]Inf|NaN)$')
_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                   r"(counter|gauge|histogram)$")


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture
def server():
    srv = live.TelemetryServer(port=0).start()
    try:
        yield srv
    finally:
        srv.stop()
    assert not live.live_publishing()


def _get(url, data=None):
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def parse_prometheus(text):
    """Every line of a /metrics body as (kind, line); raises on a line
    the text exposition v0.0.4 does not allow."""
    out = []
    for ln in text.splitlines():
        if _TYPE.match(ln):
            out.append(("type", ln))
        elif _SAMPLE.match(ln):
            out.append(("sample", ln))
        else:
            raise ValueError(f"not Prometheus text: {ln!r}")
    return out


def test_exporter_serves_health_metrics_and_status(server):
    obs.counter_add("h2d_bytes", 10)
    live.gauge_set("fit_loss", 0.5)
    assert _get(f"{server.url}/healthz") == (200, "ok\n")
    code, body = _get(f"{server.url}/metrics")
    assert code == 200
    kinds = parse_prometheus(body)
    assert ("sample", "dask_ml_tpu_fit_loss 0.5") in kinds
    code, body = _get(f"{server.url}/status")
    assert code == 200
    doc = json.loads(body)
    # the JAX page's top-level keys (its fleet block appears only under
    # a federating router)
    jdoc = jlive.status_data()
    assert set(doc) == set(jdoc) - {"fleet"}
    for block in ("drift", "alerts", "incidents"):
        assert set(doc[block]) == set(jdoc[block]), block
    assert doc["alerts"]["armed"] is False
    assert doc["device_memory"] == {}
    assert {r["program"] for r in doc["report"]["programs"]} == \
        set(obs.programs_snapshot()[i]["program"] for i in range(10))
    code, body = _get(f"{server.url}/traces")
    assert code == 200 and set(json.loads(body)) == {
        "counts", "traces", "stage_histograms"}
    code, body = _get(f"{server.url}/alerts")
    assert code == 200 and json.loads(body)["armed"] is False
    code, body = _get(f"{server.url}/")
    assert "/traces /alerts" in body and "POST /profile" in body
    # the exporter was started on the CPU: a profile is refused, with why
    code, body = _get(f"{server.url}/profile?seconds=1", data=b"")
    assert code == 400 and json.loads(body)["profiled"] is False
    assert _get(f"{server.url}/nothing")[0] == 404
    # the fleet surface: no federating router registered, an empty
    # block; no fleet "m" in this process, a typed 503
    assert _get(f"{server.url}/status/fleet") == (200, "{}\n")
    assert "/status/fleet" in _get(f"{server.url}/")[1]
    assert _get(f"{server.url}/fleet/m/predict", data=b"{}") == (
        503, "no live fleet 'm' in this process\n")


def test_status_shows_the_open_fit_span_while_it_runs(server):
    """A second thread scrapes while a span is open on this one; the
    published progress gauges show on /metrics."""
    got = {}

    def scrape():
        got["status"] = json.loads(_get(f"{server.url}/status")[1])
        got["metrics"] = _get(f"{server.url}/metrics")[1]

    with obs.span("fit", component="probe"):
        obs.publish_progress(loss=0.125, step=3)
        t = threading.Thread(target=scrape)
        t.start()
        t.join(WAIT)
        assert not t.is_alive()
    names = [s["span"] for s in got["status"]["open_spans"]]
    assert "fit" in names
    assert "dask_ml_tpu_fit_loss 0.125" in got["metrics"]
    recent = got["status"]["open_spans"][0]
    assert recent["age_s"] >= 0


def test_ensure_telemetry_is_off_by_default():
    threads = set(threading.enumerate())
    assert live.ensure_telemetry() is None
    assert set(threading.enumerate()) == threads
    assert not live.live_publishing()


def test_serving_blocks_of_status_while_a_server_runs(tmp_path):
    """A server with traces, drift and a rule on, under an exporter that
    ensure_telemetry started (and that armed the alert engine): /status
    carries non-empty drift, alerts and incidents blocks, /traces the
    server's traces, /alerts the rule, and the report's tables read the
    alerts and incidents records."""
    import numpy as np

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.observability import alerts, drift, incidents
    from dask_ml_tpu_torch.observability import _requests
    from dask_ml_tpu_torch.serving import ModelServer

    rng = np.random.RandomState(0)
    X = rng.randn(300, 4).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(
        X, (X[:, 0] > 0).astype(np.float32))
    for plane in (alerts, incidents, drift):
        plane.reset()
    _requests.traces_reset()
    knobs = dict(obs_http_port=_free_port(), obs_trace_sample=1.0,
                 obs_drift_interval_s=0.0, obs_alert_interval_s=60.0,
                 obs_alert_rules="drift_score_max:gauge>0.2",
                 incident_dir=str(tmp_path / "inc"))
    try:
        with config.set(**knobs):
            with ModelServer(clf) as srv:
                for i in range(5):
                    srv.submit(X[i:i + 9]).result(WAIT)
                url = live.telemetry_server().url
                assert alerts.engine() is not None
                incidents.capture_incident("operator")
                drift.compute()
                doc = json.loads(_get(f"{url}/status")[1])
                traces = json.loads(_get(f"{url}/traces")[1])
                rules = json.loads(_get(f"{url}/alerts")[1])
    finally:
        live.stop_telemetry()
        alerts.reset()
        incidents.reset()
        drift.reset()
        _requests.traces_reset()
    # the fold samples at most one batch per 50 ms: at least the first
    assert doc["drift"]["serving_sketches"][0]["rows"] >= 9
    assert doc["alerts"]["armed"] is True
    assert doc["incidents"]["captured"][0]["reason"] == "operator"
    assert 5 in [s["requests"] for s in doc["serving"]]
    assert doc["report"]["alerts"] and doc["report"]["incidents"]
    assert traces["counts"]["completed"] == 5
    assert "drift_score_max:gauge>0.2" in {r["rule"] for r in rules["rules"]}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_watchdog_reports_a_stalled_span_once(tmp_path):
    """A span held open past the deadline (a sleep inside a span) writes
    exactly one stall record with every thread's stack; /status's ring
    gets it without the stacks."""
    live.metrics_reset()
    seen = []
    with config.set(trace_dir=str(tmp_path)):
        with obs.watchdog(timeout_s=0.2, on_stall=seen.append,
                          poll_s=0.05) as wd:
            assert obs.watchdog_active()
            with obs.span("held"):
                time.sleep(0.6)
        assert wd._thread is None
    assert not obs.watchdog_active()
    recs = report.load_records(str(tmp_path / "trace.jsonl"))
    stalls = [r for r in recs if r.get("watchdog")]
    assert len(stalls) == 1 and len(seen) == 1
    st = stalls[0]
    assert st["span"] == "held" and st["age_s"] > 0.2
    assert st["stacks"] and st["stalled_stack"]
    assert any("time.sleep" in ln or "sleep" in ln
               for ln in st["stalled_stack"])
    ring = live.status_data()["watchdog_stalls"]
    assert len(ring) == 1 and "stacks" not in ring[0]
    assert report.watchdog_stalls(recs)[0][0] == "held"
    live.metrics_reset()


def test_fit_watchdog_is_shared_by_nested_fits():
    with config.set(watchdog_timeout_s=30.0):
        with _watchdog.shared_watchdog() as a:
            with _watchdog.shared_watchdog() as b:
                assert a is b
                assert sum(t.name == "dask-ml-tpu-watchdog"
                           for t in threading.enumerate()) == 1
    assert _watchdog._shared is None and not obs.watchdog_active()
    with _watchdog.shared_watchdog() as off:
        assert off is None


def _kernel_records(tmp_path, monkeypatch):
    """A record file holding a kernel table, folded from stand-in event
    pairs under the H100 row."""
    row = dict(_peak.peak_row("NVIDIA H100 80GB HBM3"), device_kind="H100",
               power_limit="700.00 W", reason=None, flops=989e12)
    monkeypatch.setattr(_peak, "resolve_peak", lambda use_cache=True: row)

    class Ev:
        def __init__(self, ms):
            self.ms = ms

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, stop):
            return stop.ms - self.ms

    path = str(tmp_path / "k.jsonl")
    _programs.programs_reset()
    try:
        for name, shape, ms in (
                ("fused_glm_value_grad", (4_000_000, 257, 4), 1.5),
                ("fused_lloyd_stats", (8_000_000, 128, 64, False), 2.0)):
            nb, terms = _programs.KERNEL_COSTS[name](*shape)
            _programs._pending.append((name, Ev(0.0), Ev(ms), nb, terms,
                                       sum(f for f, _ in terms)))
        lg = obs.MetricsLogger(path)
        obs.log_programs(lg)
        lg.close()
    finally:
        _programs.programs_reset()
    return path


def test_report_cli_renders_the_kernel_table(tmp_path, monkeypatch,
                                              capsys):
    path = _kernel_records(tmp_path, monkeypatch)
    assert report.main([path]) == 0
    text = capsys.readouterr().out
    assert "kernels (CUDA events against the bound of the work)" in text
    line = next(ln for ln in text.splitlines()
                if ln.startswith("fused_glm_value_grad"))
    assert "1.2322ms" in line and "82.1%" in line
    assert report.main([path, "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    rows = {r["program"]: r for r in data["programs"]}
    assert rows["fused_lloyd_stats"]["share_of_bound"] == pytest.approx(
        rows["fused_lloyd_stats"]["bound_s"] / 2e-3)
    assert data["peak"]["flop_per_s_per_chip"] == 989e12
    # --incidents adds the bundle table after the file's report
    from dask_ml_tpu_torch.observability import incidents

    idir = str(tmp_path / "inc")
    with config.set(incident_dir=idir):
        incidents.capture_incident("operator", force=True)
    incidents.reset()
    assert report.main([path, "--incidents", idir]) == 0
    text = capsys.readouterr().out
    assert "kernels (" in text and f"incident bundles ({idir})" in text
    assert "operator" in text


def test_watch_once_renders_a_live_frame(server, capsys):
    assert report.main(["--watch", server.url, "--once"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"live: {server.url}")
    assert "kernels (" not in out or "share" in out


def test_chrome_trace_matches_jax_and_holds_the_spans(tmp_path):
    with config.set(trace_dir=str(tmp_path)):
        with obs.span("fit", component="probe", n_rows=10):
            with obs.span("stream.pass", stream_pass=1, n_rows=10):
                obs.record_transfer(40)
    recs = report.load_records(str(tmp_path / "trace.jsonl"))
    trace = export.to_chrome_trace(recs)
    assert trace == jexport.to_chrome_trace(recs)
    out = str(tmp_path / "t.json")
    export.write_chrome_trace(recs, out)
    with open(out) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert {"probe.fit", "stream.pass"} <= names


def test_every_jax_name_is_exported_or_owed():
    """Each name of dask_ml_tpu.observability is the port's too, or
    raises NotImplementedError naming the reason it is not ported; no
    name is owed any more (the fleet federation's two are exported)."""
    not_ported = set()
    for name in jobs.__all__:
        try:
            getattr(obs, name)
        except NotImplementedError as e:
            assert "Not to be ported" in str(e), name
            not_ported.add(name)
    assert not_ported and not not_ported & set(obs.__all__)
    from dask_ml_tpu_torch.observability import fleet

    assert obs.MetricsFederator is fleet.MetricsFederator
    assert obs.SLO_BURN_BUDGET == jobs.SLO_BURN_BUDGET == 0.01
    with pytest.raises(NotImplementedError, match="Not to be ported"):
        obs.jit_callbacks_supported
    from dask_ml_tpu_torch.utils import observability as shim

    assert shim.fit_logger is obs.fit_logger
