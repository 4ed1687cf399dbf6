"""The port's live plane on the CPU: the HTTP exporter (/healthz,
/metrics, /status and the paths it does not serve), the watchdog, the
report CLI's kernel table and live mode, the Chrome-trace export, and
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
    assert doc["drift"] == doc["alerts"] == doc["incidents"] == {}
    assert doc["device_memory"] == {}
    assert {r["program"] for r in doc["report"]["programs"]} == \
        set(obs.programs_snapshot()[i]["program"] for i in range(10))
    for path in ("/traces", "/alerts", "/nothing"):
        assert _get(f"{server.url}{path}")[0] == 404
    assert _get(f"{server.url}/profile?seconds=1", data=b"")[0] == 404
    assert _get(f"{server.url}/fleet/m/predict", data=b"{}")[0] == 404


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
    assert report.main([path, "--incidents", str(tmp_path)]) == 2
    assert "part 2" in capsys.readouterr().err


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
    raises NotImplementedError naming the part that owes it (or the
    reason it is not ported)."""
    for name in jobs.__all__:
        try:
            getattr(obs, name)
        except NotImplementedError as e:
            assert ("Observability, part 2" in str(e)
                    or "Not to be ported" in str(e)), name
    with pytest.raises(NotImplementedError, match="part 2"):
        obs.MetricsFederator
    with pytest.raises(NotImplementedError, match="Not to be ported"):
        obs.jit_callbacks_supported
    from dask_ml_tpu_torch.utils import observability as shim

    assert shim.fit_logger is obs.fit_logger
