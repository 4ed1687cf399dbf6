"""Live telemetry plane: metric registry + /metrics + /status exporter.

Counterpart of ``dask_ml_tpu/observability/live.py``:

- a process-wide **metric registry**: last-value gauges and log-spaced
  histograms keyed by ``(name, labels)`` beside the flat counter
  registry (``_counters``), a cardinality guard per family
  (``config.obs_max_series``), and the weak sets of live servers and
  model registries that ``/status`` lists;
- **fit progress** with no new device sync: :func:`publish_progress`
  takes host floats the loops already hold (the step records, the
  streamed solvers' per-pass values, the Incremental block loop), and a
  span-close observer turns ``stream.pass`` records into ``fit_pass`` /
  ``fit_rows_per_sec`` gauges and a ``fit_pass_seconds`` histogram;
- a background :class:`TelemetryServer` (stdlib ``http.server`` on a
  daemon thread, 127.0.0.1, armed by ``config.obs_http_port``) serving
  ``/metrics`` (Prometheus text exposition v0.0.4, under the JAX
  package's ``dask_ml_tpu_`` prefix and family names, so a dashboard
  reads both packages alike), ``/healthz``, ``/status`` (JSON: the
  open-span stack, the report tables over the recent spans and the
  kernel registry, the serving windows, the registries, the drift,
  reliability, alerts and incidents blocks, the device memory gauges and
  the watchdog's stalls), ``/traces`` (the request traces,
  ``_requests.traces_data``), ``/alerts`` (``alerts.alerts_data``),
  ``/status/fleet`` (the fleet providers' block), ``POST
  /profile?seconds=N`` (a ``torch.profiler`` window into
  ``config.incident_dir``, ``incidents.deep_profile``) and ``POST
  /fleet/<name>/<op>`` (the federation's request and publish surface,
  ``serving/federation.py::handle_http``);
- the **fleet providers**: a federating router's
  ``observability/fleet.MetricsFederator`` adds its merged
  ``dask_ml_tpu_fleet_*`` families to ``/metrics`` and its block to
  ``/status`` and ``/status/fleet``.

With the port at its 0 default nothing here runs: no thread, no span
observer, and the publishing gate :func:`live_publishing` stays False,
so every ``publish_*`` call is one flag test.
"""

from __future__ import annotations

import http.server
import json
import math
import os
import re
import threading
import time
import weakref
from collections import deque

from ._counters import counters_snapshot
from ._hist import Histogram
from ._spans import add_span_observer, open_spans_snapshot, \
    remove_span_observer

__all__ = [
    "TelemetryServer", "ensure_telemetry", "stop_telemetry",
    "telemetry_server", "live_publishing", "gauge_set", "gauges_snapshot",
    "histogram", "histograms_snapshot", "drop_labeled_series",
    "metrics_reset", "render_prometheus", "status_data",
    "publish_progress", "note_stall", "register_server",
    "unregister_server", "register_registry", "register_fleet_provider",
    "unregister_fleet_provider", "fleet_status_data",
]

_PREFIX = "dask_ml_tpu_"
_T0 = time.time()

_lock = threading.Lock()
_gauges: dict[tuple, float] = {}          # (name, labels) -> value
_hists: dict[tuple, Histogram] = {}       # (name, labels) -> Histogram
# labeled series per family: the cardinality guard's ledger
_family_series: dict[str, int] = {}
# the shared sink of histogram series refused by the cap
_overflow_hist: Histogram | None = None
# series keys already refused (the drop counter counts series, not writes)
_dropped_series: set = set()

_servers = weakref.WeakSet()
_registries = weakref.WeakSet()

# recent closed-span records (the observer feeds it while a server is
# live): /status renders them through report.report_data, so the live
# view and the post-hoc CLI agree on shape
_recent_spans: deque = deque(maxlen=256)
# recent watchdog stall dumps (fed by _watchdog's reports)
_recent_stalls: deque = deque(maxlen=8)


def register_server(srv) -> None:
    """A ModelServer or FleetServer announces itself."""
    with _lock:
        _servers.add(srv)


def unregister_server(srv) -> None:
    with _lock:
        _servers.discard(srv)


def register_registry(reg) -> None:
    """A ModelRegistry announces itself (weakly: a dropped registry
    leaves with no unregister call)."""
    with _lock:
        _registries.add(reg)


# fleet-metrics providers (observability/fleet.MetricsFederator, which a
# FederatedFleet router with obs_fleet_federate on registers): each adds
# merged dask_ml_tpu_fleet_* lines to /metrics and a block to /status and
# /status/fleet. Strong references: the router's stop() unregisters, and
# a weak set could drop a provider mid-scrape
_fleet_providers: list = []


def register_fleet_provider(provider) -> None:
    """A MetricsFederator (anything with ``render_lines()`` and
    ``fleet_block()``) joins the exporter's pages."""
    with _lock:
        if provider not in _fleet_providers:
            _fleet_providers.append(provider)


def unregister_fleet_provider(provider) -> None:
    with _lock:
        try:
            _fleet_providers.remove(provider)
        except ValueError:
            pass


def fleet_status_data() -> dict:
    """The ``/status/fleet`` block ({} while no federator is
    registered)."""
    out = {}
    with _lock:
        providers = list(_fleet_providers)
    for p in providers:
        try:
            out.update(p.fleet_block())
        except Exception:
            continue
    return out


def _admit_series_locked(name: str, labels: tuple) -> bool:
    """May a new labeled series join ``name``'s family (caller holds
    ``_lock``)? Past ``config.obs_max_series`` it is dropped and counted."""
    if not labels:
        return True
    if (name, labels) in _dropped_series:
        return False
    from ..config import get_config

    cap = int(get_config().obs_max_series)
    if cap > 0 and _family_series.get(name, 0) >= cap:
        from ._counters import counter_add, counters_enabled

        _dropped_series.add((name, labels))
        if counters_enabled():
            counter_add("telemetry_series_dropped", 1)
        return False
    _family_series[name] = _family_series.get(name, 0) + 1
    return True


def gauge_set(name: str, value, labels: tuple = ()) -> None:
    try:
        value = float(value)
    except (TypeError, ValueError):
        return
    key = (name, labels)
    with _lock:
        if key not in _gauges and not _admit_series_locked(name, labels):
            return
        _gauges[key] = value


def drop_labeled_series(name_prefix: str, label_kvs: tuple) -> int:
    """Remove every labeled gauge series whose family name starts with
    ``name_prefix`` and whose labels hold all of ``label_kvs``, freeing
    their slots in the cardinality ledger (a dead replica's series)."""
    kvs = set(label_kvs)
    with _lock:
        doomed = [k for k in _gauges
                  if k[0].startswith(name_prefix) and kvs <= set(k[1])]
        for k in doomed:
            del _gauges[k]
            left = _family_series.get(k[0], 0) - 1
            if left > 0:
                _family_series[k[0]] = left
            else:
                _family_series.pop(k[0], None)
            _dropped_series.discard(k)
        return len(doomed)


def gauges_snapshot() -> dict:
    with _lock:
        return dict(_gauges)


def histogram(name: str, labels: tuple = (), bounds=None) -> Histogram:
    """Create-or-get the histogram keyed ``(name, labels)``."""
    global _overflow_hist
    key = (name, labels)
    with _lock:
        h = _hists.get(key)
        if h is None:
            if not _admit_series_locked(name, labels):
                if _overflow_hist is None:
                    _overflow_hist = Histogram(bounds)
                return _overflow_hist
            h = _hists[key] = Histogram(bounds)
        return h


def histograms_snapshot() -> dict:
    with _lock:
        return dict(_hists)


def metrics_reset() -> None:
    """Clear gauges and histograms (counters have their own reset)."""
    with _lock:
        _gauges.clear()
        _hists.clear()
        _family_series.clear()
        _dropped_series.clear()
        _recent_spans.clear()
        _recent_stalls.clear()
        del _fleet_providers[:]


# the publishing gate: an exporter arms it while it runs
_publishing = 0
_pub_lock = threading.Lock()


def live_publishing() -> bool:
    return _publishing > 0


def _publishing_arm(delta: int) -> None:
    global _publishing
    with _pub_lock:
        _publishing += delta


def publish_progress(**gauges) -> None:
    """Host-side fit progress (loss, grad_norm, pass, blocks...) as
    ``fit_<name>`` gauges. No-op unless a telemetry server is live;
    callers only ever pass values they already hold on the host."""
    if not _publishing:
        return
    for k, v in gauges.items():
        if v is not None:
            gauge_set(f"fit_{k}", v)


def note_stall(rec: dict) -> None:
    """Watchdog stall dump -> the /status ring (the ``watchdog_stalls``
    counter itself is raised by the watchdog, so /metrics and the report
    see it with or without a live server)."""
    with _lock:  # /status iterates this ring from the HTTP thread
        _recent_stalls.append({k: v for k, v in rec.items()
                               if k != "stacks"})


def _on_span_record(rec: dict) -> None:
    """Span-close observer (registered only while a server is live):
    stream-pass records become progress gauges and the pass-time
    histogram; every record lands in the recent-span ring."""
    try:
        if "stream_pass" in rec:
            p = int(rec["stream_pass"])
            wall = float(rec.get("pass_s") or rec.get("wall_s") or 0.0)
            gauge_set("fit_pass", p)
            if wall > 0:
                histogram("fit_pass_seconds").observe(wall)
                gauge_set("fit_last_pass_seconds", wall)
                n = float(rec.get("n_rows") or 0.0)
                if n > 0:
                    gauge_set("fit_rows_per_sec", n / wall)
            tot = rec.get("passes_total")
            if tot:
                gauge_set("fit_passes_total", int(tot))
                if wall > 0:
                    gauge_set("fit_eta_seconds",
                              max(int(tot) - p, 0) * wall)
        elif rec.get("span") == "fit":
            gauge_set("fit_wall_s", rec.get("wall_s", 0.0))
        with _lock:
            _recent_spans.append(rec)
    except Exception:
        pass  # telemetry must never raise into the span layer


# -- Prometheus text exposition v0.0.4 ---------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san(name: str) -> str:
    name = _NAME_RE.sub("_", str(name))
    return name if name and not name[0].isdigit() else f"_{name}"


def _fmt(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_san(k)}="{str(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _merge_label(labels: tuple, key: str, value: str) -> str:
    return _labels_str(tuple(labels) + ((key, value),))


def render_prometheus() -> str:
    """The /metrics body: counters (``_total`` suffix), gauges, and
    histograms (cumulative ``le`` buckets + ``_sum``/``_count``), all
    under the ``dask_ml_tpu_`` namespace. Pure host dicts: a scrape
    never touches the card."""
    lines = []
    counters = counters_snapshot()
    for name in sorted(counters):
        v = counters[name]
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(float(v)):
            continue
        n = f"{_PREFIX}{_san(name)}_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(v)}")
    hist_by_name: dict[str, list] = {}
    for (name, labels), h in sorted(histograms_snapshot().items()):
        hist_by_name.setdefault(_san(name), []).append((labels, h))
    by_name: dict[str, list] = {}
    for (name, labels), v in sorted(gauges_snapshot().items()):
        # a gauge sharing a histogram's family name would emit a second
        # TYPE line for that family: the histogram wins
        if math.isfinite(v) and _san(name) not in hist_by_name:
            by_name.setdefault(_san(name), []).append((labels, v))
    for name, series in by_name.items():
        n = f"{_PREFIX}{name}"
        lines.append(f"# TYPE {n} gauge")
        for labels, v in series:
            lines.append(f"{n}{_labels_str(labels)} {_fmt(v)}")
    for name, series in hist_by_name.items():
        n = f"{_PREFIX}{name}"
        lines.append(f"# TYPE {n} histogram")
        for labels, h in series:
            snap = h.snapshot()
            cum = 0
            for i, bound in enumerate(snap["bounds"]):
                cum += snap["counts"][i]
                lines.append(
                    f"{n}_bucket"
                    f"{_merge_label(labels, 'le', _fmt(bound))} {cum}")
            cum += snap["counts"][-1]
            lines.append(
                f"{n}_bucket{_merge_label(labels, 'le', '+Inf')} {cum}")
            ls = _labels_str(labels)
            lines.append(f"{n}_sum{ls} {_fmt(snap['sum'])}")
            lines.append(f"{n}_count{ls} {snap['count']}")
    # the fleet-merged families (dask_ml_tpu_fleet_*, a namespace of
    # their own, so one TYPE line a family holds across the page); a
    # provider's error never fails the scrape
    with _lock:
        providers = list(_fleet_providers)
    for p in providers:
        try:
            lines.extend(p.render_lines())
        except Exception:
            continue
    up = f"{_PREFIX}uptime_seconds"
    lines.append(f"# TYPE {up} gauge")
    lines.append(f"{up} {_fmt(time.time() - _T0)}")
    return "\n".join(lines) + "\n"


# -- /status -----------------------------------------------------------------

def status_data() -> dict:
    """What the process believes it is doing RIGHT NOW (the open-span
    stack), what it has done recently (the report tables over the
    recent-span ring and the kernel registry), the serving windows, the
    registries, the reliability block, the device memory and any
    watchdog stalls, under the JAX package's top-level keys."""
    from ._counters import device_memory_gauges
    from ._programs import programs_snapshot
    from .report import report_data

    now = time.time()
    open_spans = []
    for s in open_spans_snapshot():
        s = dict(s)
        s["age_s"] = round(now - s.pop("t_open_unix"), 3)
        open_spans.append(s)
    counters = counters_snapshot()
    with _lock:  # fit threads append concurrently
        records = list(_recent_spans)
        stalls = list(_recent_stalls)
        servers = list(_servers)
        registries = list(_registries)
    records.append({"counters": True, **counters})
    progs = programs_snapshot()
    if progs:
        records.append({"programs": progs})
    try:
        from ..plans import plans_snapshot

        plrows = plans_snapshot()
    except Exception:
        plrows = None
    if plrows:
        records.append({"plans": plrows})
    # the alert rules and the captured bundles: blocks for the operator,
    # and records for the shared report aggregator
    try:
        from . import alerts as _alerts

        alerts_block = _alerts.alerts_data()
    except Exception:
        alerts_block = {}
    try:
        from . import incidents as _incidents

        incidents_block = _incidents.incidents_data()
    except Exception:
        incidents_block = {}
    if alerts_block.get("rules") or alerts_block.get("events"):
        records.append({"alerts": alerts_block})
    if incidents_block.get("captured"):
        records.append({"incidents": incidents_block["captured"]})
    hists = {}
    for (name, labels), h in histograms_snapshot().items():
        key = f"{name}{_labels_str(labels)}"
        snap = h.snapshot()
        hists[key] = {
            "count": snap["count"], "sum": round(snap["sum"], 6),
            **{k: (None if isinstance(v, float) and math.isnan(v)
                   else round(v, 6))
               for k, v in h.percentiles((50, 90, 99)).items()},
        }
    serving = []
    for srv in servers:
        try:
            serving.append(srv.stats())
        except Exception:
            continue
    registry = {}
    for reg in registries:
        try:
            registry.update(reg.status_snapshot())
        except Exception:
            continue
    # the last train-vs-serve and window scores, recent hot-swap
    # canaries and the tracked sketch keys
    try:
        from . import drift as _drift

        drift_block = _drift.status_block()
    except Exception:
        drift_block = {}
    try:
        from ..reliability import status_block as _rel_status

        reliability_block = _rel_status()
    except Exception:
        reliability_block = {}
    telem_g = [[n, [list(kv) for kv in ls], v]
               for (n, ls), v in sorted(gauges_snapshot().items())]
    telem_h = []
    for (name, labels), h in sorted(histograms_snapshot().items()):
        snap = h.snapshot()
        telem_h.append([name, [list(kv) for kv in labels], {
            "bounds": list(snap["bounds"]), "counts": snap["counts"],
            "sum": snap["sum"], "count": snap["count"],
            "min": snap["min"], "max": snap["max"],
        }])
    try:
        device_memory = device_memory_gauges()
    except Exception:
        device_memory = {}
    out = {
        "pid": os.getpid(),
        "t_unix": round(now, 3),
        "uptime_s": round(now - _T0, 3),
        "open_spans": open_spans,
        "counters": counters,
        "gauges": {f"{n}{_labels_str(ls)}": v
                   for (n, ls), v in gauges_snapshot().items()},
        "histograms": hists,
        "telemetry": {"gauges": telem_g, "histograms": telem_h},
        "serving": serving,
        "registry": registry,
        "drift": drift_block,
        "reliability": reliability_block,
        "watchdog_stalls": stalls,
        "alerts": alerts_block,
        "incidents": incidents_block,
        "report": report_data(records),
        "device_memory": device_memory,
    }
    fleet = fleet_status_data()
    if fleet:
        out["fleet"] = fleet
    return out


# -- HTTP server -------------------------------------------------------------

def _json_default(o):
    """Non-JSON leaves (numpy scalars riding span attrs) -> float/str."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "dask-ml-tpu-torch-telemetry/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silent: stderr belongs to the fit
        pass

    def _reply(self, code, body: bytes, ctype: str, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _not_found(self):
        self._reply(404, b"not found\n", "text/plain; charset=utf-8")

    def _json(self, code, doc):
        self._reply(code, (json.dumps(doc, default=_json_default)
                           + "\n").encode(), "application/json")

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(n) if n > 0 else b""
            if path.startswith("/fleet/"):
                # the federation's request and publish surface: the
                # FleetServer registered under <name> in this process,
                # run under the exporter starter's config (the config is
                # thread-local), POST so that scrapers stay read-only
                from ..config import use
                from ..serving import federation

                with use(self.server.cfg):
                    code, out, ctype, extra = federation.handle_http(
                        path, dict(self.headers.items()), body)
                self._reply(code, out, ctype, extra)
            elif path == "/profile":
                # a bounded torch.profiler window into incident_dir,
                # under the config of whoever started the exporter (the
                # config is thread-local). POST: it writes files and
                # blocks for the window
                from urllib.parse import parse_qs, urlparse

                from . import incidents as _incidents

                q = parse_qs(urlparse(self.path).query)
                seconds = (q.get("seconds") or ["5"])[0]
                out = _incidents.deep_profile(seconds,
                                              cfg=self.server.cfg)
                self._json(200 if out.get("profiled") else 400, out)
            else:
                self._not_found()
        except Exception as exc:  # never take the server thread down
            try:
                self._reply(500, f"error: {exc}\n".encode(),
                            "text/plain; charset=utf-8")
            except Exception:
                pass

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                self._reply(200, b"ok\n", "text/plain; charset=utf-8")
            elif path == "/metrics":
                self._reply(200, render_prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/traces":
                # the request traces: sampler counts, the kept traces and
                # the per-stage exemplar histograms (exemplars live here,
                # so /metrics stays plain Prometheus text)
                from ._requests import traces_data

                self._json(200, traces_data())
            elif path == "/alerts":
                # the alert engine alone: rule rows, transitions and the
                # crossing ledger, what a pager or an autoscaler polls
                from . import alerts as _alerts

                self._json(200, _alerts.alerts_data())
            elif path == "/status/fleet":
                # the fleet view alone ({} until a federating router
                # registers): merged counters and quantiles, SLO burn
                self._json(200, fleet_status_data())
            elif path == "/status":
                self._json(200, status_data())
            elif path == "/":
                self._reply(200, b"dask_ml_tpu_torch live telemetry: "
                            b"/metrics /status /status/fleet /traces "
                            b"/alerts /healthz (POST /profile?seconds=N, "
                            b"POST /fleet/<name>/<op>)\n",
                            "text/plain; charset=utf-8")
            else:
                self._not_found()
        except Exception as exc:  # never take the server thread down
            try:
                self._reply(500, f"error: {exc}\n".encode(),
                            "text/plain; charset=utf-8")
            except Exception:
                pass


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # a process restarted on the same port must not wait out TIME_WAIT
    allow_reuse_address = True
    # the config of whoever started the exporter: POST /profile runs
    # under it (device, incident_dir)
    cfg = None


class TelemetryServer:
    """The background exporter on 127.0.0.1. ``port=0`` binds an
    ephemeral port (tests); production sets ``config.obs_http_port``.
    Starting registers the span observer and arms the publishing gate;
    stopping undoes both, so a stopped plane costs nothing again."""

    def __init__(self, port=None, host="127.0.0.1"):
        from ..config import get_config

        self.cfg = get_config()
        if port is None:
            port = int(self.cfg.obs_http_port)
        self.port = int(port)
        self.host = host
        self._httpd = None
        self._thread = None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._httpd is not None:
            return self
        httpd = _Server((self.host, self.port), _Handler)
        httpd.cfg = self.cfg
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="dask-ml-tpu-telemetry", daemon=True)
        # arm publication BEFORE serving: a scrape racing start() must
        # not see a half-armed plane
        add_span_observer(_on_span_record)
        _publishing_arm(+1)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        _publishing_arm(-1)
        remove_span_observer(_on_span_record)
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        finally:
            self._httpd = None
            if self._thread is not None:
                self._thread.join(5.0)
                self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


# -- process-wide singleton --------------------------------------------------

_singleton: TelemetryServer | None = None
_singleton_lock = threading.Lock()
# port -> last bind-failure time: retried after a back-off, so a process
# that lost a port race regains its endpoint once the winner exits
_failed_ports: dict[int, float] = {}
_BIND_RETRY_S = 30.0


def telemetry_server() -> TelemetryServer | None:
    """The live singleton server, or None."""
    return _singleton


def ensure_telemetry() -> TelemetryServer | None:
    """Start the process-wide telemetry server if ``config.obs_http_port``
    asks for one and none is running (idempotent; the first port wins for
    the process's life). Called from ``fit_logger``, ``BlockStream`` and
    ``ModelServer``: with the knob at its 0 default this is one config
    read. A bind failure backs off for ``_BIND_RETRY_S`` and never raises
    into the caller.

    It also arms the alert engine, on the engine's own knobs
    (``obs_alert_rules``, ``incident_dir``): rules need no HTTP port. A
    bad rule raises its typed ``AlertRuleError`` here, in the caller."""
    global _singleton
    from . import alerts as _alerts

    try:
        _alerts.ensure_engine()
    except _alerts.AlertRuleError:
        raise
    except Exception:
        pass
    if _singleton is not None:
        return _singleton
    from ..config import get_config

    port = int(get_config().obs_http_port)
    if port <= 0:
        return None
    t_fail = _failed_ports.get(port)
    if t_fail is not None and time.time() - t_fail < _BIND_RETRY_S:
        return None
    with _singleton_lock:
        if _singleton is not None:
            return _singleton
        try:
            srv = TelemetryServer(port=port).start()
        except Exception:
            _failed_ports[port] = time.time()
            return None
        _failed_ports.pop(port, None)
        _singleton = srv
    return _singleton


def stop_telemetry() -> None:
    """Stop the singleton (tests, graceful shutdown)."""
    global _singleton
    with _singleton_lock:
        srv, _singleton = _singleton, None
    if srv is not None:
        srv.stop()
