"""Federation plane: route one request stream over N fleet processes.

Counterpart of ``dask_ml_tpu/serving/federation.py``. A
:class:`~.fleet.FleetServer` scales a model over replicas inside one
process; this module is the layer above it:

- **endpoints**: a :class:`FleetEndpoint` a fleet process.
  :class:`LocalEndpoint` wraps an in-process FleetServer (tests, the
  virtual-rank harness); :class:`HttpEndpoint` talks to a remote
  process's live telemetry server, whose ``POST /fleet/<name>/<op>``
  surface this module implements (:func:`handle_http`, which the live
  exporter's handler calls);
- **predicted-completion routing**: a background poller caches every
  process's ``/status`` document (queued rows, windowed execution
  quantiles, replica health) and :meth:`FederatedFleet.submit` ranks the
  live processes by :func:`~.policy.predict_completion_s` fed from
  :func:`~.policy.exec_from_snapshot`;
- **failover with no admitted request lost**: inference is idempotent,
  so a request in flight to a process that dies (SIGKILL, a reset
  connection) is re-issued whole on the next-ranked process. The
  survivor's trace carries ``rerouted_from_process`` (the
  ``X-Fed-Reroute`` header over HTTP), the hop counts as
  ``serving_process_reroutes``, the dead process counts one
  ``serving_process_failovers`` and its gauge series are dropped;
- **publish fan-out**: :meth:`FederatedFleet.publish` writes the router's
  control registry, then pushes its current version to every live
  process under a rising ``seq``. Each process applies it through
  :func:`apply_publish`: stale seqs are dropped and the version id is
  pinned (``ModelRegistry.publish(version=...)``), so version numbers
  agree fleet-wide and each fleet's ``_on_publish`` swaps the weights
  into its captured graphs.

The publish wire: the estimator is pickled with
``utils/checkpoint.py``'s host pickler, so its tensors ride as host numpy
whatever device they lie on, and the receiving process rebuilds them on
its fleet's device. A body whose pickle names a module of ``jax``,
``jaxlib`` or ``dask_ml_tpu`` is refused with 400 before that module is
imported, so a process of the port never loads JAX. Trust boundary: a
pickle is code. The telemetry server binds 127.0.0.1; point
HttpEndpoints only at processes that already trust each other with code
execution.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from . import metrics as smetrics
from ._buckets import BucketLadder
from ._server import (
    RequestTimeout,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    SloShed,
)
from .fleet import NoHealthyReplicas
from .policy import exec_from_snapshot, predict_completion_s
from .registry import ModelRegistry

__all__ = ["FederatedFleet", "FleetEndpoint", "LocalEndpoint",
           "HttpEndpoint", "ProcessDown", "NoLiveProcesses",
           "apply_publish", "handle_http"]


class ProcessDown(ServingError):
    """A fleet process stopped answering (connection refused or reset,
    status poll dead). The router fails the request over; the process
    rejoins routing when its status poll answers again."""


class NoLiveProcesses(ServingError):
    """Every federated process is down or refused this request: the
    federation's twin of :class:`~.fleet.NoHealthyReplicas`."""


# -- wire helpers ------------------------------------------------------------

# the exceptions of a process dying under a call: a refused or reset
# connection or a deadline passed (OSError, URLError among them), a
# response cut short (IncompleteRead, RemoteDisconnected:
# http.client.HTTPException)
_WIRE_ERRORS = (OSError, http.client.HTTPException)

# top-level packages a publish body may not name (the JAX package and
# JAX itself): refused before import
_REFUSED_PACKAGES = frozenset({"jax", "jaxlib", "dask_ml_tpu"})


def _npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _npy_load(body: bytes):
    return np.load(io.BytesIO(body), allow_pickle=False)


def _publish_bytes(estimator) -> bytes:
    """The publish body: the estimator with its tensors as host numpy."""
    from ..utils.checkpoint import _HostPickler

    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(estimator)
    return buf.getvalue()


class _PublishUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] in _REFUSED_PACKAGES:
            raise pickle.UnpicklingError(
                f"the body names {module}.{name}: a process of "
                "dask_ml_tpu_torch takes no object of the JAX package "
                "(publish a dask_ml_tpu_torch estimator, "
                "dask_ml_tpu_torch.convert makes one)")
        return super().find_class(module, name)


def _publish_load(body: bytes, device):
    """The estimator of a publish body, its tensors rebuilt on
    ``device`` (the receiving fleet's: the config is thread-local, and
    the exporter's handler thread is not the fleet's)."""
    from .. import config

    with config.set(device=str(device)):
        return _PublishUnpickler(io.BytesIO(body)).load()


def _fleet_entry(doc: dict, name: str, process_id: str) -> dict:
    """One fleet's serving entry of a full /status document, shared by
    :meth:`HttpEndpoint.status` and the router's poller (which fetches
    the document once, so the metrics federator rides the same scrape)."""
    for entry in doc.get("serving", ()):
        if entry.get("fleet") == name:
            return entry
    raise ProcessDown(f"{process_id}: no fleet {name!r} on /status")


# -- endpoints ---------------------------------------------------------------

class FleetEndpoint:
    """One fleet process as the router sees it: a process id, a status
    probe, a blocking submit and a publish hook. Subclasses wrap an
    in-process FleetServer (:class:`LocalEndpoint`) or a remote process's
    HTTP surface (:class:`HttpEndpoint`)."""

    process_id: str = "?"

    def status(self) -> dict:
        """The process's fleet stats block (queue_rows, exec_s windows,
        replica health). Raises :class:`ProcessDown` when unreachable."""
        raise NotImplementedError

    def status_doc(self) -> dict:
        """The process's full /status document, fetched once a poll
        interval so that routing and the metrics federator share one
        scrape (a second reader of the windowed-quantile cursors would
        consume their deltas twice). Raises :class:`ProcessDown`."""
        return {"serving": [self.status()]}

    def submit(self, X, method="predict", rerouted_from=None,
               trace_ctx=None):
        """Blocking: place one request and return its result array.
        ``rerouted_from`` names the process this request failed over
        from (the receiving fleet tags the survivor's trace with it);
        ``trace_ctx`` is the router's trace id, which the receiving
        process continues."""
        raise NotImplementedError

    def apply_publish(self, estimator, version, seq, tag=None,
                      quantize=None) -> bool:
        """Install one fanned-out publish (seq-guarded, version-pinned).
        False when the seq was stale."""
        raise NotImplementedError

    def close(self):
        pass

    def __repr__(self):
        return f"{type(self).__name__}({self.process_id!r})"


class LocalEndpoint(FleetEndpoint):
    """An in-process :class:`FleetServer` as a federation endpoint: the
    virtual-rank harness's transport, and the one-process federation."""

    def __init__(self, fleet, process_id=None):
        self.fleet = fleet
        self.process_id = str(
            process_id if process_id is not None else f"local:{id(fleet)}")

    def status(self) -> dict:
        try:
            if not self.fleet._started:
                raise ProcessDown(f"{self.process_id}: fleet stopped")
            return self.fleet.stats()
        except ProcessDown:
            raise
        except Exception as exc:
            raise ProcessDown(f"{self.process_id}: {exc}") from exc

    def status_doc(self) -> dict:
        # an in-process endpoint shares this process's counters and
        # gauges: shipping them to the federator would count them twice
        # against the router's own /metrics
        return {"serving": [self.status()], "counters": {},
                "telemetry": {"gauges": [], "histograms": []}}

    def submit(self, X, method="predict", rerouted_from=None,
               trace_ctx=None):
        import concurrent.futures as cf

        from ..config import get_config
        from ..observability import _requests as rtrace

        cfg = get_config()
        timeout_s = float(cfg.serving_federation_timeout_s)
        try:
            with contextlib.ExitStack() as stack:
                if rerouted_from is not None:
                    stack.enter_context(rtrace.tagging(
                        rerouted_from_process=rerouted_from))
                if trace_ctx is not None and bool(cfg.obs_trace_propagate):
                    # the in-process twin of X-Trace-Context: the fleet's
                    # _admit runs on this thread and mints its trace with
                    # the router's id
                    stack.enter_context(rtrace.trace_context(trace_ctx))
                fut = self.fleet.submit(X, method=method)
            return fut.result(timeout_s if timeout_s > 0 else None)
        except (ServerClosed, NoHealthyReplicas) as exc:
            raise ProcessDown(f"{self.process_id}: {exc}") from exc
        except cf.TimeoutError:
            raise RequestTimeout(
                f"{self.process_id}: no result within the "
                f"{timeout_s:.1f}s federation budget") from None

    def apply_publish(self, estimator, version, seq, tag=None,
                      quantize=None) -> bool:
        return apply_publish(self.fleet, estimator, version, seq,
                             tag=tag, quantize=quantize)


class HttpEndpoint(FleetEndpoint):
    """A remote fleet process behind its live telemetry server: GET
    ``/status`` for the poll plane, POST ``/fleet/<name>/<op>`` for
    requests (npy bodies both ways) and publishes (the host-numpy pickle
    of the module note)."""

    def __init__(self, base_url, name="model", process_id=None,
                 timeout_s=None):
        from ..config import get_config

        self.base_url = str(base_url).rstrip("/")
        self.name = str(name)
        self.process_id = str(process_id if process_id is not None
                              else self.base_url)
        self.timeout_s = float(
            get_config().serving_federation_timeout_s
            if timeout_s is None else timeout_s)

    def _post(self, op, body, headers):
        req = urllib.request.Request(
            f"{self.base_url}/fleet/{self.name}/{op}", data=body,
            headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as exc:
            # typed serving errors ride the status and X-Fed-Error; the
            # body is read so the connection can be reused
            return exc.code, exc.read(), dict(exc.headers or {})
        except _WIRE_ERRORS as exc:
            # the process died before or during its answer: the same
            # failover as a refused connection (re-issuing is safe)
            raise ProcessDown(f"{self.process_id}: {exc}") from exc

    def status_doc(self) -> dict:
        try:
            with urllib.request.urlopen(f"{self.base_url}/status",
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode())
        except _WIRE_ERRORS + (ValueError,) as exc:
            raise ProcessDown(f"{self.process_id}: {exc}") from exc

    def status(self) -> dict:
        return _fleet_entry(self.status_doc(), self.name, self.process_id)

    def submit(self, X, method="predict", rerouted_from=None,
               trace_ctx=None):
        from ..config import get_config

        headers = {"Content-Type": "application/x-npy"}
        if rerouted_from is not None:
            headers["X-Fed-Reroute"] = str(rerouted_from)
        if trace_ctx is not None \
                and bool(get_config().obs_trace_propagate):
            headers["X-Trace-Context"] = str(int(trace_ctx))
        code, body, rhead = self._post(method, _npy_bytes(X), headers)
        if code == 200:
            return _npy_load(body)
        kind = rhead.get("X-Fed-Error", "")
        msg = body.decode(errors="replace").strip() or f"HTTP {code}"
        if kind == "slo_shed":
            raise SloShed(f"{self.process_id}: {msg}")
        if kind == "overloaded":
            raise ServerOverloaded(f"{self.process_id}: {msg}")
        if kind == "timeout":
            raise RequestTimeout(f"{self.process_id}: {msg}")
        # closed, unknown fleet, anything else: this process cannot take
        # the request, fail over
        raise ProcessDown(f"{self.process_id}: {msg}")

    def apply_publish(self, estimator, version, seq, tag=None,
                      quantize=None) -> bool:
        headers = {
            "Content-Type": "application/x-pickle",
            "X-Fed-Version": str(int(version)),
            "X-Fed-Seq": str(int(seq)),
        }
        if tag is not None:
            headers["X-Fed-Tag"] = str(tag)
        if quantize is not None:
            headers["X-Fed-Quantize"] = str(quantize)
        code, body, _ = self._post("publish", _publish_bytes(estimator),
                                   headers)
        if code != 200:
            raise ProcessDown(
                f"{self.process_id}: publish failed: "
                f"{body.decode(errors='replace').strip()}")
        return bool(json.loads(body.decode()).get("applied", False))


# -- receiving side ----------------------------------------------------------

# serializes the applies of one process: two fan-outs landing together
# must check and advance the seq and publish in one critical section, or
# the registry's current could regress to the stale one
_apply_lock = threading.Lock()


def apply_publish(fleet, estimator, version, seq, tag=None,
                  quantize=None) -> bool:
    """Install one fanned-out publish on a receiving fleet: drop a stale
    seq (the last writer wins), pin the origin's version id into the
    local registry, and let the fleet's own subscriber swap the weights
    into its captured graphs."""
    seq = int(seq)
    with _apply_lock:
        if seq <= getattr(fleet, "_fed_seq", 0):
            return False
        fleet._fed_seq = seq
        fleet.registry.publish(fleet.name, estimator, tag=tag,
                               quantize=quantize, version=int(version))
    return True


def _find_fleet(name):
    """The live-registered FleetServer named ``name`` in this process
    (``FleetServer.start`` registers it for /status; the POST surface
    reuses that registration)."""
    from ..observability import live

    with live._lock:
        servers = list(live._servers)
    for srv in servers:
        if getattr(srv, "name", None) == name and hasattr(srv, "replicas"):
            return srv
    return None


_TEXT = "text/plain; charset=utf-8"


def handle_http(path, headers, body):
    """The ``POST /fleet/<name>/<op>`` handler of the live exporter.
    Returns ``(code, body_bytes, content_type, extra_headers)``. Ops: a
    served method name (npy in, npy out) or ``publish`` (the host-numpy
    pickle). Typed serving errors map to codes that
    :class:`HttpEndpoint` reverses: 429 with ``X-Fed-Error:
    slo_shed|overloaded``, 503 closed or unknown, 504 timeout; 400 for a
    body that cannot be read or a refused publish."""
    from ..config import get_config
    from ..observability import _requests as rtrace

    parts = [p for p in path.split("/") if p]
    if len(parts) != 3 or parts[0] != "fleet":
        return (404, b"not found\n", _TEXT, {})
    _, name, op = parts
    fleet = _find_fleet(name)
    if fleet is None:
        return (503, f"no live fleet {name!r} in this process\n".encode(),
                _TEXT, {"X-Fed-Error": "unknown"})
    if op == "publish":
        try:
            est = _publish_load(body, fleet.replicas[0].device)
            version = int(headers.get("X-Fed-Version", 0))
            seq = int(headers.get("X-Fed-Seq", 0))
        except Exception as exc:
            return (400, f"bad publish body: {exc}\n".encode(), _TEXT, {})
        applied = apply_publish(
            fleet, est, version, seq, tag=headers.get("X-Fed-Tag"),
            quantize=headers.get("X-Fed-Quantize"))
        out = json.dumps({"applied": applied,
                          "version": fleet.version}).encode() + b"\n"
        return (200, out, "application/json", {})
    try:
        X = _npy_load(body)
    except Exception as exc:
        return (400, f"bad npy body: {exc}\n".encode(), _TEXT, {})
    rerouted = headers.get("X-Fed-Reroute")
    cfg = get_config()
    trace_ctx = None
    if bool(cfg.obs_trace_propagate):
        try:
            trace_ctx = int(headers.get("X-Trace-Context", ""))
        except (TypeError, ValueError):
            trace_ctx = None
    try:
        with contextlib.ExitStack() as stack:
            if rerouted:
                # the survivor's trace names the process this request
                # failed over from (a pending tag the replica's _admit
                # picks up on this thread)
                stack.enter_context(rtrace.tagging(
                    rerouted_from_process=rerouted))
            if trace_ctx is not None:
                # continue the router's trace: _admit runs on this
                # thread and mints its trace with the propagated id
                stack.enter_context(rtrace.trace_context(trace_ctx))
            fut = fleet.submit(X, method=op)
        timeout_s = float(cfg.serving_federation_timeout_s)
        result = fut.result(timeout_s if timeout_s > 0 else None)
    except SloShed as exc:
        return (429, f"{exc}\n".encode(), _TEXT,
                {"X-Fed-Error": "slo_shed"})
    except ServerOverloaded as exc:
        return (429, f"{exc}\n".encode(), _TEXT,
                {"X-Fed-Error": "overloaded"})
    except (ServerClosed, NoHealthyReplicas) as exc:
        return (503, f"{exc}\n".encode(), _TEXT, {"X-Fed-Error": "closed"})
    except RequestTimeout as exc:
        return (504, f"{exc}\n".encode(), _TEXT,
                {"X-Fed-Error": "timeout"})
    except AttributeError:
        return (400, f"unknown method {op!r}\n".encode(), _TEXT, {})
    except Exception as exc:  # ServingError and the rest
        return (500, f"{exc}\n".encode(), _TEXT, {"X-Fed-Error": "error"})
    return (200, _npy_bytes(result), "application/x-npy", {})


# -- the router --------------------------------------------------------------

class _ProcessState:
    __slots__ = ("endpoint", "alive", "stats", "doc", "t_status",
                 "t_dead", "inflight_rows")

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.alive = True       # optimistic: the first poll corrects it
        self.stats = None
        self.doc = None         # the last full /status document
        self.t_status = 0.0
        self.t_dead = 0.0
        self.inflight_rows = 0  # rows this router placed, not yet answered


class FederatedFleet:
    """Client-side router over N fleet processes.

    Parameters
    ----------
    endpoints : sequence of FleetEndpoint (or base URL strings)
        The fleet processes; a string builds an :class:`HttpEndpoint`.
    name : str, the registry and fleet name every process serves
    ladder : BucketLadder, default from config; sizes the completion
        predictor's top bucket (the processes' ladders)
    registry : the control ModelRegistry, default a fresh one
    poll_s / timeout_s / retry_s : floats, default
        ``config.serving_federation_*``: the status-poll period, the
        per-call HTTP deadline, the dead-process re-probe period.

    The router runs on ``config.device`` like every entry point: it
    raises without a card unless the CPU was asked for. Use as a context
    manager::

        with FederatedFleet([url0, url1], name="model") as fed:
            y = fed.predict(x)          # routed, failed over
            fed.publish(new_clf)        # fanned out, versions pinned
    """

    def __init__(self, endpoints, name="model", ladder=None,
                 registry=None, poll_s=None, timeout_s=None,
                 retry_s=None):
        from ..config import get_config, resolve_device

        cfg = get_config()
        resolve_device()        # no card and no CPU asked for: raise
        self.name = str(name)
        eps = []
        for ep in endpoints:
            if isinstance(ep, FleetEndpoint):
                eps.append(ep)
            else:
                eps.append(HttpEndpoint(ep, name=self.name,
                                        timeout_s=timeout_s))
        if not eps:
            raise ValueError("FederatedFleet needs >= 1 endpoint")
        self._procs = [_ProcessState(ep) for ep in eps]
        self.ladder = ladder if ladder is not None \
            else BucketLadder.from_config()
        # the control registry: the fan-out's source of version ids
        self.registry = registry if registry is not None \
            else ModelRegistry()
        self._poll_s = float(cfg.serving_federation_poll_s
                             if poll_s is None else poll_s)
        self._retry_s = float(cfg.serving_federation_retry_s
                              if retry_s is None else retry_s)
        self._pub_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poller = None
        self._pool = None
        # the fleet metrics federation rides the status poller (no thread
        # or scrape of its own); off, nothing is built or registered
        self._federator = None
        if bool(cfg.obs_fleet_federate):
            from ..observability.fleet import MetricsFederator

            self._federator = MetricsFederator(
                name=self.name, slo_ms=float(cfg.serving_slo_ms),
                min_interval_s=float(cfg.obs_fleet_poll_s))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        import concurrent.futures as cf

        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=max(4, 2 * len(self._procs)),
                thread_name_prefix="fed-submit")
        self._stop.clear()
        if self._federator is not None:
            from ..observability import live

            live.register_fleet_provider(self._federator)
        self._poll_once()
        if self._poller is None:
            self._poller = threading.Thread(
                target=self._poll_loop, name="fed-poller", daemon=True)
            self._poller.start()
        return self

    def stop(self):
        self._stop.set()
        if self._poller is not None:
            self._poller.join(5.0)
            self._poller = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._federator is not None:
            from ..observability import live

            live.unregister_fleet_provider(self._federator)
        for p in self._procs:
            try:
                p.endpoint.close()
            except Exception:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- poll plane --------------------------------------------------------
    def _poll_loop(self):
        while not self._stop.wait(self._poll_s):
            try:
                self._poll_once()
            except Exception:
                pass

    def _poll_once(self):
        now = time.monotonic()
        t0 = time.perf_counter()
        snapshots = []
        for p in self._procs:
            pid = p.endpoint.process_id
            if not p.alive and now - p.t_dead < self._retry_s:
                # a known-dead process is re-probed only after the
                # back-off; its fleet series drop this interval
                snapshots.append((pid, None))
                continue
            try:
                # one scrape a process an interval: the document feeds
                # routing (its serving entry) and the metrics federator
                doc = p.endpoint.status_doc()
                stats = _fleet_entry(doc, self.name, pid)
            except ProcessDown:
                self._mark_dead(p)
                snapshots.append((pid, None))
                continue
            with self._lock:
                p.alive = True
                p.stats = stats
                p.doc = doc
                p.t_status = time.monotonic()
            smetrics.set_process_gauges(
                pid, healthy=True, replicas=stats.get("healthy_replicas"))
            snapshots.append((pid, doc))
        if self._federator is not None:
            self._federator.ingest(
                snapshots, scrape_s=time.perf_counter() - t0)

    def _mark_dead(self, p):
        with self._lock:
            was_alive = p.alive
            p.alive = False
            p.t_dead = time.monotonic()
            p.stats = None
        if was_alive:
            smetrics.record_process_failover()
            # a dead process's gauge series never latch on /metrics
            smetrics.drop_process_gauges(p.endpoint.process_id)

    # -- request plane -----------------------------------------------------
    def _ranked(self, method, n_rows):
        """Live processes by predicted completion; a cold window (no
        prediction) ranks after the known-fast ones, queued rows break
        ties. A process's queued rows are those of its last poll plus
        the rows this router has placed on it since and not had
        answered, so that requests between two polls spread by load
        instead of all going to one process."""
        with self._lock:
            live = [(p, p.inflight_rows) for p in self._procs if p.alive]
        scored = []
        for p, inflight in live:
            stats = p.stats or {}
            queue_rows = int(stats.get("queue_rows", 0) or 0) + inflight
            exec_s = None
            for rep in stats.get("replicas", ()):
                v = exec_from_snapshot(rep.get("exec_s"), method,
                                       self.ladder.max_rows)
                if v is not None and (exec_s is None or v < exec_s):
                    exec_s = v
            predicted = predict_completion_s(
                queue_rows, n_rows, self.ladder.max_rows, exec_s)
            scored.append((predicted if predicted is not None
                           else float("inf"), queue_rows, p))
        scored.sort(key=lambda t: (t[0], t[1], t[2].endpoint.process_id))
        return [p for _, _, p in scored]

    def _route(self, X, method, n_rows, tr=None):
        ranked = self._ranked(method, n_rows)
        if not ranked:
            raise NoLiveProcesses(
                f"0/{len(self._procs)} federated processes live")
        last_exc = None
        rerouted_from = None
        for p in ranked:
            if tr is not None:
                # one dispatch stamp a placement: a rerouted request's
                # router trace holds every leg
                tr.stamp("dispatch")
                tr.tag(process=p.endpoint.process_id)
            with self._lock:
                p.inflight_rows += n_rows
            try:
                return p.endpoint.submit(
                    X, method=method, rerouted_from=rerouted_from,
                    trace_ctx=tr.trace_id if tr is not None else None)
            except ProcessDown as exc:
                # the process died under this request (or refused it as
                # closed): the whole request goes to the next-ranked
                # survivor, which is how no admitted request is lost
                last_exc = exc
                self._mark_dead(p)
                smetrics.record_process_reroute()
                rerouted_from = p.endpoint.process_id
                if tr is not None:
                    tr.tag(rerouted_from_process=rerouted_from)
            except ServerOverloaded as exc:
                last_exc = exc
                smetrics.record_process_reroute()
                rerouted_from = p.endpoint.process_id
                if tr is not None:
                    tr.tag(rerouted_from_process=rerouted_from)
            finally:
                with self._lock:
                    p.inflight_rows -= n_rows
            # SloShed and RequestTimeout propagate: admission refused the
            # request on purpose, and a timeout already spent its budget
        if isinstance(last_exc, ProcessDown):
            raise NoLiveProcesses(
                f"every federated process refused this request; "
                f"last: {last_exc}") from last_exc
        raise last_exc

    def _run_request(self, X, method, tr, cfg):
        from .. import config

        n_rows = 1 if X.ndim == 1 else int(X.shape[0])
        # the config is thread-local: this pool thread runs under the
        # submitting caller's (its device, its trace knobs)
        with config.use(cfg):
            if tr is None:
                return self._route(X, method, n_rows)
            try:
                result = self._route(X, method, n_rows, tr=tr)
            except SloShed:
                tr.tag(slo_shed=True)
                tr.finish("slo_shed")
                raise
            except RequestTimeout:
                tr.finish("timeout")
                raise
            except Exception:
                tr.finish("error")
                raise
            tr.finish("ok")
            return result

    def submit(self, X, method="predict"):
        """Admit one request to the federation: a Future of the result
        array (routing, failover and reroute tagging run on the router's
        worker thread). With request traces on, the router mints the
        trace here, on the caller's thread, and every process the
        request touches continues its id."""
        if self._pool is None:
            raise ServerClosed("FederatedFleet is not started")
        from ..config import get_config
        from ..observability import _requests as rtrace

        X = np.asarray(X, np.float32)
        tr = None
        if rtrace.tracing_enabled():
            tr = rtrace.new_trace(
                method, 1 if X.ndim == 1 else int(X.shape[0]))
            tr.tag(federation=self.name)
        return self._pool.submit(self._run_request, X, method, tr,
                                 get_config())

    def _call(self, X, method):
        return self.submit(X, method=method).result()

    def predict(self, X):
        return self._call(X, "predict")

    def predict_proba(self, X):
        return self._call(X, "predict_proba")

    def decision_function(self, X):
        return self._call(X, "decision_function")

    def transform(self, X):
        return self._call(X, "transform")

    # -- publish plane -----------------------------------------------------
    def publish(self, estimator, tag=None, quantize=None) -> int:
        """Publish to the control registry and fan the version out to
        every live process (version-pinned, seq-guarded:
        :func:`apply_publish`). Returns the control version id. A dead
        process is skipped; it converges on the next publish after it
        comes back."""
        version = self.registry.publish(self.name, estimator, tag=tag,
                                        quantize=quantize)
        self._fan_out()
        return version

    def _fan_out(self):
        """Push the control registry's current version to every live
        process. Current is read again under the seq lock, so a slow
        fan-out pushes the newest version with the newest seq and never
        brings back its own stale one: back-to-back publishes
        converge."""
        with self._lock:
            try:
                mv = self.registry.get(self.name)
            except KeyError:
                return
            self._pub_seq += 1
            seq = self._pub_seq
            live = [p for p in self._procs if p.alive]
        smetrics.record_federation_publish()
        for p in live:
            try:
                p.endpoint.apply_publish(
                    mv.estimator, mv.version, seq, tag=mv.tag,
                    quantize=getattr(mv, "quantize", None))
            except ProcessDown:
                self._mark_dead(p)

    def rollback(self, version=None) -> int:
        """Roll the control registry back and fan the version out (on
        the wire a rollback is a publish: the archived snapshot with its
        original version id under a fresh seq)."""
        v = self.registry.rollback(self.name, version=version)
        self._fan_out()
        return v

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        """The router's view: each process's liveness, polled queue, rows
        in flight from this router, status age and version."""
        with self._lock:
            procs = [{
                "process": p.endpoint.process_id,
                "alive": p.alive,
                "status_age_s": round(time.monotonic() - p.t_status, 3)
                if p.t_status else None,
                "queue_rows": int((p.stats or {}).get("queue_rows", 0)
                                  or 0),
                "inflight_rows": p.inflight_rows,
                "version": (p.stats or {}).get("version"),
                "healthy_replicas": (p.stats or {})
                .get("healthy_replicas"),
            } for p in self._procs]
        return {
            "federation": self.name,
            "n_processes": len(procs),
            "live_processes": sum(1 for p in procs if p["alive"]),
            "processes": procs,
        }
