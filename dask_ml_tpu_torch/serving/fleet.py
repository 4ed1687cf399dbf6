"""FleetServer: N replica ModelServers behind one admission door.

Counterpart of ``dask_ml_tpu/serving/fleet.py``. A fleet fronts a named
model of a :class:`~dask_ml_tpu_torch.serving.registry.ModelRegistry`
with

- **replicas**: N :class:`ModelServer` workers. With several cards each
  replica's parameters and graphs live on its own card; on one card the
  replicas are thread workers, each with its own CUDA stream and its own
  graphs, whose coalescing windows and host pack/demux overlap each
  other's replays;
- **least-loaded routing**: ``submit`` ranks healthy replicas by queued
  rows;
- **SLO-aware admission**: with ``config.serving_slo_ms`` set, the door
  predicts each candidate's completion (queued rows times the windowed
  per-(method, bucket) execution quantile) and sheds with typed
  :class:`~dask_ml_tpu_torch.serving.SloShed` when every replica would
  miss;
- **hot-swap**: the fleet subscribes to its registry name; every
  publish or rollback rolls through the replicas writing the new
  parameters into the graphs' static buffers, so a same-shape version
  flip under live traffic captures no graph and loses no request. A
  shape-incompatible publish rebuilds instead
  (``serving_swap_rebuilds``);
- **failover**: a dead or stopped replica stops receiving new work;
  traffic drains to the survivors (``serving_reroutes``).

:func:`serve_while_training` drives an ``Incremental``/SGD
``partial_fit`` loop on the calling thread and publishes a snapshot to
the registry every pass, so an online model refreshes its serving
version under live traffic. The training steps run on that thread's
stream; each replica replays on its own non-blocking stream, so neither
is ordered behind the other, and a publish reaches a replica only
between two of its batches.
"""

from __future__ import annotations

import threading

import numpy as np

from ..wrappers import ParamSwapError
from . import metrics as smetrics
from ._buckets import BucketLadder
from ._server import (
    ModelServer,
    RequestTimeout,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    SloShed,
)
from .policy import admission_verdict, predict_completion_s
from .registry import ModelRegistry

__all__ = ["FleetServer", "NoHealthyReplicas", "serve_while_training"]


class NoHealthyReplicas(ServingError):
    """Every replica is stopped/dead: the fleet cannot place this
    request anywhere. Distinct from ServerOverloaded (transient load)
    — this needs replicas restarted, not a retry."""


def _auto_replicas(devices) -> int:
    """Default replica count: one per card when several exist, else one
    worker (thread replicas are the caller's explicit choice)."""
    return len(devices) if len(devices) > 1 else 1


def _local_devices():
    """The devices replicas are placed on: every card for ``"cuda"``,
    else ``config.device`` alone."""
    import torch

    from ..config import resolve_device

    dev = resolve_device()
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class FleetServer:
    """Serve a registry model through N replica ModelServers.

    Parameters
    ----------
    model : fitted estimator, optional
        Convenience: published into ``registry`` under ``name`` as
        version 1. Omit it to front a name the registry already holds.
    registry : ModelRegistry, default a fresh private one
    name : str, the registry name this fleet follows
    methods : tuple of served method names
    replicas : int, default ``config.serving_replicas``
        (0 = auto: one per local device when several exist, else 1).
        More replicas than devices share devices round-robin.
    ladder / max_queue / batch_window_ms / timeout_ms
        forwarded to every replica (``max_queue`` is PER REPLICA).

    Use as a context manager::

        with FleetServer(clf, replicas=2).warmup() as fleet:
            y = fleet.predict(x)
            fleet.publish(new_clf)      # rolling swap, no capture
    """

    def __init__(self, model=None, registry=None, name="model",
                 methods=("predict",), replicas=None, ladder=None,
                 max_queue=None, batch_window_ms=None, timeout_ms=None,
                 supervise=None, autoscale=None):
        from ..config import get_config

        cfg = get_config()
        self.name = str(name)
        self.registry = registry if registry is not None \
            else ModelRegistry()
        if model is not None:
            self.registry.publish(self.name, model)
        # the fleet is born from the registry's CURRENT version — a
        # registry-only construction requires one to exist
        current = self.registry.get(self.name)
        devices = self._devices = _local_devices()
        n = int(cfg.serving_replicas if replicas is None else replicas)
        if n <= 0:
            n = _auto_replicas(devices)
        self.ladder = ladder if ladder is not None \
            else BucketLadder.from_config()
        self._slo_s = float(cfg.serving_slo_ms) / 1e3
        self._slo_shed = bool(cfg.serving_slo_shed)
        self._methods = tuple(methods)
        # replica ctor args, kept so the supervisor can rebuild a dead
        # replica slot with the fleet's exact configuration
        self._max_queue = max_queue
        self._batch_window_ms = batch_window_ms
        self._timeout_ms = timeout_ms
        self.replicas = tuple(
            self._make_replica(i, current.estimator, current.version)
            for i in range(n)
        )
        self.version = current.version
        self._lock = threading.Lock()   # serializes swaps vs stop
        self._started = False
        self._swaps = 0
        # replica supervision (reliability/supervisor.py): a dead
        # replica is rebuilt off the serving path instead of merely
        # routed around (config.serving_supervise; default off)
        self._supervise = bool(
            cfg.serving_supervise if supervise is None else supervise
        )
        self._supervisor = None
        # SLO-driven replica autoscaling (serving/autoscale.py): the
        # admission predictor ADDS/RETIRES replicas under hysteresis
        # bands (config.serving_autoscale; default off)
        self._autoscale = bool(
            cfg.serving_autoscale if autoscale is None else autoscale
        )
        self._autoscaler = None
        # follow the name: every publish/rollback becomes a rolling
        # swap (the immediate initial callback is version-matched away)
        self._sub = self.registry.subscribe(self.name, self._on_publish)

    def _make_replica(self, i, estimator, version):
        """One replica ModelServer for slot ``i`` with this fleet's
        configuration — shared by construction and the supervisor's
        rebuild path (a replacement must be configured IDENTICALLY to
        the replica it replaces, device placement included)."""
        r = ModelServer(
            estimator, methods=self._methods, ladder=self.ladder,
            max_queue=self._max_queue,
            batch_window_ms=self._batch_window_ms,
            timeout_ms=self._timeout_ms,
            device=self._devices[i % len(self._devices)],
            replica_id=i, name=self.name,
        )
        r.model_version = int(version)
        return r

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        from ..observability.live import register_server, unregister_server

        with self._lock:
            for r in self.replicas:
                r.start()
            self._started = True
        register_server(self)
        for r in self.replicas:
            # the live plane lists the fleet, whose stats() embeds every
            # replica's (two stats() readers would split each replica's
            # windowed-quantile cursor)
            unregister_server(r)
        for r in self.replicas:
            smetrics.set_replica_gauges(r.replica_id,
                                        version=r.model_version,
                                        healthy=True)
        if self._supervise and self._supervisor is None:
            from ..reliability.supervisor import ReplicaSupervisor

            self._supervisor = ReplicaSupervisor(self).start()
        if self._autoscale and self._autoscaler is None:
            from .autoscale import ReplicaAutoscaler

            self._autoscaler = ReplicaAutoscaler(self).start()
        smetrics.set_replica_count_gauge(self.name, len(self.replicas))
        return self

    def stop(self, drain=True, timeout=None):
        from ..observability.live import unregister_server

        unregister_server(self)
        if self._autoscaler is not None:
            # the scaler stands down BEFORE replicas stop — a shutdown
            # emptying the queues must not read as a scale-down signal
            self._autoscaler.stop()
            self._autoscaler = None
        if self._supervisor is not None:
            # the supervisor must stand down BEFORE replicas stop, or
            # it would read the deliberate shutdown as a fleet-wide
            # crash and start rebuilding corpses
            self._supervisor.stop()
            self._supervisor = None
        self.registry.unsubscribe(self.name, self._sub)
        with self._lock:
            self._started = False
            for r in self.replicas:
                r.stop(drain=drain, timeout=timeout)
        for r in self.replicas:
            # unregistered replicas must not leave stale
            # serving_replica_*/queue gauge series latched on /metrics
            smetrics.drop_replica_gauges(r.replica_id)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    def warmup(self):
        """Capture every replica's (method, bucket) graphs (each replica
        owns its own). After this, a ladder workload, with any number of
        same-shape swaps, captures no new graph."""
        for r in self.replicas:
            r.warmup()
        return self

    # -- hot-swap ----------------------------------------------------------
    def _on_publish(self, mv):
        """Registry callback: roll the new version through the
        replicas. A swap with no capture when shapes match; a rebuild
        (fresh graphs, captured before install) when they don't.
        In-flight batches finish on their old version; no request is
        lost."""
        with self._lock:
            # notifications run outside the registry lock, so two
            # back-to-back publishes can deliver out of order; converge
            # to the registry's CURRENT version instead of the notified
            # one (a stale callback then lands as a version-matched
            # no-op, never a downgrade — rollback still applies, since
            # rollback re-points current itself)
            try:
                mv = self.registry.get(self.name)
            except KeyError:
                return
            changed = 0
            for r in self.replicas:
                if r.model_version == mv.version:
                    continue
                q = getattr(mv, "quantize", None)
                try:
                    r.swap_model(mv.estimator, version=mv.version,
                                 quantize=q)
                except ParamSwapError:
                    r.rebuild_model(mv.estimator, version=mv.version,
                                    quantize=q)
                smetrics.set_replica_gauges(r.replica_id,
                                            version=mv.version)
                changed += 1
            self.version = mv.version
            if changed:
                self._swaps += 1

    def publish(self, estimator, tag=None, quantize=None) -> int:
        """Publish a new version of this fleet's model (and hot-swap
        every replica before returning). ``quantize="int8"`` serves the
        version through the replicas' pre-warmed weight-quantized entry
        points (``config.serving_warm_flavors``)."""
        return self.registry.publish(self.name, estimator, tag=tag,
                                     quantize=quantize)

    def rollback(self, version=None) -> int:
        """Roll the fleet back to an archived registry version."""
        return self.registry.rollback(self.name, version=version)

    # -- request plane -----------------------------------------------------
    def _healthy(self):
        return [r for r in self.replicas if r.healthy]

    def submit(self, X, method="predict"):
        """Admit one request: SLO admission at the door, then
        least-loaded placement over healthy replicas with failover.
        Returns the chosen replica's Future."""
        from ..observability import _requests as rtrace

        X = np.asarray(X, np.float32)
        n_rows = 1 if X.ndim == 1 else int(X.shape[0])
        ranked = sorted(self._healthy(),
                        key=lambda r: (r.queue_rows, r._queue.depth))
        if not ranked:
            raise NoHealthyReplicas(
                f"no healthy replicas (0/{len(self.replicas)}); "
                "restart the fleet or its workers"
            )
        if self._slo_s > 0 and self._slo_shed:
            # shed only when EVERY replica's prediction misses (the
            # documented contract): with heterogeneous replicas the
            # least-QUEUED one can still be the slowest-predicted, and
            # shedding off it alone would refuse traffic a sibling
            # would serve inside the SLO. When some replica admits,
            # rotate it to the front so placement honors the
            # prediction (least-loaded order among the rest remains
            # the failover chain).
            admit_at = None
            best_predicted = None
            for i, r in enumerate(ranked):
                predicted = predict_completion_s(
                    r.queue_rows, n_rows, self.ladder.max_rows,
                    r.predict_exec_s(method, n_rows),
                )
                # a replica with no estimate yet predicts None (and
                # admits below); it never ranks as the best prediction
                if predicted is not None and (
                        best_predicted is None or predicted < best_predicted):
                    best_predicted = predicted
                if admission_verdict(predicted, self._slo_s):
                    admit_at = i
                    break
            if admit_at is None:
                smetrics.record_drop("slo_shed")
                if rtrace.tracing_enabled():
                    # a shed request never reaches a replica's _admit, so
                    # its trace is born and finished at the door (the
                    # tail sampler always keeps slo_shed traces)
                    tr = rtrace.new_trace(method, n_rows)
                    tr.tag(slo_shed=True)
                    tr.finish("slo_shed")
                raise SloShed(
                    f"predicted completion {best_predicted * 1e3:.1f}ms "
                    f"on the best of {len(ranked)} healthy replica(s) "
                    f"exceeds the {self._slo_s * 1e3:.0f}ms SLO; "
                    "request shed"
                )
            if admit_at:
                ranked = ranked[admit_at:] + ranked[:admit_at]
        last_exc = None
        rerouted_from = None
        for i, r in enumerate(ranked):
            try:
                if rerouted_from is not None:
                    # the surviving replica's trace records where the
                    # request came from (a thread-local pending tag that
                    # the replica's _admit picks up)
                    with rtrace.tagging(rerouted_from=rerouted_from):
                        return r.submit(X, method=method)
                return r.submit(X, method=method)
            except ServerClosed as exc:
                # the replica died between the health check and the put:
                # its own queue resolves typed, THIS request fails over to
                # the next-least-loaded survivor, and the dead replica's
                # gauge series are dropped
                last_exc = exc
                smetrics.record_reroute()
                smetrics.drop_replica_gauges(r.replica_id)
                rerouted_from = r.replica_id
            except ServerOverloaded as exc:
                last_exc = exc
                if i + 1 < len(ranked):
                    smetrics.record_reroute()
                    rerouted_from = r.replica_id
        if isinstance(last_exc, ServerClosed):
            raise NoHealthyReplicas(
                f"every replica refused this request; last: {last_exc}"
            ) from last_exc
        raise last_exc

    # blocking conveniences ------------------------------------------------
    def _call(self, X, method):
        import concurrent.futures as cf

        fut = self.submit(X, method=method)
        timeout_s = self.replicas[0].timeout_s
        try:
            return fut.result(None if timeout_s <= 0
                              else 30.0 + timeout_s)
        except cf.TimeoutError:
            raise RequestTimeout(
                f"fleet {method} did not complete within the "
                f"{timeout_s * 1e3:.0f}ms deadline + 30s execution "
                "allowance"
            ) from None

    def predict(self, X):
        return self._call(X, "predict")

    def predict_proba(self, X):
        return self._call(X, "predict_proba")

    def decision_function(self, X):
        return self._call(X, "decision_function")

    def transform(self, X):
        return self._call(X, "transform")

    def _flush_quality(self):
        """Fold every replica's pending drift sample now (the live plane
        lists the fleet, not its replicas: ``drift.compute`` reaches them
        through this)."""
        for r in self.replicas:
            r._flush_quality()

    # -- stats -------------------------------------------------------------
    def stats(self):
        """Fleet aggregate and per-replica breakdown: totals sum over
        replicas; ``replicas`` carries each worker's own stats()."""
        per = [r.stats() for r in self.replicas]
        return {
            "fleet": self.name,
            "version": self.version,
            "n_replicas": len(self.replicas),
            "healthy_replicas": sum(1 for r in self.replicas
                                    if r.healthy),
            "swaps": self._swaps,
            "requests": sum(p["requests"] for p in per),
            "batches": sum(p["batches"] for p in per),
            "queue_depth": sum(p["queue_depth"] for p in per),
            "queue_rows": sum(p["queue_rows"] for p in per),
            "replicas": per,
        }


def serve_while_training(fleet, incremental, X, y=None, passes=1,
                         classes=None, on_pass=None):
    """The serve-while-training loop: run ``passes`` streamed
    ``partial_fit`` passes of an :class:`~dask_ml_tpu.wrappers.
    Incremental` (or any estimator exposing ``partial_fit`` +
    ``estimator_``) and publish a snapshot to ``fleet``'s registry after
    EVERY pass: each publish rolls a hot-swap that captures no graph
    through the replicas while they keep answering traffic.

    ``classes`` is required for classifiers on a fresh model (the first
    ``partial_fit`` needs the label universe). ``on_pass(pass_no,
    version)`` observes each flip (progress bars, tests). Returns the
    trained ``incremental``.
    """
    # pass-granular resume: with config.stream_checkpoint_path set the
    # wrapper tracks ``completed_passes_`` across kills; the checkpoint
    # is restored before the first pass and ``passes`` is the TOTAL
    # target, so a loop killed after its final pass resumes to no
    # remaining work. Without checkpoints the loop runs ``passes``.
    done = 0
    resume = getattr(incremental, "resume_from_checkpoint", None)
    if resume is not None:
        try:
            kw = {} if classes is None else {"classes": classes}
            done = int(resume(X, y, **kw) or 0)
        except Exception:
            done = 0
    p_done = done
    for _ in range(max(int(passes) - done, 0) if done
                   else int(passes)):
        if classes is not None:
            incremental.partial_fit(X, y, classes=classes)
        elif y is not None:
            incremental.partial_fit(X, y)
        else:
            incremental.partial_fit(X)
        tracked = getattr(incremental, "completed_passes_", None)
        p_done = int(tracked) if tracked is not None else p_done + 1
        est = getattr(incremental, "estimator_", incremental)
        version = fleet.publish(est, tag=f"pass{p_done}")
        if on_pass is not None:
            on_pass(p_done, version)
        if tracked is not None and p_done >= int(passes):
            break
    # the pass sequence completed: the checkpoint slot must not resume
    # into a future training run
    getattr(incremental, "_clear_pass_checkpoint", lambda: None)()
    return incremental
