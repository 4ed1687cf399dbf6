"""Replica supervision: dead fleet replicas get REBUILT, not mourned.

Counterpart of ``dask_ml_tpu/reliability/supervisor.py``.
:class:`ReplicaSupervisor` is the background daemon that closes the
fleet's failover loop:

- it polls the fleet's replicas (``config.serving_supervise_interval_s``)
  and, for each one whose worker thread died, builds a FRESH
  :class:`~dask_ml_tpu_torch.serving.ModelServer` at the registry's
  CURRENT version off the serving path: the replacement captures its
  (method, bucket) graphs on the supervisor thread, on its own stream,
  while the survivors keep answering, and only then joins the routing
  tuple;
- the dead replica's queued requests are drained onto the fresh replica
  (counted as reroutes), so a worker crash loses no admitted request;
- restarts are budgeted per replica slot
  (``config.serving_restart_budget``): a crash-looping replica degrades
  to PERMANENT failover (its gauges dropped, its queue failed typed);
- a publish racing the rebuild converges: the fresh replica is checked
  against the registry's current version after installation.

Armed by ``FleetServer.start()`` when ``config.serving_supervise`` is on
(default off).
"""

from __future__ import annotations

import threading

__all__ = ["ReplicaSupervisor"]


class ReplicaSupervisor:
    """Watch one fleet; rebuild dead replicas off the serving path."""

    def __init__(self, fleet, interval_s=None, budget=None):
        from ..config import get_config

        cfg = get_config()
        self.fleet = fleet
        self.interval_s = float(
            cfg.serving_supervise_interval_s if interval_s is None
            else interval_s
        )
        self.budget = int(
            cfg.serving_restart_budget if budget is None else budget
        )
        self._cfg = cfg          # the supervisor thread re-applies it
        self._restarts: dict[int, int] = {}   # replica slot -> restarts
        self._failed: set[int] = set()        # permanently failed slots
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dask-ml-tpu-torch-replica-supervisor",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def restarts(self) -> dict:
        return dict(self._restarts)

    # -- loop --------------------------------------------------------------
    def _run(self):
        from .. import config

        # the config is thread-local: captures, counters and fault
        # gates on this thread follow the fleet creator's config
        with config.use(self._cfg):
            while not self._stop.wait(self.interval_s):
                try:
                    self._sweep()
                except Exception:
                    # supervision must never take the process down; the
                    # next tick retries
                    pass

    def _sweep(self):
        fleet = self.fleet
        if not getattr(fleet, "_started", False):
            return
        for idx, r in enumerate(fleet.replicas):
            if r.healthy or idx in self._failed:
                continue
            used = self._restarts.get(idx, 0)
            if used >= self.budget:
                self._permanent_failure(idx, r)
                continue
            self._restarts[idx] = used + 1
            self._restart(idx, r)

    # -- actions -----------------------------------------------------------
    def _restart(self, idx, dead):
        """Rebuild replica slot ``idx`` at the registry's current
        version, warmed BEFORE it rejoins routing."""
        from ..observability._counters import record_replica_restart
        from ..serving import metrics as smetrics

        fleet = self.fleet
        dead._accepting = False     # new traffic routes around it now
        try:
            mv = fleet.registry.get(fleet.name)
        except KeyError:
            return
        fresh = fleet._make_replica(idx, mv.estimator, mv.version)
        q = getattr(mv, "quantize", None)
        if q:
            # the constructor builds the f32 flavour; a quantized
            # current version installs by the rebuild path (off the
            # serving path here)
            fresh.rebuild_model(mv.estimator, version=mv.version,
                                warm=False, quantize=q)
        if getattr(dead, "_warmed", False):
            fresh.warmup()          # captures land HERE, not on traffic
        fresh.start()
        with fleet._lock:
            if not fleet._started:
                fresh.stop(drain=False)
                return
            reps = list(fleet.replicas)
            reps[idx] = fresh
            fleet.replicas = tuple(reps)
        record_replica_restart()
        smetrics.set_replica_gauges(fresh.replica_id,
                                    version=fresh.model_version,
                                    healthy=True)
        self._requeue(dead, fresh)
        # a publish may have landed while the rebuild ran; converge to
        # the registry's CURRENT version like fleet._on_publish does
        try:
            cur = fleet.registry.get(fleet.name)
        except KeyError:
            cur = None
        if cur is not None and cur.version != fresh.model_version:
            from ..wrappers import ParamSwapError

            qv = getattr(cur, "quantize", None)
            try:
                fresh.swap_model(cur.estimator, version=cur.version,
                                 quantize=qv)
            except ParamSwapError:
                fresh.rebuild_model(cur.estimator, version=cur.version,
                                    quantize=qv)

    def _requeue(self, dead, fresh):
        """Drain the dead replica's admitted-but-unserved requests onto
        the fresh one — zero admitted requests lost to a worker crash."""
        from ..serving import metrics as smetrics
        from ..serving._batching import fail_requests

        try:
            reqs = dead._queue.drain_all()
        except Exception:
            return
        if not reqs:
            return
        for r in reqs:
            # a requeued trace records the replica it drained off, as the
            # fleet's failover tags a rerouted request
            if r.trace is not None:
                r.trace.tag(rerouted_from=dead.replica_id,
                            replica=fresh.replica_id)
        verdict = fresh._queue.put_many(reqs)
        if verdict == "ok":
            for _ in reqs:
                smetrics.record_reroute()
            return
        from ..serving._server import ServerClosed

        fail_requests(reqs, ServerClosed(
            "replica died and its replacement could not absorb the "
            "backlog"), outcome="closed")

    def _permanent_failure(self, idx, dead):
        """Budget exhausted: the slot degrades to permanent failover, its
        queue failed typed and its per-replica gauges dropped."""
        from ..observability._counters import record_replica_failure
        from ..serving import metrics as smetrics
        from ..serving._batching import fail_requests
        from ..serving._server import ServerClosed

        self._failed.add(idx)
        dead._accepting = False
        try:
            fail_requests(dead._queue.drain_all(), ServerClosed(
                f"replica {dead.replica_id} exceeded its restart budget "
                f"({self.budget}); permanently failed over"),
                outcome="closed")
        except Exception:
            pass
        record_replica_failure()
        smetrics.drop_replica_gauges(dead.replica_id)
