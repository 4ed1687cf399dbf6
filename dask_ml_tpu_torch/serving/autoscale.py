"""SLO-driven replica autoscaling: the admission predictor grows the
fleet instead of only shedding at its door.

Counterpart of ``dask_ml_tpu/serving/autoscale.py``.
:class:`ReplicaAutoscaler` polls the fleet's admission signal (queued
rows times the windowed per-(method, bucket) execution quantile: the
best healthy replica's predicted completion for a top-bucket request)
and moves the replica count under hysteresis bands:

- above the **up band** (default 80 % of ``serving_slo_ms``) for
  ``patience`` consecutive ticks it ADDS a replica, built by the fleet's
  own ``_make_replica`` and warmed (its graphs captured) off the serving
  path before it joins routing under the fleet lock;
- below the **down band** (default 20 %) for ``patience`` ticks it
  RETIRES the least-loaded replica: out of routing first, then drained
  (``stop(drain=True)``), its gauge series dropped;
- a ``cooldown_s`` refractory after every action stops flapping, and
  ``[min, max]`` bound the fleet.

``serving_scale_ups``/``serving_scale_downs`` count the moves and
:attr:`ReplicaAutoscaler.events` records them (kind, replicas after,
seconds). Armed by ``FleetServer.start()`` when
``config.serving_autoscale`` is on (default off).
"""

from __future__ import annotations

import threading
import time

from . import metrics as smetrics
from .policy import predict_completion_s

__all__ = ["ReplicaAutoscaler"]


class ReplicaAutoscaler:
    """Watch one fleet; scale its replica count to the SLO signal."""

    def __init__(self, fleet, min_replicas=None, max_replicas=None,
                 interval_s=None, up_ms=None, down_ms=None,
                 patience=None, cooldown_s=None):
        from ..config import get_config

        cfg = get_config()
        self.fleet = fleet
        self.min = max(1, int(cfg.serving_autoscale_min
                              if min_replicas is None else min_replicas))
        self.max = max(self.min, int(cfg.serving_autoscale_max
                                     if max_replicas is None
                                     else max_replicas))
        self.interval_s = float(cfg.serving_autoscale_interval_s
                                if interval_s is None else interval_s)
        slo_ms = float(cfg.serving_slo_ms)
        up = float(cfg.serving_autoscale_up_ms if up_ms is None
                   else up_ms)
        down = float(cfg.serving_autoscale_down_ms if down_ms is None
                     else down_ms)
        # 0 = derive the bands from the SLO itself; an explicit band
        # decouples scaling from shedding (scale at 80%, shed at 100%)
        self.up_ms = up if up > 0 else 0.8 * slo_ms
        self.down_ms = down if down > 0 else 0.2 * slo_ms
        self.patience = max(1, int(cfg.serving_autoscale_patience
                                   if patience is None else patience))
        self.cooldown_s = float(cfg.serving_autoscale_cooldown_s
                                if cooldown_s is None else cooldown_s)
        self._cfg = cfg          # the scaler thread re-applies it
        self._above = 0
        self._below = 0
        self._t_last_scale = 0.0
        self.events: list[tuple] = []   # (kind, n_after, seconds)
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dask-ml-tpu-torch-autoscaler",
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

    # -- loop --------------------------------------------------------------
    def _run(self):
        from .. import config

        # the config is thread-local: captures, counters and the plans
        # plane on this thread follow the fleet creator's config
        with config.use(self._cfg):
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    # scaling must never take the process down; the
                    # next tick retries
                    pass

    # -- signal ------------------------------------------------------------
    def signal_ms(self):
        """The scale signal: the BEST healthy replica's predicted
        completion (ms) for a top-bucket request — exactly what the SLO
        admission door computes, so "the door is about to shed" and
        "the scaler should add a replica" read the same number. None
        while no execution estimate exists (a cold fleet neither grows
        nor shrinks on ignorance)."""
        fleet = self.fleet
        method = fleet._methods[0]
        top = fleet.ladder.max_rows
        best = None
        for r in fleet.replicas:
            if not r.healthy:
                continue
            pred = predict_completion_s(
                r.queue_rows, top, top, r.predict_exec_s(method, top))
            if pred is not None and (best is None or pred < best):
                best = pred
        return None if best is None else best * 1e3

    def tick(self):
        """One evaluation (also callable directly from tests — the
        thread is just this on a timer)."""
        fleet = self.fleet
        if not getattr(fleet, "_started", False) or self.up_ms <= 0:
            return
        n = len(fleet.replicas)
        smetrics.set_replica_count_gauge(fleet.name, n)
        sig = self.signal_ms()
        if sig is None:
            self._above = self._below = 0
            return
        if sig > self.up_ms:
            self._above += 1
            self._below = 0
        elif sig < self.down_ms:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if time.monotonic() - self._t_last_scale < self.cooldown_s:
            return
        if self._above >= self.patience and n < self.max:
            self.scale_up()
        elif self._below >= self.patience and n > self.min:
            self.scale_down()

    # -- actions -----------------------------------------------------------
    def scale_up(self) -> float:
        """Add one replica at the registry's current version, warmed
        BEFORE it joins routing. Returns spin-up seconds (its graph
        captures included)."""
        from ..observability.live import unregister_server

        fleet = self.fleet
        t0 = time.perf_counter()
        try:
            mv = fleet.registry.get(fleet.name)
        except KeyError:
            return 0.0
        new_id = max((r.replica_id for r in fleet.replicas),
                     default=-1) + 1
        fresh = fleet._make_replica(new_id, mv.estimator, mv.version)
        q = getattr(mv, "quantize", None)
        if q:
            fresh.rebuild_model(mv.estimator, version=mv.version,
                                warm=False, quantize=q)
        fresh.warmup()          # captures land HERE, not on traffic
        fresh.start()
        unregister_server(fresh)    # the fleet entry covers it
        with fleet._lock:
            if not fleet._started:
                fresh.stop(drain=False)
                return 0.0
            fleet.replicas = fleet.replicas + (fresh,)
        dt = time.perf_counter() - t0
        self._t_last_scale = time.monotonic()
        self._above = self._below = 0
        smetrics.record_scale_up()
        smetrics.set_replica_gauges(new_id, version=fresh.model_version,
                                    healthy=True)
        smetrics.set_replica_count_gauge(fleet.name,
                                         len(fleet.replicas))
        self.events.append(("up", len(fleet.replicas), round(dt, 6)))
        return dt

    def scale_down(self) -> bool:
        """Retire the least-loaded replica: out of routing FIRST (no
        new work lands on it), then a graceful drain (queued requests
        complete on its worker), then its gauge series dropped."""
        fleet = self.fleet
        t0 = time.perf_counter()
        with fleet._lock:
            if not fleet._started or len(fleet.replicas) <= self.min:
                return False
            victim = min(fleet.replicas,
                         key=lambda r: (r.queue_rows, -r.replica_id))
            fleet.replicas = tuple(r for r in fleet.replicas
                                   if r is not victim)
        victim._accepting = False
        victim.stop(drain=True)
        dt = time.perf_counter() - t0
        self._t_last_scale = time.monotonic()
        self._above = self._below = 0
        smetrics.record_scale_down()
        # a retired replica leaves no stale gauge series
        smetrics.drop_replica_gauges(victim.replica_id)
        smetrics.set_replica_count_gauge(fleet.name,
                                         len(fleet.replicas))
        self.events.append(("down", len(fleet.replicas),
                            round(dt, 6)))
        return True
