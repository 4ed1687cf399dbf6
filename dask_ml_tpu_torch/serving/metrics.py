"""Serving telemetry: per-batch spans, counters, latency histograms and
SLO accounting.

Counterpart of ``dask_ml_tpu/serving/metrics.py``. Everything funnels
through the port's ``observability``: one ``serving.batch`` span per
executed micro-batch (bucket, occupancy, and the counter deltas it
caused, so a graph captured mid-serving shows on the batch that paid
it), the counter registry for the run totals
(``serving_requests``/``serving_rows``, ``serving_batches``/
``serving_padded_rows``, ``serving_shed``/``serving_timeouts``/
``serving_errors``, ``serving_slo_violations``, and the federation's
``serving_process_reroutes``/``serving_process_failovers``/
``federation_publishes``), and the in-process
metric registry for the per-(method, bucket) latency histograms and the
queue and replica gauges, written only while an exporter publishes.
:class:`LatencyWindow` is the server-local latency summary.
"""

from __future__ import annotations

from ..observability import span
from ..observability._counters import (
    record_federation_publish,
    record_process_failover,
    record_process_reroute,
    record_registry_publish,
    record_scale_down,
    record_scale_up,
    record_serving_batch,
    record_serving_drop,
    record_serving_request,
    record_serving_reroute,
    record_serving_slo_violation,
    record_serving_swap,
)
from ..observability._hist import (
    Histogram,
    percentiles_from,
    snapshot_delta,
)
from ..observability.live import gauge_set, histogram, live_publishing

__all__ = ["LatencyWindow", "batch_span", "drop_replica_gauges",
           "drop_process_gauges", "record_batch", "record_request",
           "record_drop", "observe_request_latency", "set_queue_gauges",
           "set_replica_gauges", "set_process_gauges",
           "set_replica_count_gauge", "record_swap", "record_reroute",
           "record_publish", "record_scale_up", "record_scale_down",
           "record_process_reroute", "record_process_failover",
           "record_federation_publish"]

# counter recording lives in observability/_counters.py; these are the
# serving package's local names for it
record_request = record_serving_request
record_batch = record_serving_batch
record_drop = record_serving_drop
record_swap = record_serving_swap
record_reroute = record_serving_reroute
record_publish = record_registry_publish


def batch_span(method: str, bucket: int, rows: int, n_requests: int,
               queue_depth: int):
    """The per-batch span: one JSONL record per executed micro-batch
    with the occupancy and padding a capacity review needs; the shared
    no-op when nothing records."""
    return span(
        "serving.batch", method=method, bucket=bucket, rows=rows,
        n_requests=n_requests, queue_depth=queue_depth,
        occupancy=round(rows / bucket, 4),
    )


def observe_request_latency(method: str, bucket: int,
                            seconds: float) -> None:
    """One request's end-to-end latency (enqueue -> demux) into the
    process-wide per-(method, bucket) histogram series, plus the SLO
    violation counter when ``config.serving_slo_ms`` is set. Called by
    the worker per request per batch — one bisect + dict adds, no
    device interaction. The histogram series is gated like the queue
    gauges (same no-exporter-nobody-pays rule): ``LatencyWindow``
    already keeps the run's latency summary, so without a live server
    the registry write is pure dead work; the SLO counter stays
    unconditional — it feeds the report counters table, server or not."""
    if live_publishing():
        histogram(
            "serving_latency_seconds",
            labels=(("method", str(method)),
                    ("bucket", str(int(bucket)))),
        ).observe(seconds)
    from ..config import get_config

    slo_ms = get_config().serving_slo_ms
    if slo_ms and seconds * 1e3 > slo_ms:
        record_serving_slo_violation()


def set_queue_gauges(depth: int, inflight_rows: int,
                     replica=None) -> None:
    """Live queue-depth / inflight gauges (scraped via /metrics). Only
    written while a telemetry server is up — the steady-state serving
    loop must not pay dict writes for an exporter nobody runs. A fleet
    replica labels its series (``replica="0"``...) so per-replica load
    imbalance is visible on one scrape; a standalone server keeps the
    unlabeled family."""
    if not live_publishing():
        return
    labels = () if replica is None else (("replica", str(replica)),)
    gauge_set("serving_queue_depth", depth, labels)
    gauge_set("serving_inflight_rows", inflight_rows, labels)


def drop_replica_gauges(replica) -> None:
    """Remove a dead/unregistered replica's labeled gauge series
    (``serving_replica_version`` / ``serving_replica_healthy`` and its
    ``serving_queue_depth`` / ``serving_inflight_rows`` children) from
    the live registry, so a replica marked dead leaves no stale series
    (nor holds cardinality-cap slots live replicas need)."""
    from ..observability.live import drop_labeled_series

    labels = (("replica", str(replica)),)
    for family in ("serving_replica", "serving_queue_depth",
                   "serving_inflight_rows"):
        drop_labeled_series(family, labels)


def set_replica_count_gauge(fleet, n: int) -> None:
    """The autoscaler's headline gauge: how many replicas ``fleet`` is
    running now (``serving_replicas{fleet=...}``) —
    scale-ups/downs move it, the ``serving_scale_ups/downs_total``
    counters say how often."""
    if not live_publishing():
        return
    gauge_set("serving_replicas", int(n), (("fleet", str(fleet)),))


def set_process_gauges(process, healthy=None, replicas=None) -> None:
    """Per-process federation gauges: the router's view of each fleet
    process (``serving_process_healthy``, ``serving_process_replicas``,
    the remote /status replica count)."""
    if not live_publishing():
        return
    labels = (("process", str(process)),)
    if healthy is not None:
        gauge_set("serving_process_healthy", 1 if healthy else 0,
                  labels)
    if replicas is not None:
        gauge_set("serving_process_replicas", int(replicas), labels)


def drop_process_gauges(process) -> None:
    """Remove a dead fleet process's labeled gauge series from the live
    registry (the federation's twin of :func:`drop_replica_gauges`):
    /metrics never latches a process after its failover."""
    from ..observability.live import drop_labeled_series

    drop_labeled_series("serving_process", (("process", str(process)),))


def set_replica_gauges(replica, version=None, healthy=None) -> None:
    """Per-replica served-model-version + health gauges — the /metrics
    view of a rolling hot-swap (each replica's version gauge flips as
    the swap reaches it) and of failover (healthy drops to 0)."""
    if not live_publishing():
        return
    labels = (("replica", str(replica)),)
    if version is not None:
        gauge_set("serving_replica_version", int(version), labels)
    if healthy is not None:
        gauge_set("serving_replica_healthy", 1 if healthy else 0,
                  labels)


class LatencyWindow:
    """Histogram-backed latency summary (seconds): thread-safe O(1)
    ``observe`` from the serving worker, quantile reads from any thread
    without touching the writer's path; the histogram keeps the whole
    run. ``size`` is accepted for the JAX signature and ignored."""

    __slots__ = ("_hist",)

    def __init__(self, size=None, bounds=None):
        self._hist = Histogram(bounds)

    @property
    def count(self) -> int:
        return self._hist.count

    def observe(self, seconds: float) -> None:
        self._hist.observe(seconds)

    def percentiles(self, qs=(50, 99)) -> dict:
        return self._hist.percentiles(qs)

    def snapshot(self) -> dict:
        return self._hist.snapshot()

    def percentiles_between(self, prev_snapshot, qs=(50, 99),
                            cur=None) -> dict:
        """Quantiles over the WINDOW since ``prev_snapshot`` (a
        ``snapshot()`` the caller took earlier; None = lifetime). The
        windowed view the fleet's routing/admission and
        ``ModelServer.stats()`` ride — a recent degradation shows up
        immediately instead of being diluted by a long fast history.

        Pass ``cur`` when the caller already snapshotted (and is, say,
        advancing a cursor to that same snapshot): computing the delta
        from a SECOND fresh snapshot would double-count observations
        landing between the two in this window and the next."""
        return percentiles_from(
            snapshot_delta(self.snapshot() if cur is None else cur,
                           prev_snapshot), qs
        )
