"""Observability of the port.

Counterpart of ``dask_ml_tpu/observability``, under the JAX package's
names:

- ``_metrics``: ``MetricsLogger`` (the JSONL sink), ``fit_logger`` (the
  per-fit sink on ``config.metrics_path``), ``active_logger`` and
  ``emit_step`` (one record per solver iteration, a host call), ``timed``
  and ``profile_trace`` (a ``torch.profiler`` window);
- ``_spans``: ``span(name, **attrs)``, nested span records with wall
  time, device-sync time, parent ids and counter deltas, and the
  open-span registry the watchdog and ``/status`` read;
- ``_counters``: the counter registry, the host-to-device byte counters
  and ``device_memory_gauges``;
- ``_programs`` and ``_peak``: the kernel registry, each hand-written
  CUDA kernel's launches and CUDA-event times against the bound of its
  work on the card, and a row for each tracked program (a plan's graph
  set, ``track_program``) (``config.obs_programs``);
- ``_watchdog``: the slow-span watchdog (``config.watchdog_timeout_s``);
- ``live``: the metric registry and the HTTP exporter (``/metrics``,
  ``/healthz``, ``/status``; ``config.obs_http_port``);
- ``report``: ``python -m dask_ml_tpu_torch.observability.report
  metrics.jsonl`` (``--json``, ``--merge``, ``--perfetto``, ``--watch``);
- ``export``: span records to Chrome-trace / Perfetto JSON;
- ``_hist`` and ``sketch``: the histograms of the servers and the
  streamed fits' training profiles.

Every knob at its default makes each instrumented site config reads:
no thread, no file, no device sync. The names of the request traces,
drift scoring of served traffic, alerts, incidents and fleet federation
(ROADMAP.md queue 1, Observability, part 2) raise ``NotImplementedError``
when asked for, as do the JAX names that have no counterpart here
(ROADMAP.md, "Not to be ported").
"""

from ._counters import (
    counter_add,
    counters_enabled,
    counters_reset,
    counters_snapshot,
    device_memory_gauges,
    log_counters,
    record_fault_injected,
    record_registry_publish,
    record_replica_failure,
    record_replica_restart,
    record_serving_batch,
    record_serving_drop,
    record_serving_request,
    record_serving_reroute,
    record_serving_slo_violation,
    record_serving_swap,
    record_sparse_spill,
    record_stream_checkpoint,
    record_stream_quarantine,
    record_stream_retry,
    record_transfer,
)
from ._hist import Histogram, merge_snapshots, percentiles_from, \
    snapshot_delta
from ._metrics import (
    MetricsLogger,
    _active_lock,
    _active_loggers,
    active_logger,
    emit_step,
    fit_logger,
    profile_trace,
    timed,
)
from ._programs import (
    log_programs,
    programs_enabled,
    programs_reset,
    programs_snapshot,
    track_program,
)
from ._spans import (
    NOOP_SPAN,
    add_span_observer,
    current_span_id,
    open_spans_snapshot,
    remove_span_observer,
    span,
)
from ._watchdog import Watchdog, watchdog, watchdog_active
from .live import (
    TelemetryServer,
    ensure_telemetry,
    gauge_set,
    live_publishing,
    publish_progress,
    render_prometheus,
    status_data,
    stop_telemetry,
    telemetry_server,
)
from .sketch import (CategoricalSketch, FeatureSketch, merge_profiles,
                     profile_from_dict)

# the JAX name of the per-iteration record: the port's loops run on the
# host, so the record is a plain call either way
emit_jit_step = emit_step

_PART_2 = "ROADMAP.md queue 1, Observability, part 2"
_OWED = {
    # request traces (_requests.py)
    "load_capture": _PART_2, "replay": _PART_2,
    "tracing_enabled": _PART_2, "traces_data": _PART_2,
    "traces_reset": _PART_2,
    # alerts.py, which also takes the watchdog's stall events
    "AlertEngine": _PART_2, "AlertRule": _PART_2,
    "AlertRuleError": _PART_2, "alerts_data": _PART_2,
    "ensure_engine": _PART_2, "note_event": _PART_2,
    "parse_rules": _PART_2, "stop_engine": _PART_2,
    # incidents.py
    "capture_incident": _PART_2, "deep_profile": _PART_2,
    "incidents_data": _PART_2, "load_bundles": _PART_2,
    # fleet.py
    "MetricsFederator": _PART_2, "SLO_BURN_BUDGET": _PART_2,
}
_NOT_PORTED = {
    "jit_callbacks_supported": "the port's step records are plain host "
                               "calls, there is no callback to probe",
    "reset_jit_callbacks_probe": "the port's step records are plain host "
                                 "calls, there is no callback to probe",
    "start_profiler_server": "jax.profiler.start_server has no PyTorch "
                             "counterpart",
    "count_recompiles": "a CUDA graph capture is counted as "
                        "graph_captures where it happens",
    "install_recompile_tracking": "a CUDA graph capture is counted as "
                                  "graph_captures where it happens",
    "record_donation": "XLA buffer donation has no counterpart",
    "record_superblock_donation": "XLA buffer donation has no "
                                  "counterpart",
    "record_superblock": "the port streams one block per launch, with no "
                         "super-block scan",
    "record_zero_copy": "an XLA:CPU dlpack alias has no counterpart",
    "record_shard_staging": "one device per process: blocks are not "
                            "staged as per-device shards",
    "record_sparse_staging": "the sparse stream's sizes are on "
                             "solver_info_ and stream_stats_",
    "record_gspmd_reduce": "no implicit GSPMD reduce: the process "
                           "plane's collectives are counted in "
                           "parallel.distributed.plane_stats",
}


def __getattr__(name):
    if name in _OWED:
        raise NotImplementedError(
            f"dask_ml_tpu_torch.observability.{name} is not ported yet: "
            f"{_OWED[name]}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dask_ml_tpu_torch.observability.{name} is not ported "
            f"(ROADMAP.md, Not to be ported): {_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CategoricalSketch",
    "FeatureSketch",
    "Histogram",
    "MetricsLogger",
    "NOOP_SPAN",
    "TelemetryServer",
    "Watchdog",
    "active_logger",
    "add_span_observer",
    "counter_add",
    "counters_enabled",
    "counters_reset",
    "counters_snapshot",
    "current_span_id",
    "device_memory_gauges",
    "emit_jit_step",
    "emit_step",
    "ensure_telemetry",
    "fit_logger",
    "gauge_set",
    "live_publishing",
    "log_counters",
    "log_programs",
    "merge_profiles",
    "merge_snapshots",
    "open_spans_snapshot",
    "percentiles_from",
    "profile_from_dict",
    "profile_trace",
    "programs_enabled",
    "programs_reset",
    "programs_snapshot",
    "publish_progress",
    "record_fault_injected",
    "record_registry_publish",
    "record_replica_failure",
    "record_replica_restart",
    "record_serving_batch",
    "record_serving_drop",
    "record_serving_request",
    "record_serving_reroute",
    "record_serving_slo_violation",
    "record_serving_swap",
    "record_sparse_spill",
    "record_stream_checkpoint",
    "record_stream_quarantine",
    "record_stream_retry",
    "record_transfer",
    "remove_span_observer",
    "render_prometheus",
    "snapshot_delta",
    "span",
    "status_data",
    "stop_telemetry",
    "telemetry_server",
    "timed",
    "track_program",
    "watchdog",
    "watchdog_active",
]
