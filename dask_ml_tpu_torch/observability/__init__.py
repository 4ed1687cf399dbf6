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
- ``_requests``: the servers' request traces (``config.obs_trace_sample``):
  stage stamps through queue, pack, execute and demux, the tail sampler,
  per-stage exemplar histograms, ``/traces``, and the ``req_capture``
  records ``load_capture`` and ``replay`` read back;
- ``drift``: train-vs-serve, window and canary drift scores (PSI, KS)
  over the servers' sketches, the drift monitor (``config.obs_drift``);
- ``alerts``: the alert engine (``config.obs_alert_rules``): declarative
  rules and built-ins over the counters and gauges, firing and resolved
  states, ``alerts_firing`` gauges, ``/alerts``;
- ``incidents``: incident bundles (``config.incident_dir``), atomic and
  rate-limited, and ``deep_profile``, a ``torch.profiler`` window of the
  card (``POST /profile``);
- ``live``: the metric registry and the HTTP exporter (``/metrics``,
  ``/healthz``, ``/status``, ``/status/fleet``, ``/traces``,
  ``/alerts``, ``POST /profile``, ``POST /fleet/<name>/<op>``;
  ``config.obs_http_port``);
- ``fleet``: ``MetricsFederator``, the fleet metrics federation
  (``config.obs_fleet_federate``): it rides a ``FederatedFleet``
  router's status poller and folds every process's counters (summed),
  gauges (a ``process`` label) and histograms (merged bucket for bucket)
  into the router's ``dask_ml_tpu_fleet_*`` families and
  ``/status/fleet``, with the fleet SLO burn rate against
  ``SLO_BURN_BUDGET``;
- ``report``: ``python -m dask_ml_tpu_torch.observability.report
  metrics.jsonl`` (``--json``, ``--merge``, ``--perfetto``, ``--watch``,
  ``--incidents DIR``);
- ``export``: span records to Chrome-trace / Perfetto JSON;
- ``_hist`` and ``sketch``: the histograms of the servers, the streamed
  fits' training profiles and the servers' serving sketches.

Every knob at its default makes each instrumented site one config read
or one flag test: no thread, no file, no device sync. The JAX names
that have no counterpart here raise ``NotImplementedError`` (ROADMAP.md,
"Not to be ported").
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
from ._requests import (
    load_capture,
    replay,
    tracing_enabled,
    traces_data,
    traces_reset,
)
from ._watchdog import Watchdog, watchdog, watchdog_active
from .fleet import SLO_BURN_BUDGET, MetricsFederator
from .alerts import (
    AlertEngine,
    AlertRule,
    AlertRuleError,
    alerts_data,
    ensure_engine,
    note_event,
    parse_rules,
    stop_engine,
)
from .incidents import (
    capture_incident,
    deep_profile,
    incidents_data,
    load_bundles,
)
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dask_ml_tpu_torch.observability.{name} is not ported "
            f"(ROADMAP.md, Not to be ported): {_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AlertEngine",
    "AlertRule",
    "AlertRuleError",
    "CategoricalSketch",
    "FeatureSketch",
    "Histogram",
    "MetricsFederator",
    "MetricsLogger",
    "NOOP_SPAN",
    "SLO_BURN_BUDGET",
    "TelemetryServer",
    "Watchdog",
    "active_logger",
    "add_span_observer",
    "alerts_data",
    "capture_incident",
    "counter_add",
    "counters_enabled",
    "counters_reset",
    "counters_snapshot",
    "current_span_id",
    "deep_profile",
    "device_memory_gauges",
    "emit_jit_step",
    "emit_step",
    "ensure_engine",
    "ensure_telemetry",
    "fit_logger",
    "gauge_set",
    "incidents_data",
    "live_publishing",
    "load_bundles",
    "load_capture",
    "log_counters",
    "log_programs",
    "merge_profiles",
    "merge_snapshots",
    "note_event",
    "open_spans_snapshot",
    "parse_rules",
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
    "replay",
    "snapshot_delta",
    "span",
    "status_data",
    "stop_engine",
    "stop_telemetry",
    "telemetry_server",
    "timed",
    "traces_data",
    "traces_reset",
    "track_program",
    "tracing_enabled",
    "watchdog",
    "watchdog_active",
]
