"""Observability of the port: the counter registry (``_counters.py``),
the host-side data sketches (``sketch.py``) behind the streamed fits'
``training_profile_``, and what the servers need: the histograms
(``_hist.py``), the spans (``_spans.py``) and the in-process metric
registry of the live plane (``live.py``).

Counterpart of those parts of ``dask_ml_tpu/observability``; the metrics
logger, drift scoring, request traces, the watchdog, the exporters and
the device gauges wait for ROADMAP.md queue 1, Observability.
"""

from ._counters import (
    counter_add,
    counters_enabled,
    counters_reset,
    counters_snapshot,
    record_fault_injected,
    record_sparse_spill,
    record_stream_checkpoint,
    record_stream_quarantine,
    record_stream_retry,
)
from ._hist import Histogram, merge_snapshots, percentiles_from, \
    snapshot_delta
from ._spans import add_span_observer, remove_span_observer, span
from .sketch import (CategoricalSketch, FeatureSketch, merge_profiles,
                     profile_from_dict)

__all__ = [
    "CategoricalSketch",
    "FeatureSketch",
    "Histogram",
    "add_span_observer",
    "counter_add",
    "counters_enabled",
    "counters_reset",
    "counters_snapshot",
    "merge_profiles",
    "merge_snapshots",
    "percentiles_from",
    "profile_from_dict",
    "record_fault_injected",
    "record_sparse_spill",
    "record_stream_checkpoint",
    "record_stream_quarantine",
    "record_stream_retry",
    "remove_span_observer",
    "snapshot_delta",
    "span",
]
