"""Observability of the port: the counter registry
(``_counters.py``) and the host-side data sketches (``sketch.py``)
behind the streamed fits' ``training_profile_``.

Counterpart of the registry and sketch parts of
``dask_ml_tpu/observability``; its spans, metrics logger, drift scoring,
exporters and device gauges wait for ROADMAP.md queue 1, Observability.
"""

from ._counters import (
    counter_add,
    counters_enabled,
    counters_reset,
    counters_snapshot,
    record_fault_injected,
    record_stream_checkpoint,
    record_stream_quarantine,
    record_stream_retry,
)
from .sketch import (CategoricalSketch, FeatureSketch, merge_profiles,
                     profile_from_dict)

__all__ = [
    "CategoricalSketch",
    "FeatureSketch",
    "counter_add",
    "counters_enabled",
    "counters_reset",
    "counters_snapshot",
    "merge_profiles",
    "profile_from_dict",
    "record_fault_injected",
    "record_stream_checkpoint",
    "record_stream_quarantine",
    "record_stream_retry",
]
