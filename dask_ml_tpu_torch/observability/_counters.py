"""The runtime counter registry.

Counterpart of the registry part of ``dask_ml_tpu/observability/
_counters.py``: a flat ``name -> number`` dict under one lock, gated by
``config.obs_counters`` (off: every recorder is one config read), and
the recorders of the reliability plane under the JAX names, so a
reliability status reads alike in both packages:

- ``faults_injected`` and ``faults_injected_<site>``: armed faults that
  fired (``reliability/faults.py``);
- ``stream_retries``: host block reads retried after an ``OSError``;
- ``stream_quarantined_blocks``: blocks folded out by
  ``stream_nonfinite="quarantine"``;
- ``stream_checkpoint_saves`` and ``stream_resumes``: pass checkpoints
  saved, and fits restored from one.

The spans, the metrics logger and the device gauges of the JAX module
are not ported (ROADMAP.md queue 1, Observability).
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, float] = {}


def counters_enabled() -> bool:
    from ..config import get_config

    return bool(get_config().obs_counters)


def counter_add(name: str, value=1) -> None:
    """Unconditional add, for call sites that checked the gate already."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def counters_snapshot() -> dict:
    with _lock:
        return dict(_counters)


def counters_reset() -> None:
    with _lock:
        _counters.clear()


def record_fault_injected(site: str, kind: str) -> None:
    """One armed fault fired at ``site``: the total and the site's
    share."""
    if counters_enabled():
        counter_add("faults_injected", 1)
        counter_add(f"faults_injected_{site}", 1)


def record_stream_retry() -> None:
    """One failed host block read absorbed by the bounded retry."""
    if counters_enabled():
        counter_add("stream_retries", 1)


def record_stream_quarantine() -> None:
    """One streamed block quarantined by the non-finite policy."""
    if counters_enabled():
        counter_add("stream_quarantined_blocks", 1)


def record_stream_checkpoint(resume: bool = False) -> None:
    """One pass checkpoint saved, or with ``resume=True`` one fit
    restored from a checkpoint."""
    if counters_enabled():
        counter_add("stream_resumes" if resume
                    else "stream_checkpoint_saves", 1)
