"""The in-process metric registry of the live plane.

Counterpart of the registry part of ``dask_ml_tpu/observability/
live.py``: last-value gauges and log-spaced histograms keyed by
``(name, labels)``, a cardinality guard per family
(``config.obs_max_series``), and the weak sets of live servers and
model registries that a ``/status`` page lists. The publishing gate
``live_publishing()`` is False until an exporter arms it, so the serving
loop writes no gauge an exporter nobody runs would read.

The HTTP exporter (``/metrics``, ``/status``, ``obs_http_port``), the
fit-progress observer and the fleet federation providers wait for
ROADMAP.md queue 1, Observability.
"""

from __future__ import annotations

import threading
import weakref

from ._hist import Histogram

__all__ = [
    "live_publishing", "gauge_set", "gauges_snapshot", "histogram",
    "histograms_snapshot", "drop_labeled_series", "metrics_reset",
    "register_server", "unregister_server", "register_registry",
]

_lock = threading.Lock()
_gauges: dict[tuple, float] = {}          # (name, labels) -> value
_hists: dict[tuple, Histogram] = {}       # (name, labels) -> Histogram
# labeled series per family: the cardinality guard's ledger
_family_series: dict[str, int] = {}
# the shared sink of histogram series refused by the cap
_overflow_hist: Histogram | None = None
# series keys already refused (the drop counter counts series, not writes)
_dropped_series: set = set()

_servers = weakref.WeakSet()
_registries = weakref.WeakSet()


def register_server(srv) -> None:
    """A ModelServer or FleetServer announces itself."""
    with _lock:
        _servers.add(srv)


def unregister_server(srv) -> None:
    with _lock:
        _servers.discard(srv)


def register_registry(reg) -> None:
    """A ModelRegistry announces itself (weakly: a dropped registry
    leaves with no unregister call)."""
    with _lock:
        _registries.add(reg)


def _admit_series_locked(name: str, labels: tuple) -> bool:
    """May a new labeled series join ``name``'s family (caller holds
    ``_lock``)? Past ``config.obs_max_series`` it is dropped and counted."""
    if not labels:
        return True
    if (name, labels) in _dropped_series:
        return False
    from ..config import get_config

    cap = int(get_config().obs_max_series)
    if cap > 0 and _family_series.get(name, 0) >= cap:
        from ._counters import counter_add, counters_enabled

        _dropped_series.add((name, labels))
        if counters_enabled():
            counter_add("telemetry_series_dropped", 1)
        return False
    _family_series[name] = _family_series.get(name, 0) + 1
    return True


def gauge_set(name: str, value, labels: tuple = ()) -> None:
    try:
        value = float(value)
    except (TypeError, ValueError):
        return
    key = (name, labels)
    with _lock:
        if key not in _gauges and not _admit_series_locked(name, labels):
            return
        _gauges[key] = value


def drop_labeled_series(name_prefix: str, label_kvs: tuple) -> int:
    """Remove every labeled gauge series whose family name starts with
    ``name_prefix`` and whose labels hold all of ``label_kvs``, freeing
    their slots in the cardinality ledger (a dead replica's series)."""
    kvs = set(label_kvs)
    with _lock:
        doomed = [k for k in _gauges
                  if k[0].startswith(name_prefix) and kvs <= set(k[1])]
        for k in doomed:
            del _gauges[k]
            left = _family_series.get(k[0], 0) - 1
            if left > 0:
                _family_series[k[0]] = left
            else:
                _family_series.pop(k[0], None)
            _dropped_series.discard(k)
        return len(doomed)


def gauges_snapshot() -> dict:
    with _lock:
        return dict(_gauges)


def histogram(name: str, labels: tuple = (), bounds=None) -> Histogram:
    """Create-or-get the histogram keyed ``(name, labels)``."""
    global _overflow_hist
    key = (name, labels)
    with _lock:
        h = _hists.get(key)
        if h is None:
            if not _admit_series_locked(name, labels):
                if _overflow_hist is None:
                    _overflow_hist = Histogram(bounds)
                return _overflow_hist
            h = _hists[key] = Histogram(bounds)
        return h


def histograms_snapshot() -> dict:
    with _lock:
        return dict(_hists)


def metrics_reset() -> None:
    """Clear gauges and histograms (counters have their own reset)."""
    with _lock:
        _gauges.clear()
        _hists.clear()
        _family_series.clear()
        _dropped_series.clear()


# the publishing gate: an exporter arms it while it runs
_publishing = 0
_pub_lock = threading.Lock()


def live_publishing() -> bool:
    return _publishing > 0


def _publishing_arm(delta: int) -> None:
    global _publishing
    with _pub_lock:
        _publishing += delta
