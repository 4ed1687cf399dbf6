"""Incident bundles and on-demand deep profiling.

Counterpart of ``dask_ml_tpu/observability/incidents.py``. When an alert
starts firing (a watchdog stall, a typed serving or streaming error, a
drift crossing, a rule), the context that explains it (which spans were
open, what the counters had just done, which kernels ran, how much
device memory was in use) is gone within seconds unless someone was
scraping. This module freezes it: each firing transition writes ONE
bounded JSON **incident bundle** under ``config.incident_dir``::

    incident_<t_unix_ms>_<pid>.json
    {
      "incident": 1, "schema": 1, "reason": "alert:builtin:...",
      "open_spans": [...],        # the live span stack, oldest first
      "recent_spans": [...],      # last-N closed-span ring
      "traces": {...},            # sampled request traces + exemplars
      "counters": {...}, "gauges": {...}, "histograms": {...},
      "programs": [...],          # the kernel registry's rows
      "device_memory": {...},     # per-card bytes gauges
      "fault_plan": {...},        # armed fault plan, if any
      "alerts": {...},            # engine state at capture time
      "watchdog_stalls": [...],
      "config": {"fingerprint": "sha256...", "values": {...}},
    }

Capture is **rate-limited** (at most one bundle per
``MIN_CAPTURE_INTERVAL_S``: an alert storm leaves one file), **kept
under a cap** (``config.incident_keep``: the oldest bundles go after
each capture) and **atomic**: written through
``utils.checkpoint.save_host`` with a JSON dumper (a temp sibling, flush
and fsync, rename), so a kill mid-write never publishes a torn bundle.

**Deep profiling** (:func:`deep_profile`) runs a bounded
``torch.profiler`` window with the CPU and CUDA activities into the
incident directory, a Chrome trace for ``ui.perfetto.dev``. With
``config.device="cpu"`` it does nothing and says why (``{"profiled":
False, "reason": ...}``), as the JAX package does off a TPU: a trace of
the host alone would pass for a device trace. On the card it records
the card's activity, or raises. ``POST /profile?seconds=N`` on the
exporter runs one, and so does each capture when
``config.obs_profile_on_incident`` is set (on a daemon thread).

With ``incident_dir`` at its "" default every entry point returns after
one config read: no directory, no thread, no byte written.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque

from ._counters import counter_add, counters_enabled, counters_snapshot

__all__ = [
    "capture_incident", "incidents_data", "load_bundles",
    "deep_profile", "reset", "MIN_CAPTURE_INTERVAL_S",
]

SCHEMA_VERSION = 1
# alert storms collapse to one bundle per window (force=True bypasses —
# tests, and explicit operator captures)
MIN_CAPTURE_INTERVAL_S = 30.0
# deep-profile windows are clamped to this many seconds
MAX_PROFILE_SECONDS = 60.0

_lock = threading.Lock()
_last_capture_t = 0.0
_captured: deque = deque(maxlen=32)   # {path, reason, rule, t_unix}
_profile_lock = threading.Lock()      # one trace window at a time


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def _json_dump(obj, f) -> None:
    """``save_host``'s ``dump=`` hook: UTF-8 JSON into the binary temp
    file, degrading non-JSON leaves the way /status does."""
    f.write(json.dumps(obj, default=_json_default,
                       sort_keys=True).encode())


def config_fingerprint(cfg=None) -> tuple[str, dict]:
    """(sha256-of-sorted-JSON, full values dict) for the active config
    — bundles from two fleet processes with different knobs are
    distinguishable at a glance."""
    import dataclasses

    from ..config import get_config

    values = dataclasses.asdict(cfg or get_config())
    blob = json.dumps(values, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest(), values


def _build_bundle(reason, rule, meta, cfg) -> dict:
    """The full diagnostic snapshot — every block independently
    guarded: a failing source degrades to its error string, never the
    whole capture."""
    bundle = {
        "incident": 1,
        "schema": SCHEMA_VERSION,
        "t_unix": round(time.time(), 6),
        "pid": os.getpid(),
        "reason": str(reason),
        "rule": rule,
        "meta": dict(meta) if meta else None,
    }

    def block(key, fn):
        try:
            bundle[key] = fn()
        except Exception as exc:
            bundle[key] = {"error": f"{type(exc).__name__}: {exc}"}

    from . import live
    from ._programs import programs_snapshot
    from ._spans import open_spans_snapshot

    block("open_spans", open_spans_snapshot)
    block("recent_spans", lambda: list(live._recent_spans))
    block("watchdog_stalls", lambda: list(live._recent_stalls))

    def _traces():
        from . import _requests

        return _requests.traces_data()

    block("traces", _traces)
    block("counters", counters_snapshot)
    block("gauges", lambda: {
        f"{name}{dict(labels) or ''}": v
        for (name, labels), v in sorted(live.gauges_snapshot().items())
    })
    block("histograms", lambda: {
        f"{name}{dict(labels) or ''}": h.snapshot()
        for (name, labels), h in sorted(live.histograms_snapshot().items())
    })
    block("programs", programs_snapshot)

    def _devmem():
        from ._counters import device_memory_gauges

        return device_memory_gauges()

    block("device_memory", _devmem)

    def _faults():
        from .. import reliability

        return reliability.status_block()

    block("fault_plan", _faults)

    def _alerts():
        from . import alerts

        return alerts.alerts_data()

    block("alerts", _alerts)

    def _config():
        fp, values = config_fingerprint(cfg)
        return {"fingerprint": fp, "values": values}

    block("config", _config)
    return bundle


def _evict(incident_dir, keep) -> None:
    """Retention: drop the oldest ``incident_*.json`` past the cap
    (filename order == capture order — the name embeds t_unix_ms)."""
    try:
        names = sorted(n for n in os.listdir(incident_dir)
                       if n.startswith("incident_")
                       and n.endswith(".json"))
    except OSError:
        return
    for name in names[:max(len(names) - max(int(keep), 1), 0)]:
        try:
            os.remove(os.path.join(incident_dir, name))
        except OSError:
            pass


def capture_incident(reason, rule=None, meta=None, cfg=None,
                     force=False):
    """Freeze the diagnostic context into one atomic JSON bundle under
    ``config.incident_dir``. Returns the written path, or None when
    capture is disabled (no dir) or rate-limited (one bundle per
    ``MIN_CAPTURE_INTERVAL_S`` unless ``force``). Never raises — this
    runs on alert/error paths that must survive a full disk."""
    global _last_capture_t
    from ..config import get_config

    cfg = cfg or get_config()
    incident_dir = str(cfg.incident_dir).strip()
    if not incident_dir:
        return None
    now = time.time()
    with _lock:
        if not force and now - _last_capture_t < MIN_CAPTURE_INTERVAL_S:
            if counters_enabled():
                counter_add("incidents_rate_limited", 1)
            return None
        _last_capture_t = now
    try:
        bundle = _build_bundle(reason, rule, meta, cfg)
        path = os.path.join(
            incident_dir,
            f"incident_{int(now * 1000)}_{os.getpid()}.json",
        )
        from ..utils.checkpoint import save_host

        save_host(path, bundle, dump=_json_dump)
        _evict(incident_dir, cfg.incident_keep)
    except Exception:
        return None
    if counters_enabled():
        counter_add("incidents_captured", 1)
    rec = {"incident": True, "path": path, "reason": str(reason),
           "rule": rule, "t_unix": round(now, 6)}
    with _lock:
        _captured.append(rec)
    try:
        from ._spans import _trace_sink

        sink = _trace_sink()
        if sink is not None:
            sink.log(**rec)
    except Exception:
        pass
    if cfg.obs_profile_on_incident:
        threading.Thread(
            target=deep_profile, args=(5.0,),
            kwargs={"cfg": cfg, "tag": os.path.basename(path)[:-5]},
            name="dask-ml-tpu-torch-incident-profile", daemon=True,
        ).start()
    return path


def incidents_data() -> dict:
    """The /status ``incidents`` block: captures this process has
    written (newest last) + the rate-limit window."""
    with _lock:
        captured = list(_captured)
    return {"captured": captured,
            "min_interval_s": MIN_CAPTURE_INTERVAL_S}


def load_bundles(incident_dir):
    """Parse every published ``incident_*.json`` under a dir, oldest
    first — the ``report --incidents <dir>`` reader. Unparseable files
    surface as ``{"error": ...}`` rows rather than aborting the
    report."""
    out = []
    try:
        names = sorted(n for n in os.listdir(incident_dir)
                       if n.startswith("incident_")
                       and n.endswith(".json"))
    except OSError as exc:
        return [{"error": f"{type(exc).__name__}: {exc}",
                 "path": str(incident_dir)}]
    for name in names:
        path = os.path.join(incident_dir, name)
        try:
            with open(path, encoding="utf-8") as f:
                bundle = json.load(f)
            bundle["path"] = path
            out.append(bundle)
        except Exception as exc:
            out.append({"error": f"{type(exc).__name__}: {exc}",
                        "path": path})
    return out


def deep_profile(seconds=5.0, cfg=None, tag=None) -> dict:
    """A bounded ``torch.profiler`` window (CPU and CUDA activities) into
    ``<incident_dir>/profile_<tag>/trace.json``.

    With ``config.device="cpu"`` this is a no-op that says why
    (``{"profiled": False, "reason": ...}``); on the card it profiles the
    card or raises (a device asked for without one raises, as every
    entry point does). Windows run one at a time and are clamped to
    ``MAX_PROFILE_SECONDS``."""
    try:
        seconds = float(seconds)
    except (TypeError, ValueError):
        return {"profiled": False,
                "reason": f"bad seconds value {seconds!r}"}
    if seconds <= 0:
        return {"profiled": False, "reason": "seconds must be > 0"}
    seconds = min(seconds, MAX_PROFILE_SECONDS)
    from ..config import get_config, resolve_device

    cfg = cfg or get_config()
    if not str(cfg.incident_dir).strip():
        # the config is thread-local and POST /profile runs on the
        # exporter's thread: the armed engine carries the config that
        # set incident_dir
        from . import alerts

        eng = alerts.engine()
        if eng is not None and str(eng._cfg.incident_dir).strip():
            cfg = eng._cfg
    device = resolve_device(cfg.device)
    if device.type != "cuda":
        return {"profiled": False, "device": device.type,
                "reason": f"deep profiling needs the card (config.device "
                          f"is {cfg.device!r}); a trace of the host alone "
                          f"would pass for a device trace: no-op"}
    incident_dir = str(cfg.incident_dir).strip()
    if not incident_dir:
        return {"profiled": False, "device": device.type,
                "reason": "config.incident_dir unset: nowhere to write "
                          "the trace"}
    if not _profile_lock.acquire(blocking=False):
        return {"profiled": False, "device": device.type,
                "reason": "a profile window is already running"}
    try:
        from torch.profiler import ProfilerActivity, profile

        tag = tag or f"adhoc_{int(time.time() * 1000)}"
        log_dir = os.path.join(incident_dir, f"profile_{tag}")
        os.makedirs(log_dir, exist_ok=True)
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(seconds)
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        if counters_enabled():
            counter_add("deep_profiles", 1)
        return {"profiled": True, "device": str(device),
                "log_dir": log_dir, "trace": path,
                "seconds": round(time.time() - t0, 3)}
    finally:
        _profile_lock.release()


def reset() -> None:
    """Clear the capture ring + rate-limit clock — test isolation."""
    global _last_capture_t
    with _lock:
        _captured.clear()
        _last_capture_t = 0.0
