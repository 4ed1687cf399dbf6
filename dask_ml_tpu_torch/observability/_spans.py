"""Hierarchical span tracing.

Counterpart of ``dask_ml_tpu/observability/_spans.py``, cut to the
serving path's needs: ``span(name, **attrs)`` is a nesting-aware timer;
each closed span appends one JSONL record (wall time, the device-sync
time charged by ``Span.sync``, its id, parent id and depth, the
caller's attributes, the closing thread and the counter deltas it
caused as ``ctr_*`` fields) to ``<config.trace_dir>/trace.jsonl``, and
hands the same record to every span observer. The parent chain is per
thread. With no ``trace_dir`` and no observer a span is the shared
no-op: one config read and a None check.

The metrics logger (per-fit sinks) and the watchdog's open-span
registry of the JAX module wait for ROADMAP.md queue 1, Observability.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

from ._counters import counters_enabled, counters_snapshot

__all__ = ["span", "add_span_observer", "remove_span_observer",
           "NOOP_SPAN"]

# ids carry the pid in their high bits: trace.jsonl is appended to, so
# two processes recording into one file must not collide ids
_ids = itertools.count(((os.getpid() & 0xFFFFFF) << 24) | 1)
_tls = threading.local()
_obs_lock = threading.Lock()
_trace_lock = threading.Lock()
_span_observers: list = []
_T0 = time.time()


def add_span_observer(fn) -> None:
    """Subscribe ``fn(record)`` to every span close; spans then record
    even with no ``trace_dir``."""
    with _obs_lock:
        _span_observers.append(fn)


def remove_span_observer(fn) -> None:
    with _obs_lock:
        try:
            _span_observers.remove(fn)
        except ValueError:
            pass


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _FileSink:
    """Open-per-record append sink: no descriptor outlives a write."""

    __slots__ = ("path",)

    def __init__(self, path):
        self.path = path

    def log(self, **rec):
        line = json.dumps(
            {"time": round(time.time() - _T0, 6), **rec}) + "\n"
        with _trace_lock, open(self.path, "a") as fh:
            fh.write(line)


def _trace_sink():
    from ..config import get_config

    trace_dir = get_config().trace_dir
    if not trace_dir:
        return None
    try:
        os.makedirs(trace_dir, exist_ok=True)
    except OSError:
        return None  # an unusable sink disables the span, never the caller
    return _FileSink(os.path.join(trace_dir, "trace.jsonl"))


class _NoopSpan:
    """Shared zero-cost stand-in when nothing records."""

    __slots__ = ()

    recording = False

    def add(self, **attrs):
        return self

    def sync(self, value):
        return value


NOOP_SPAN = _NoopSpan()


class span:
    """Context manager producing one nested JSONL span record.

    ``with span("serving.batch", bucket=64) as sp:`` yields an object
    that takes late attributes (``sp.add(rows=7)``) and device barriers
    (``out = sp.sync(out)`` waits for the card and charges the wait to
    the record's ``sync_s``). With no sink and no observer the context
    yields the shared no-op span.
    """

    __slots__ = ("name", "attrs", "span_id", "parent_id", "sync_s",
                 "_sink", "_t0", "_ctr0", "_tracked")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs
        self.sync_s = 0.0
        self._sink = None
        self._tracked = False

    @property
    def recording(self):
        return self._sink is not None

    def add(self, **attrs):
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Wait for the card (when ``value`` is a CUDA tensor) and charge
        the wait to this span's ``sync_s``."""
        import torch

        t0 = time.perf_counter()
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        self.sync_s += time.perf_counter() - t0
        return value

    def __enter__(self):
        sink = _trace_sink()
        if sink is None and not _span_observers:
            return NOOP_SPAN
        self._sink = sink
        self._tracked = True
        st = _stack()
        self.parent_id = st[-1] if st else None
        self.span_id = next(_ids)
        st.append(self.span_id)
        self._ctr0 = (counters_snapshot()
                      if sink is not None and counters_enabled() else None)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._tracked:
            return False
        wall = time.perf_counter() - self._t0
        st = _stack()
        # pop down to (and including) this frame: frames above it are
        # spans abandoned mid-block
        if self.span_id in st:
            while st and st[-1] != self.span_id:
                st.pop()
            if st:
                st.pop()
        with _obs_lock:
            observers = list(_span_observers)
        rec = {
            "span": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": len(st),
            "t_unix": round(time.time(), 6),
            "wall_s": round(wall, 6),
            "sync_s": round(self.sync_s, 6),
            "thread": threading.current_thread().name,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        rec.update(self.attrs)
        if self._ctr0 is not None:
            now = counters_snapshot()
            for k, v in now.items():
                d = v - self._ctr0.get(k, 0)
                if d:
                    rec[f"ctr_{k}"] = round(d, 6) if isinstance(
                        d, float) else d
        for fn in observers:
            try:
                fn(rec)
            except Exception:
                pass  # an observer never fails the traced code
        if self._sink is not None:
            try:
                self._sink.log(**rec)
            except Exception:
                pass  # a full disk never fails the traced code
        return False
