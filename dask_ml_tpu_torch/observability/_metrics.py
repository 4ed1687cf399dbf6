"""JSONL metrics core: the per-fit logger, its sink bindings and the
per-step records.

Counterpart of ``dask_ml_tpu/observability/_metrics.py``. The JAX
package's solver loops run inside compiled programs and reach the host
through ``jax.debug.callback``; the port's loops run on the host and
already read their scalars there, so a step record is a plain call,
:func:`emit_step`, on the fitting thread. ``timed`` waits on the card
with ``torch.cuda.synchronize``; ``profile_trace`` is a
``torch.profiler`` window that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time


class MetricsLogger:
    """Append one JSON object per record to a file (or stdout).

    Each record is ONE ``write`` of one whole line to a descriptor opened
    with ``O_APPEND``, so several processes (or the virtual ranks'
    threads) appending to one ``metrics_path`` never interleave
    mid-line."""

    def __init__(self, path=None, extra=None):
        self.path = path
        self.extra = extra or {}
        self._fd = None
        self.t0 = time.time()
        # log() is called from search worker threads too; one lock keeps
        # the lazy open single
        self._lock = threading.Lock()

    def log(self, step=None, **metrics):
        # t_unix anchors the record on the wall clock so `report --merge`
        # can place counters/programs-only files on the shared timeline;
        # a record's own t_unix (spans) wins via update()
        now = time.time()
        rec = {"time": round(now - self.t0, 6),
               "t_unix": round(now, 6), **self.extra}
        if step is not None:
            rec["step"] = step
        rec.update(metrics)
        line = (json.dumps(rec) + "\n").encode()
        with self._lock:
            if self.path is None:
                sys.stdout.write(line.decode())
                sys.stdout.flush()
                return
            if self._fd is None:
                self._fd = os.open(self.path,
                                   os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                                   0o644)
            os.write(self._fd, line)

    def close(self):
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Every binding is kept twice. The module-global stack is the
# best-available guess for a thread that bound nothing (the watchdog's
# thread); the per-thread stack is what span sinks and step records of
# the fitting thread resolve, so a concurrent fit on another thread never
# has its records stamped with this thread's extras. Each fit removes
# exactly ITS entry on exit (a non-LIFO exit under concurrent fits must
# not drop a neighbour's).
_active_loggers = []
_active_lock = threading.Lock()
_thread_bindings = threading.local()


def thread_bound_logger():
    """The innermost logger bound with :func:`active_logger` ON THIS
    THREAD (None when this thread bound nothing)."""
    st = getattr(_thread_bindings, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def active_logger(logger):
    """Bind ``logger`` as the sink of :func:`emit_step` and of the spans
    opened on this thread inside the block."""
    if logger is None:
        yield None
        return
    st = getattr(_thread_bindings, "stack", None)
    if st is None:
        st = _thread_bindings.stack = []
    with _active_lock:
        _active_loggers.append(logger)
    st.append(logger)
    try:
        yield logger
    finally:
        st.remove(logger)
        with _active_lock:
            _active_loggers.remove(logger)


def step_records_wanted() -> bool:
    """Would :func:`emit_step` write anything on this thread now?"""
    from .live import live_publishing

    return thread_bound_logger() is not None or live_publishing()


def emit_step(step, **metrics):
    """One per-iteration record into this thread's bound logger, and the
    same values as live progress gauges while an exporter runs. The
    values are host floats the loop already holds: this never reads the
    card. With no logger bound and no exporter it is a thread-local peek
    and a flag test."""
    lg = thread_bound_logger()
    from .live import live_publishing, publish_progress

    if lg is None and not live_publishing():
        return
    vals = {n: float(metrics[n]) for n in sorted(metrics)}
    if lg is not None:
        lg.log(step=int(step), **vals)
    publish_progress(step=int(step), **vals)


@contextlib.contextmanager
def fit_logger(component, **extra):
    """Per-fit :class:`MetricsLogger` on ``config.metrics_path``; yields
    None (callers guard on it) when the knob is unset. Callers bind it
    with :func:`active_logger` where their loop emits step records, as
    the JAX fits do. Every fit passes here, so it is also the hook that
    arms the live exporter (``config.obs_http_port``) and the stall
    watchdog (``config.watchdog_timeout_s``, one process-wide poller
    shared by nested fits): with every knob at its default the call is
    config reads."""
    from ..config import get_config
    from ._watchdog import shared_watchdog
    from .live import ensure_telemetry

    ensure_telemetry()
    path = get_config().metrics_path
    with shared_watchdog():
        if not path:
            yield None
            return
        logger = MetricsLogger(path, extra={"component": component, **extra})
        try:
            yield logger
        finally:
            logger.close()


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call, after the card finished its work:
    the honest time of asynchronously launched kernels."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir):
    """A ``torch.profiler`` window over the block (the card's activity
    too when there is one) that writes ``<log_dir>/trace.json``, a Chrome
    trace for ``ui.perfetto.dev``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
