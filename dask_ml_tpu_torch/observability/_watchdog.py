"""Slow-span watchdog: catch stalls WHILE they happen.

Counterpart of ``dask_ml_tpu/observability/_watchdog.py``. An opt-in
daemon thread (``config.watchdog_timeout_s``) polls the open-span
registry (``_spans.open_spans_snapshot``) and, for any span open past
its deadline, writes one stall record to the trace sink:

- all threads' Python stacks (``sys._current_frames``: a hang inside a
  kernel launch or a collective still shows WHICH call never returned),
- ``device_memory_gauges()`` (a stall next to an out-of-memory shows as
  the card's memory pressure),
- the open-span stack (what the process believed it was doing).

It also feeds the live plane's ``/status`` stall ring
(``live.note_stall``), the ``watchdog_stalls`` counter and the alert
engine (``alerts.note_event("watchdog_stall", ...)``: the
``builtin:watchdog_stall`` rule fires and, with ``incident_dir`` set, an
incident bundle is captured). The watchdog
NEVER raises into or kills the observed work: it reports each stalled
span once and keeps polling. An optional ``on_stall`` callback receives
each record.

``fit_logger`` runs every fit under :func:`shared_watchdog` (one poller
for the process, however deeply fits nest) and the servers' workers run
under :func:`watchdog`; with ``watchdog_timeout_s == 0`` (the default)
both are complete no-ops: no thread, nothing armed.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback

from ._counters import device_memory_gauges, record_watchdog_stall
from ._spans import _trace_sink, _track_arm, open_spans_snapshot

# live watchdog threads (for tests / the zero-overhead assertion)
_active_lock = threading.Lock()
_active_watchdogs = 0


def watchdog_active() -> bool:
    with _active_lock:
        return _active_watchdogs > 0


def _thread_stacks() -> dict:
    """Formatted Python stacks of every live thread, keyed by
    ``"<name>#<ident>"`` — the ident keeps same-named threads (every
    ModelServer worker is "dask-ml-tpu-serving") from overwriting each
    other's stacks in the dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, 'thread')}#{ident}"
        out[key] = [ln.rstrip("\n")
                    for ln in traceback.format_stack(frame)]
    return out


class Watchdog:
    """One polling thread over the open-span registry."""

    def __init__(self, timeout_s, on_stall=None, poll_s=None, cfg=None):
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        # poll fast enough to catch a stall within ~1/4 deadline, but
        # never busier than 20Hz even for sub-second test deadlines
        self.poll_s = poll_s if poll_s is not None else min(
            max(self.timeout_s / 4.0, 0.05), 1.0
        )
        # the watchdog thread must see the ARMING thread's (thread-local)
        # config — its own would resolve env defaults and likely no sink
        self._cfg = cfg
        self._stop = threading.Event()
        self._thread = None
        self._reported: set[int] = set()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        global _active_watchdogs
        if self.timeout_s <= 0:
            # 0 means DISABLED everywhere (config semantics) — a direct
            # Watchdog(0).start() must not arm a poller whose deadline
            # every open span instantly exceeds
            return self
        if self._thread is not None:
            return self
        if self._cfg is None:
            from ..config import get_config

            self._cfg = get_config()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dask-ml-tpu-watchdog", daemon=True
        )
        with _active_lock:
            _active_watchdogs += 1
        # spans now register in the open-span registry even without a
        # configured sink — a sinkless run's stalls stay catchable
        _track_arm(+1)
        self._thread.start()
        return self

    def stop(self):
        global _active_watchdogs
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(5.0)
        self._thread = None
        with _active_lock:
            _active_watchdogs -= 1
        _track_arm(-1)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- polling loop -----------------------------------------------------
    def _run(self):
        from .. import config

        with config.use(self._cfg):
            while not self._stop.wait(self.poll_s):
                try:
                    self._check(time.time())
                except Exception:
                    # the watchdog must never take the process down —
                    # keep polling even if one dump failed
                    pass

    def _check(self, now):
        spans = open_spans_snapshot()
        open_ids = {s["span_id"] for s in spans}
        self._reported &= open_ids  # forget closed spans
        for s in spans:
            age = now - s["t_open_unix"]
            if age <= self.timeout_s or s["span_id"] in self._reported:
                continue
            self._reported.add(s["span_id"])
            self._report(s, age, spans)

    def _report(self, stalled, age, open_spans):
        stacks = _thread_stacks()
        tid = stalled.get("thread_id")
        rec = {
            "watchdog": True,
            "span": stalled["span"],
            "span_id": stalled["span_id"],
            "thread": stalled["thread"],
            "thread_id": tid,
            "age_s": round(age, 3),
            "timeout_s": self.timeout_s,
            "open_spans": [
                {"span": s["span"], "span_id": s["span_id"],
                 "thread": s["thread"],
                 "age_s": round(time.time() - s["t_open_unix"], 3)}
                for s in open_spans
            ],
            "stacks": stacks,
            # the stalled thread's own stack, resolved by ident — the
            # line consumers print without digging through the full dump
            "stalled_stack": stacks.get(
                f"{stalled['thread']}#{tid}", []
            ),
        }
        try:
            rec.update(device_memory_gauges())
        except Exception:
            pass
        record_watchdog_stall()
        try:
            # one stall, one builtin:watchdog_stall event (the rule fires
            # and an incident is captured when armed; one ledger append
            # otherwise)
            from . import alerts as _alerts

            _alerts.note_event("watchdog_stall", value=age, meta={
                "span": stalled["span"], "thread": stalled["thread"],
                "timeout_s": self.timeout_s,
            })
        except Exception:
            pass
        try:
            # feed the live plane's /status stall ring (stacks elided
            # there; the full dump still goes to the trace sink below)
            from .live import note_stall

            note_stall(rec)
        except Exception:
            pass
        sink = None
        try:
            sink = _trace_sink()
            if sink is None:
                # a fit recording through a thread-BOUND logger only
                # (no metrics_path/trace_dir): the watchdog thread
                # cannot see another thread's thread-local binding, so
                # fall back to the innermost GLOBAL binding
                from ._metrics import _active_lock, _active_loggers

                with _active_lock:
                    sink = _active_loggers[-1] if _active_loggers \
                        else None
        except Exception:
            sink = None
        if sink is not None:
            try:
                sink.log(**rec)
            except Exception:
                pass  # a full disk must not kill the watchdog either
        if self.on_stall is not None:
            try:
                self.on_stall(rec)
            except Exception:
                pass


@contextlib.contextmanager
def watchdog(timeout_s=None, on_stall=None, poll_s=None):
    """Run the enclosed block under the stall watchdog.

    ``timeout_s=None`` reads ``config.watchdog_timeout_s``; a resolved
    timeout <= 0 makes this a complete no-op (yields None, starts no
    thread) — call sites wire it unconditionally and the config knob
    decides."""
    if timeout_s is None:
        from ..config import get_config

        timeout_s = get_config().watchdog_timeout_s
    if not timeout_s or timeout_s <= 0:
        yield None
        return
    wd = Watchdog(timeout_s, on_stall=on_stall, poll_s=poll_s)
    with wd:
        yield wd


# the process-wide poller of the fits (fit_logger): nested fits (a
# search's trials, one-vs-rest classes) share it instead of each
# reporting the same stalled span once more
_shared = None
_shared_users = 0
_shared_lock = threading.Lock()


@contextlib.contextmanager
def shared_watchdog():
    """Run the block under the process's one fit watchdog, started by the
    first user and stopped by the last; a no-op (one config read) when
    ``config.watchdog_timeout_s`` is 0. A nested block keeps the
    timeout the outermost one armed with."""
    global _shared, _shared_users
    from ..config import get_config

    timeout_s = get_config().watchdog_timeout_s
    if not timeout_s or timeout_s <= 0:
        yield None
        return
    with _shared_lock:
        if _shared is None:
            _shared = Watchdog(timeout_s).start()
        _shared_users += 1
        wd = _shared
    try:
        yield wd
    finally:
        with _shared_lock:
            _shared_users -= 1
            done = _shared if _shared_users == 0 else None
            if done is not None:
                _shared = None
        if done is not None:
            done.stop()
