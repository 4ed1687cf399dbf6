"""Request traces: the serving plane's per-request lifecycle.

Counterpart of ``dask_ml_tpu/observability/_requests.py``, the same host
Python. Every admitted request can carry a :class:`RequestTrace`: stage
stamps (admit, queue pop, pack, dispatch, execute done, demux,
complete) and outcome tags (bucket, flavor, replica, version, reroutes,
SLO sheds and violations, injected faults, canary scoring). A **tail
sampler** keeps the whole stage breakdown of the interesting traces
(errors, timeouts, sheds, SLO violations, reroutes, injected faults) and
of the rolling slowest ``config.obs_trace_sample`` fraction of ordinary
completions, while EVERY completion folds its stage durations into
per-stage exemplar histograms (each bucket keeps one recent trace id, so
a quantile links to a concrete request).

With ``obs_trace_sample=0`` no trace object is allocated on the serving
path: ``ModelServer`` reads the gate once, at construction
(``_trace_on``). Nothing here touches the card. Trace ids carry the pid
in their high bits (the ``_spans`` ids' convention), so the trace files
of several processes merge in the report CLI and the Perfetto export.

With a trace sink configured (``trace_dir`` or ``metrics_path``) every
admitted request appends one ``req_capture`` record (method, rows, admit
wall clock) and every sampled trace one ``req_trace`` record: the format
:func:`load_capture` and :func:`replay` read back to replay a traffic
mix (``serving/loadtest.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from bisect import bisect_left
from collections import deque

from ..config import get_config
from ._hist import Histogram
from ._spans import _T0, _trace_sink

__all__ = [
    "STAGES",
    "RequestTrace",
    "load_capture",
    "new_trace",
    "replay",
    "tagging",
    "trace_context",
    "traces_data",
    "traces_reset",
    "tracing_enabled",
]

# pid-prefixed ids, the _spans._ids convention: two processes appending
# into one shared trace.jsonl must not collide ids, and the report's
# merge/Perfetto laning reads the process back out of id >> 24.
_trace_ids = itertools.count(((os.getpid() & 0xFFFFFF) << 24) | 1)

# lifecycle stages in order. Consecutive stamps telescope: the sum of
# present stage-to-stage durations equals complete - admit exactly.
STAGES = ("admit", "queue_pop", "pack", "dispatch", "execute_done",
          "demux", "complete")

# named stage-pair durations; the middle three carry the /metrics-facing
# histogram families (queue wait broken OUT of the end-to-end
# serving_latency_seconds family, which stays end-to-end).
_DUR_DEFS = (
    ("queue_wait", "admit", "queue_pop"),
    ("pack", "queue_pop", "pack"),
    ("dispatch", "pack", "dispatch"),
    ("execute", "dispatch", "execute_done"),
    ("demux", "execute_done", "demux"),
    ("resolve", "demux", "complete"),
)
_LIVE_HIST = {
    "queue_wait": "serving_queue_wait_seconds",
    "pack": "serving_pack_seconds",
    "demux": "serving_demux_seconds",
}

# tags that make a trace unconditionally interesting to the tail
# sampler (beyond a non-"ok" outcome)
_ALWAYS_KEEP_TAGS = ("rerouted_from", "rerouted_from_process",
                     "fault_injected", "slo_violation", "slo_shed")

_lock = threading.Lock()
_kept: deque | None = None          # sampled trace records, newest last
_hists: dict[str, "_ExemplarHist"] = {}
_counts = {"started": 0, "completed": 0, "sampled": 0, "captured": 0}
_RING = 256                          # rolling e2e window for slowest-p
_ring: list = []
_ring_i = 0
_ring_n = 0                          # completions folded in (ever)
_thresh: float | None = None

_tls = threading.local()
_live = None                         # .live module, bound on first use
                                     # (a top-level import is a cycle)


def tracing_enabled() -> bool:
    """One config read: is the request trace plane on? ``ModelServer``
    captures this once at construction; the fleet door (which has no
    construction-time hot path) reads it per submit."""
    return float(get_config().obs_trace_sample) > 0.0


@contextlib.contextmanager
def tagging(**tags):
    """Thread-local pending tags: traces created inside the block start
    with ``tags`` pre-applied. The fleet's failover loop wraps its
    retry submit in ``tagging(rerouted_from=<corpse id>)`` so the
    surviving replica's trace records where the request came from."""
    stack = getattr(_tls, "tags", None)
    if stack is None:
        stack = _tls.tags = []
    stack.append(tags)
    try:
        yield
    finally:
        stack.pop()


def _pending_tags() -> dict:
    stack = getattr(_tls, "tags", None)
    if not stack:
        return {}
    out = {}
    for t in stack:
        out.update(t)
    return out


@contextlib.contextmanager
def trace_context(trace_id):
    """Thread-local pending trace id: traces created inside the block
    CONTINUE ``trace_id`` instead of minting a fresh one. This is the
    cross-process continuation primitive — the federation receive side
    wraps its fleet submit in the router's X-Trace-Context id, so the
    remote stages land on the SAME pid-prefixed trace the router
    started (collision-free: the id was minted exactly once, at the
    router, and no other trace in the receiving process can carry its
    pid prefix)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = int(trace_id)
    try:
        yield
    finally:
        _tls.ctx = prev


def _pending_ctx():
    return getattr(_tls, "ctx", None)


class _ExemplarHist:
    """A :class:`Histogram` whose buckets each remember the most recent
    trace id that landed there — the exemplar a scraped quantile links
    back to a concrete sampled (or folded) request. Exposed through the
    JSON ``/traces`` surface only: the Prometheus text exposition stays
    grammar-clean (no OpenMetrics exemplar syntax)."""

    __slots__ = ("hist", "exemplars")

    def __init__(self, bounds=None):
        self.hist = Histogram(bounds)
        self.exemplars = [None] * (len(self.hist.bounds) + 1)

    def observe(self, value: float, trace_id: int) -> None:
        self.hist.observe(value)
        self.exemplars[bisect_left(self.hist.bounds, float(value))] = \
            int(trace_id)

    def snapshot(self) -> dict:
        snap = self.hist.snapshot()
        snap["bounds"] = list(snap["bounds"])
        snap["exemplars"] = list(self.exemplars)
        return snap


class RequestTrace:
    """One request's lifecycle: stage stamps (``time.perf_counter``),
    outcome tags, and the thread names the Perfetto export lanes flow
    events across. Host only."""

    __slots__ = ("trace_id", "method", "n_rows", "t_unix", "stages",
                 "tags", "threads", "_finished")

    def __init__(self, method, n_rows, t_admit=None):
        ctx = _pending_ctx()
        self.trace_id = next(_trace_ids) if ctx is None else int(ctx)
        self.method = str(method)
        self.n_rows = int(n_rows)
        self.t_unix = time.time()
        self.stages = {
            "admit": time.perf_counter() if t_admit is None else t_admit,
        }
        self.tags = _pending_tags()
        self.threads = {"admit": threading.current_thread().name}
        self._finished = False

    def stamp(self, stage: str, t=None) -> None:
        self.stages[stage] = time.perf_counter() if t is None else t
        if stage == "queue_pop" and "worker" not in self.threads:
            self.threads["worker"] = threading.current_thread().name

    def tag(self, **kw) -> None:
        self.tags.update(kw)

    def finish(self, outcome: str = "ok") -> None:
        """Terminal stamp + tail-sampler decision + histogram folds +
        capture-sink write. Idempotent: a request failed after a partial
        demux finishes once, with the first outcome."""
        _finish(self, outcome)


def new_trace(method, n_rows, t_admit=None) -> RequestTrace:
    """Allocate a trace for one admitted request, pick up any pending
    thread-local tags, and append its ``req_capture`` traffic record to
    the trace sink (when one is configured). Call sites gate on
    ``tracing_enabled()`` / a captured ``_trace_on`` — this function is
    never reached when the plane is off."""
    tr = RequestTrace(method, n_rows, t_admit=t_admit)
    with _lock:
        _counts["started"] += 1
    _capture(tr)
    return tr


def _capture(tr: RequestTrace) -> None:
    sink = _trace_sink()
    if sink is None:
        return
    try:
        sink.log(
            req_capture=True, trace_id=tr.trace_id, pid=os.getpid(),
            method=tr.method, n_rows=tr.n_rows,
            t_unix=round(tr.t_unix, 6),
        )
    except Exception:
        return  # telemetry must never fail the request it observes
    with _lock:
        _counts["captured"] += 1


def _slow_threshold(e2e: float, p: float) -> float:
    """Rolling (1 - p) quantile over the last ``_RING`` end-to-end
    latencies, recomputed every 32 completions (a 256-element sort per
    request would be measurable; a cached threshold is one compare).
    The cadence counts COMPLETIONS (``_ring_n``), not ring occupancy —
    once the ring is full its length never changes, so a length-based
    cadence would degenerate into a sort per request."""
    global _thresh, _ring_i, _ring_n
    with _lock:
        if len(_ring) < _RING:
            _ring.append(e2e)
        else:
            _ring[_ring_i] = e2e
            _ring_i = (_ring_i + 1) % _RING
        _ring_n += 1
        n = len(_ring)
        if _thresh is None or n < 32 or _ring_n % 32 == 0:
            s = sorted(_ring)
            k = min(n - 1, max(0, int((1.0 - min(p, 1.0)) * n)))
            _thresh = s[k]
        return _thresh


def _finish(tr: RequestTrace, outcome: str) -> None:
    if tr._finished:
        return
    tr._finished = True
    st = tr.stages
    if "complete" not in st:
        st["complete"] = time.perf_counter()
    t0 = st["admit"]
    e2e = st["complete"] - t0

    cfg = get_config()
    p = float(cfg.obs_trace_sample)

    # fold stage-pair durations into the exemplar histograms, and
    # mirror the three /metrics families into the live registry with
    # the same {method, bucket} labels serving_latency_seconds carries
    durs = {}
    for name, a, b in _DUR_DEFS:
        ta, tb = st.get(a), st.get(b)
        if ta is None or tb is None:
            continue
        durs[name] = tb - ta
    with _lock:
        _counts["completed"] += 1
        for name, v in durs.items():
            h = _hists.get(name)
            if h is None:
                h = _hists[name] = _ExemplarHist()
            h.observe(v, tr.trace_id)
    bucket = tr.tags.get("bucket")
    if bucket is not None:
        global _live
        if _live is None:
            from . import live as _live_mod
            _live = _live_mod
        if _live.live_publishing():
            labels = (("method", tr.method), ("bucket", str(int(bucket))))
            for name, fam in _LIVE_HIST.items():
                if name in durs:
                    hist = _live.histogram(fam, labels=labels)
                    if hist is not None:
                        hist.observe(durs[name])

    # tail sampler: errors / sheds / SLO trouble / reroutes / injected
    # faults are ALWAYS kept; ordinary completions only when they land
    # in the rolling slowest-p fraction (p >= 1 keeps everything, so the
    # quantile ring is skipped entirely)
    interesting = outcome != "ok" or any(
        tr.tags.get(k) for k in _ALWAYS_KEEP_TAGS
    )
    if not interesting and p > 0:
        interesting = p >= 1.0 or e2e >= _slow_threshold(e2e, p)
    if not interesting:
        return

    rec = {
        "req_trace": True,
        "trace_id": tr.trace_id,
        "pid": os.getpid(),
        "method": tr.method,
        "n_rows": tr.n_rows,
        "t_unix": round(tr.t_unix, 6),
        "e2e_s": round(e2e, 6),
        "outcome": outcome,
        "stages": {s: round(st[s] - t0, 6) for s in STAGES if s in st},
        "durations": {k: round(v, 6) for k, v in durs.items()},
        "threads": dict(tr.threads),
    }
    for k, v in tr.tags.items():
        rec.setdefault(k, v)
    global _kept
    with _lock:
        if _kept is None:
            _kept = deque(maxlen=max(int(cfg.obs_trace_keep), 1))
        _kept.append(rec)
        _counts["sampled"] += 1
    sink = _trace_sink()
    if sink is not None:
        try:
            # "time" pinned to the ADMIT instant (sink default would be
            # the completion write time) so the merged timeline and the
            # Perfetto flow events start where the request actually did
            sink.log(time=round(tr.t_unix - _T0, 6), **rec)
        except Exception:
            pass


def traces_data() -> dict:
    """The ``/traces`` JSON document: sampler counters, the retained
    sampled traces (oldest first), and the per-stage exemplar
    histograms."""
    with _lock:
        kept = [dict(r) for r in _kept] if _kept is not None else []
        counts = dict(_counts)
        hists = {name: h.snapshot() for name, h in sorted(_hists.items())}
    return {"counts": counts, "traces": kept,
            "stage_histograms": hists}


def traces_reset() -> None:
    """Forget every kept trace, histogram, and sampler state (test
    isolation; also re-latches ``obs_trace_keep`` on next sample)."""
    global _kept, _thresh, _ring_i, _ring_n
    with _lock:
        _kept = None
        _hists.clear()
        _ring.clear()
        _ring_i = 0
        _ring_n = 0
        _thresh = None
        for k in _counts:
            _counts[k] = 0


# -- traffic capture and replay -----------------------------------------------

def load_capture(path) -> list:
    """The admitted-traffic records (``req_capture``) out of a trace
    JSONL file, sorted by admit wall clock. Corrupt lines are skipped —
    same contract as the report CLI's loader."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if isinstance(r, dict) and r.get("req_capture"):
                records.append(r)
    records.sort(key=lambda r: r.get("t_unix", 0.0))
    return records


def replay(records, submit, speed: float = 1.0) -> dict:
    """Re-issue a captured traffic mix: calls ``submit(method, n_rows)``
    for each record at the recorded inter-arrival spacing (scaled by
    ``1/speed``; ``speed=10`` replays 10x faster). Returns the replayed
    mix summary, the witness that a capture file reproduces the recorded
    (method, rows, rate) mix (``serving/loadtest.py`` builds on it)."""
    by_method: dict[str, int] = {}
    rows = 0
    if not records:
        return {"requests": 0, "rows": 0, "duration_s": 0.0,
                "rate_rps": 0.0, "by_method": by_method}
    t_first = records[0].get("t_unix", 0.0)
    start = time.perf_counter()
    for r in records:
        delay = (r.get("t_unix", t_first) - t_first) / max(speed, 1e-9) \
            - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        submit(r["method"], int(r["n_rows"]))
        by_method[r["method"]] = by_method.get(r["method"], 0) + 1
        rows += int(r["n_rows"])
    dur = time.perf_counter() - start
    return {
        "requests": len(records),
        "rows": rows,
        "duration_s": round(dur, 6),
        "rate_rps": round(len(records) / dur, 3) if dur > 0 else 0.0,
        "by_method": by_method,
    }
