"""SLO policy plane: execution-latency prediction, the inputs of the
deadline-aware batch release, and fleet admission decisions.

Counterpart of ``dask_ml_tpu/serving/policy.py`` (host Python only, the
same rules). Two consumers ride the same windowed per-(method, bucket)
histograms: the micro-batcher's deadline-aware release
(``_batching.release_deadline``) and the fleet's SLO-aware admission
(:func:`predict_completion_s`, :func:`admission_verdict`): given each
replica's queued rows and its predicted per-batch execution time, would
a request complete inside ``config.serving_slo_ms``? If no replica can,
the fleet sheds at the door (``SloShed``). Predictions are WINDOWED
quantiles (delta snapshots rotated every :data:`WINDOW_S` seconds), so a
swap or a noisy neighbour shows within a window.
"""

from __future__ import annotations

import math
import threading
import time

from ..observability._hist import (
    Histogram,
    percentiles_from,
    snapshot_delta,
)

__all__ = ["ExecStats", "predict_completion_s", "admission_verdict",
           "exec_from_snapshot", "WINDOW_S"]

# windowed-quantile rotation period: predictions read the delta since a
# snapshot at most 2 windows old
WINDOW_S = 10.0
# a window needs this many observations before its quantile outranks
# the lifetime one (tiny windows estimate wildly)
_MIN_WINDOW_N = 8


def _usable(v) -> bool:
    """Is ``v`` a prediction a caller may act on? Degenerate estimates
    — NaN from an empty delta window, 0.0 from a histogram whose only
    mass sits at zero (or a remote snapshot whose sub-microsecond p90
    rounded to 0.0) — must never reach admission: ``predicted <= slo``
    holds trivially at 0.0 and fails unconditionally at NaN, turning a
    not-yet-warm predictor into a confident verdict in either
    direction. Unusable estimates collapse to None, and None ADMITS
    (never shed on ignorance)."""
    return v is not None and math.isfinite(v) and v > 0.0


class ExecStats:
    """Per-(method, bucket) batch EXECUTION seconds (pack -> demux of
    one dispatched micro-batch — not queue wait) with windowed quantile
    prediction.

    ``observe`` is the serving worker's per-batch write: one histogram
    observe. ``predict_s`` answers "how long will the next batch of
    this shape take" from the freshest window with enough mass, falling
    back to the lifetime histogram, then to any sibling bucket's
    estimate (a bucket never executed yet borrows its nearest measured
    neighbor — still better than no admission control at all), then to
    ``None`` (caller keeps the fixed-window rule).
    """

    __slots__ = ("_hists", "_cursors", "_lock")

    def __init__(self):
        self._hists: dict[tuple, Histogram] = {}
        # key -> (snapshot, t_taken): the rotation cursor windows read
        self._cursors: dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def observe(self, method: str, bucket: int, seconds: float) -> None:
        key = (method, int(bucket))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key, Histogram())
        h.observe(seconds)

    def _window(self, key):
        """Delta snapshot since the rotation cursor (rotating it when
        stale); None when the key was never observed."""
        h = self._hists.get(key)
        if h is None:
            return None
        cur = h.snapshot()
        now = time.perf_counter()
        with self._lock:
            prev = self._cursors.get(key)
            if prev is None or now - prev[1] > WINDOW_S:
                self._cursors[key] = (cur, now)
            prev_snap = prev[0] if prev is not None else None
        delta = snapshot_delta(cur, prev_snap)
        return delta if delta["count"] >= _MIN_WINDOW_N else cur

    def _estimate(self, key, q):
        """One key's usable windowed estimate: the window quantile when
        finite and positive, the LIFETIME quantile when the window's is
        degenerate (empty delta -> NaN, all-zero mass -> 0.0), None when
        both are — a conservative, admit-friendly collapse instead of a
        0.0/NaN that admission would treat as certainty."""
        snap = self._window(key)
        if snap is None or snap["count"] <= 0:
            return None
        v = next(iter(percentiles_from(snap, (q,)).values()))
        if _usable(v):
            return v
        h = self._hists.get(key)
        if h is not None and h.count > 0:
            v = next(iter(h.percentiles((q,)).values()))
            if _usable(v):
                return v
        return None

    def predict_s(self, method: str, bucket: int, q: float = 90):
        """Predicted execution seconds for a (method, bucket) batch, or
        None when nothing USABLE was ever measured for the method (an
        empty or not-yet-warm window never yields 0.0/NaN — it yields
        None, and the admission plane admits on None)."""
        key = (method, int(bucket))
        est = self._estimate(key, q)
        if est is not None:
            return est
        # nearest measured sibling bucket of the same method
        best, best_dist = None, math.inf
        for (m, b), h in list(self._hists.items()):
            if m != method or h.count == 0 or (m, b) == key:
                continue
            dist = abs(math.log(max(b, 1)) - math.log(max(bucket, 1)))
            if dist < best_dist:
                best, best_dist = (m, b), dist
        if best is None:
            return None
        return self._estimate(best, q)

    def snapshot(self) -> dict:
        """{"method:bucket": {count, p50, p90}} — the stats()/status
        rendering of the prediction state."""
        out = {}
        for (m, b), h in sorted(self._hists.items()):
            if h.count == 0:
                continue
            pct = h.percentiles((50, 90))
            out[f"{m}:{b}"] = {
                "count": h.count,
                "p50_s": round(pct["p50"], 6),
                "p90_s": round(pct["p90"], 6),
            }
        return out


def predict_completion_s(queue_rows: int, n_rows: int, top_bucket: int,
                         exec_s) -> float | None:
    """Predicted end-to-end seconds for a request of ``n_rows`` joining
    a replica with ``queue_rows`` already queued: the queued work packs
    into ``ceil(rows / top_bucket)`` full batches ahead of (or around)
    this request, each costing one predicted execution. None when no
    USABLE execution estimate exists yet — a missing, non-finite, or
    non-positive ``exec_s`` (an empty or not-yet-warm window) collapses
    to None and admission stays open: never shed on ignorance."""
    if not _usable(exec_s):
        return None
    batches = max(math.ceil((queue_rows + n_rows) / max(top_bucket, 1)),
                  1)
    return batches * exec_s


def admission_verdict(predicted_s, slo_s: float) -> bool:
    """True = admit. Shed only on a CONFIDENT predicted miss: an SLO is
    configured, a FINITE prediction exists, and the predicted
    completion exceeds the full budget (a NaN prediction is ignorance,
    not a miss — it admits)."""
    if slo_s <= 0 or predicted_s is None \
            or not math.isfinite(predicted_s):
        return True
    return predicted_s <= slo_s


def exec_from_snapshot(exec_snap, method: str, bucket: int,
                       q: float = 90):
    """Predicted execution seconds for a (method, bucket) batch out of a
    REMOTE replica's ``stats()["exec_s"]`` snapshot (the
    ``{"method:bucket": {count, p50_s, p90_s}}`` rendering /status
    publishes) — the federation router's cross-process twin of
    :meth:`ExecStats.predict_s`. Nearest measured bucket of the same
    method by log-distance; entries that are thin (count below
    :data:`_MIN_WINDOW_N`) or degenerate (a sub-microsecond quantile
    rounded to 0.0 by the snapshot) are skipped — None (admit) over a
    false confident verdict built from another process's noise."""
    if not exec_snap:
        return None
    field = "p90_s" if q >= 90 else "p50_s"
    best, best_dist = None, math.inf
    for key, entry in exec_snap.items():
        try:
            m, _, b = key.rpartition(":")
            b = int(b)
        except (ValueError, AttributeError):
            continue
        if m != method or not isinstance(entry, dict):
            continue
        if int(entry.get("count", 0)) < _MIN_WINDOW_N:
            continue
        v = entry.get(field, entry.get("p90_s"))
        if not _usable(v):
            continue
        dist = abs(math.log(max(b, 1)) - math.log(max(bucket, 1)))
        if dist < best_dist:
            best, best_dist = float(v), dist
    return best
