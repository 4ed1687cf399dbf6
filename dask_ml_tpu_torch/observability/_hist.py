"""Fixed-boundary log-spaced histograms: the distribution primitive of
the serving latency windows and the execution-time predictor.

Counterpart of ``dask_ml_tpu/observability/_hist.py``, the same
boundaries, bucket semantics and quantile estimate (host Python only).
``observe`` is one bisect and three adds under a small lock, safe from
any thread while readers take consistent snapshots; nothing is ever
forgotten. Boundaries default to a 1-2-5 ladder over 1e-5 .. 100
seconds. Quantiles interpolate linearly inside the winning bucket and
clamp to the observed [min, max].
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

# 1-2-5 per decade, 1e-5 s .. 1e2 s. A literal (not a comprehension) so
# the Prometheus ``le`` labels are stable, exact decimals run to run.
DEFAULT_BOUNDS = (
    1e-05, 2e-05, 5e-05,
    1e-04, 2e-04, 5e-04,
    0.001, 0.002, 0.005,
    0.01, 0.02, 0.05,
    0.1, 0.2, 0.5,
    1.0, 2.0, 5.0,
    10.0, 20.0, 50.0,
    100.0,
)


class Histogram:
    """Thread-safe fixed-boundary histogram.

    ``observe(v)`` is one bisect over the (immutable) boundary tuple
    plus three adds under the lock — no allocation, no resize, safe from
    any thread. ``counts`` has ``len(bounds) + 1`` slots; the last is
    the +Inf overflow bucket. Bucket semantics match Prometheus:
    bucket ``i`` counts observations ``v <= bounds[i]``.
    """

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_min", "_max",
                 "_lock")

    def __init__(self, bounds=None):
        self.bounds = tuple(float(b) for b in (bounds or DEFAULT_BOUNDS))
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def snapshot(self) -> dict:
        """Consistent copy: {bounds, counts, sum, count, min, max} —
        ``counts[i]`` is per-bucket (NOT cumulative); the exposition
        layer accumulates."""
        with self._lock:
            return {
                "bounds": self.bounds,
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }

    def percentiles(self, qs=(50, 99)) -> dict:
        """{'p50': ..., 'p99': ...} estimated by linear interpolation
        inside the winning bucket, clamped to observed [min, max]
        (NaN-valued when empty)."""
        return percentiles_from(self.snapshot(), qs)

    def merge(self, other) -> "Histogram":
        """Fold another histogram (or a snapshot-shaped dict) into this
        one: bucket-wise count sums plus the sum/count/min/max fields.
        Exact, because the boundaries are fixed: two histograms over
        the same ladder merge bucket for bucket. Mismatched boundaries
        raise. Returns ``self`` for chaining."""
        snap = other.snapshot() if isinstance(other, Histogram) else other
        bounds = tuple(float(b) for b in snap["bounds"])
        if bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({len(bounds)} vs {len(self.bounds)} edges)"
            )
        counts = [int(c) for c in snap["counts"]]
        if len(counts) != len(self._counts):
            raise ValueError("snapshot counts length does not match")
        mn, mx = snap.get("min"), snap.get("max")
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += float(snap["sum"])
            self._count += int(snap["count"])
            if mn is not None and float(mn) < self._min:
                self._min = float(mn)
            if mx is not None and float(mx) > self._max:
                self._max = float(mx)
        return self


def percentiles_from(snap: dict, qs=(50, 99)) -> dict:
    """Quantiles from any snapshot-shaped dict (a :meth:`snapshot` or a
    :func:`snapshot_delta` window): linear interpolation inside the
    winning bucket, clamped to the snapshot's [min, max]; NaN when the
    snapshot is empty."""
    out = {}
    n = snap["count"]
    if n <= 0:
        return {f"p{q}": float("nan") for q in qs}
    counts, bounds = snap["counts"], snap["bounds"]
    for q in qs:
        rank = max(min(math.ceil(q / 100.0 * n), n), 1)
        cum = 0
        value = snap["max"]
        for i, c in enumerate(counts):
            if c <= 0:
                continue
            if cum + c >= rank:
                # bucket 0's floor is the observed min (all its
                # members are <= bounds[0] and the min is among
                # them); the overflow bucket's ceiling is the max
                lo = bounds[i - 1] if i > 0 else snap["min"]
                hi = bounds[i] if i < len(bounds) else snap["max"]
                frac = (rank - cum) / c
                value = lo + frac * (hi - lo)
                break
            cum += c
        out[f"p{q}"] = float(
            min(max(value, snap["min"]), snap["max"])
        )
    return out


def merge_snapshots(snaps) -> dict | None:
    """Pool several snapshot-shaped dicts of ONE histogram family into
    a merged snapshot (bucket for bucket). The
    first snapshot's bounds win; later snapshots with different bounds
    raise. None when ``snaps`` is empty."""
    h = None
    for snap in snaps:
        if snap is None:
            continue
        if h is None:
            h = Histogram(snap["bounds"])
        h.merge(snap)
    return h.snapshot() if h is not None else None


def snapshot_delta(cur: dict, prev: dict | None) -> dict:
    """The WINDOW between two snapshots of one histogram as another
    snapshot-shaped dict — the delta-quantile primitive behind
    ``ModelServer.stats()``'s windowed latency and the fleet's routing/
    admission predictions (an all-time p99 over a long fast history
    dilutes a fresh degradation; a window sees it immediately).

    ``prev=None`` (or a fresh cursor) returns ``cur`` itself. The
    window's true min/max were not tracked, so they are estimated from
    the populated delta buckets' edges (lifetime min/max bound the
    open-ended first/overflow buckets) — quantile error stays within
    one bucket, same contract as the lifetime estimate."""
    if prev is None or prev.get("count", 0) == 0:
        return cur
    bounds = cur["bounds"]
    counts = [c - p for c, p in zip(cur["counts"], prev["counts"])]
    n = cur["count"] - prev["count"]
    lo = hi = None
    for i, c in enumerate(counts):
        if c > 0:
            if lo is None:
                lo = cur["min"] if i == 0 else bounds[i - 1]
            hi = cur["max"] if i >= len(bounds) else bounds[i]
    return {
        "bounds": bounds,
        "counts": counts,
        "sum": cur["sum"] - prev["sum"],
        "count": n,
        "min": lo,
        "max": hi,
    }
