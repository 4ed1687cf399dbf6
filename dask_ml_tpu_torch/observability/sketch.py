"""Streaming data sketches: the training profile of a streamed fit.

Counterpart of ``dask_ml_tpu/observability/sketch.py``, the same numpy
arithmetic, so the same folded rows give the same ``to_dict()`` in both
packages:

- :class:`FeatureSketch` — per-feature moments (count, mean, M2, min,
  max; Chan's parallel update, so folds and merges compose exactly) and
  per-feature histograms over fixed boundaries, a symmetric 1-2-5 ladder
  over magnitudes 1e-6..1e6: two sketches built anywhere compare bucket
  for bucket with no re-binning;
- :class:`CategoricalSketch` — space-saving top-k counts for label-like
  values, bounded memory under unbounded cardinality.

Host only: a fold is numpy on a buffer the staging path already holds,
never a device sync. Thread-safe (one lock per sketch), O(1) memory,
and JSON-safe snapshots (``to_dict``/``profile_from_dict``), so a
profile rides a fitted estimator through ``copy.deepcopy`` and pickle.
"""

from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["FeatureSketch", "CategoricalSketch", "DEFAULT_VALUE_BOUNDS",
           "merge_profiles", "profile_from_dict"]


def _value_bounds():
    """Symmetric 1-2-5 ladder over |v| in 1e-6..1e6 with a zero split:
    negatives mirror positives, so sign-carrying features resolve on
    both sides. 79 edges, 80 buckets."""
    mags = []
    for e in range(-6, 7):
        for m in (1.0, 2.0, 5.0):
            mags.append(m * 10.0 ** e)
    mags = [m for m in mags if m <= 1e6]
    return tuple(sorted([-m for m in mags] + [0.0] + mags))


DEFAULT_VALUE_BOUNDS = _value_bounds()


class FeatureSketch:
    """Mergeable per-feature streaming summary: moments + fixed-boundary
    histograms over an ``(n_rows, n_features)`` stream.

    ``fold(X)`` is one vectorized pass (searchsorted + bincount + masked
    moment reduction) over a host block; ``merge`` combines two sketches
    exactly (Chan's formula for the moments, count addition for the
    histograms). ``counts[f, i]`` counts values ``v <= bounds[i]`` of
    feature ``f`` (bisect_left semantics);
    the last column is the +Inf overflow bucket (non-finite values land
    there and are excluded from the moments).
    """

    __slots__ = ("n_features", "bounds", "_counts", "_n", "_mean",
                 "_m2", "_min", "_max", "_nonfinite", "_rows", "_lock")

    def __init__(self, n_features, bounds=None):
        self.n_features = int(n_features)
        if self.n_features <= 0:
            raise ValueError("FeatureSketch needs n_features >= 1")
        self.bounds = tuple(float(b) for b in
                            (bounds or DEFAULT_VALUE_BOUNDS))
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("sketch bounds must be strictly increasing")
        nb = len(self.bounds) + 1
        self._counts = np.zeros((self.n_features, nb), np.int64)
        self._n = np.zeros(self.n_features, np.int64)
        self._mean = np.zeros(self.n_features, np.float64)
        self._m2 = np.zeros(self.n_features, np.float64)
        self._min = np.full(self.n_features, np.inf)
        self._max = np.full(self.n_features, -np.inf)
        self._nonfinite = 0
        self._rows = 0
        self._lock = threading.Lock()

    @property
    def rows(self) -> int:
        return self._rows

    def fold(self, X) -> int:
        """Accumulate a host block; returns the rows folded. ``X`` is
        (n, d) or (n,) (treated as one feature). Cost is one
        searchsorted + one bincount + a handful of masked column
        reductions — no allocation proportional to history."""
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"fold expects (n, {self.n_features}), got {X.shape}"
            )
        n = X.shape[0]
        if n == 0:
            return 0
        X = X.astype(np.float64, copy=False)
        finite = np.isfinite(X)
        all_finite = bool(finite.all())
        nf = finite.sum(axis=0) if not all_finite \
            else np.full(self.n_features, n, np.int64)
        Xz = X if all_finite else np.where(finite, X, 0.0)
        s = Xz.sum(axis=0, dtype=np.float64)
        b_mean = np.divide(s, nf, out=np.zeros_like(s),
                           where=nf > 0)
        dev = Xz - b_mean[None, :]
        if not all_finite:
            dev = np.where(finite, dev, 0.0)
        b_m2 = (dev * dev).sum(axis=0, dtype=np.float64)
        if all_finite:
            b_min, b_max = X.min(axis=0), X.max(axis=0)
        else:
            b_min = np.where(finite, X, np.inf).min(axis=0)
            b_max = np.where(finite, X, -np.inf).max(axis=0)
        # histogram: bisect_left per value, one flat bincount for all
        # features (non-finite sorts past every bound -> overflow)
        nb = self._counts.shape[1]
        idx = np.searchsorted(self.bounds, X)
        idx = np.minimum(idx, nb - 1)
        flat = idx + np.arange(self.n_features)[None, :] * nb
        b_counts = np.bincount(
            flat.ravel(), minlength=self.n_features * nb
        ).reshape(self.n_features, nb)
        with self._lock:
            self._counts += b_counts
            self._merge_moments_locked(nf, b_mean, b_m2, b_min, b_max)
            self._nonfinite += int(n * self.n_features - nf.sum())
            self._rows += n
        return n

    def _merge_moments_locked(self, nf, b_mean, b_m2, b_min, b_max):
        n0 = self._n
        tot = n0 + nf
        safe = np.maximum(tot, 1)
        delta = b_mean - self._mean
        self._mean = self._mean + delta * (nf / safe)
        self._m2 = self._m2 + b_m2 + delta * delta * (n0 * nf / safe)
        self._n = tot
        np.minimum(self._min, b_min, out=self._min)
        np.maximum(self._max, b_max, out=self._max)

    def merge(self, other) -> "FeatureSketch":
        """Fold another sketch (or snapshot dict) into this one — the
        multi-pass / multi-process combiner. Bounds and widths must
        match (fixed boundaries are the whole point)."""
        snap = other.to_dict() if isinstance(other, FeatureSketch) \
            else other
        if tuple(snap["bounds"]) != self.bounds \
                or int(snap["n_features"]) != self.n_features:
            raise ValueError(
                "cannot merge sketches with different bounds/widths"
            )
        with self._lock:
            self._counts += np.asarray(snap["counts"], np.int64)
            self._merge_moments_locked(
                np.asarray(snap["n"], np.int64),
                np.asarray(snap["mean"], np.float64),
                np.asarray(snap["m2"], np.float64),
                np.asarray(snap["min"], np.float64),
                np.asarray(snap["max"], np.float64),
            )
            self._nonfinite += int(snap.get("nonfinite", 0))
            self._rows += int(snap.get("rows", 0))
        return self

    # -- views ------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe snapshot (consistent under the lock) — what rides
        ``estimator.training_profile_``."""
        with self._lock:
            return {
                "n_features": self.n_features,
                "bounds": list(self.bounds),
                "counts": self._counts.tolist(),
                "n": self._n.tolist(),
                "mean": self._mean.tolist(),
                "m2": self._m2.tolist(),
                "min": [v if math.isfinite(v) else None
                        for v in self._min.tolist()],
                "max": [v if math.isfinite(v) else None
                        for v in self._max.tolist()],
                "nonfinite": int(self._nonfinite),
                "rows": int(self._rows),
            }

    def stats(self) -> dict:
        """Per-feature {mean, std, min, max, n} arrays (host floats)."""
        with self._lock:
            n = self._n.copy()
            var = np.divide(self._m2, np.maximum(n - 1, 1),
                            out=np.zeros_like(self._m2),
                            where=n > 1)
            return {
                "n": n,
                "mean": self._mean.copy(),
                "std": np.sqrt(var),
                "min": self._min.copy(),
                "max": self._max.copy(),
            }

    def counts(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()

    def quantile(self, q) -> np.ndarray:
        """Per-feature quantile estimate (linear interpolation inside
        the winning bucket, clamped to observed [min, max]) — the same
        contract as the JAX package's latency percentiles, vectorized over
        features. ``q`` in (0, 1); NaN where a feature saw no rows."""
        with self._lock:
            counts = self._counts.copy()
            n = self._n.copy()
            lo_obs, hi_obs = self._min.copy(), self._max.copy()
        out = np.full(self.n_features, np.nan)
        edges = np.asarray(self.bounds)
        for f in range(self.n_features):
            if n[f] <= 0:
                continue
            rank = min(max(int(math.ceil(q * n[f])), 1), int(n[f]))
            cum = 0
            val = hi_obs[f]
            for i, c in enumerate(counts[f]):
                if c <= 0:
                    continue
                if cum + c >= rank:
                    lo = edges[i - 1] if i > 0 else lo_obs[f]
                    hi = edges[i] if i < len(edges) else hi_obs[f]
                    val = lo + (rank - cum) / c * (hi - lo)
                    break
                cum += c
            out[f] = min(max(val, lo_obs[f]), hi_obs[f])
        return out


def profile_from_dict(snap) -> FeatureSketch:
    """Rebuild a live sketch from a ``to_dict`` snapshot (training
    profiles stored on estimators)."""
    sk = FeatureSketch(snap["n_features"], bounds=snap["bounds"])
    sk.merge(snap)
    return sk


def merge_profiles(a, b):
    """Combine two profile snapshots (either may be None) into one
    snapshot dict — multiple ``partial_fit`` passes accumulate one
    training profile."""
    if a is None:
        return b
    if b is None:
        return a
    return profile_from_dict(a).merge(b).to_dict()


class CategoricalSketch:
    """Space-saving top-k counter for label-like streams (served class
    predictions). Bounded at ``k`` tracked values: a new value past
    capacity evicts the current minimum and INHERITS its count (the
    classic overestimate bound — error <= the evicted minimum), so the
    heavy hitters and their approximate frequencies survive unbounded
    cardinality in O(k) memory."""

    __slots__ = ("k", "_counts", "_total", "_lock")

    def __init__(self, k=64):
        self.k = int(k)
        if self.k <= 0:
            raise ValueError("CategoricalSketch needs k >= 1")
        self._counts: dict = {}
        self._total = 0
        self._lock = threading.Lock()

    def fold(self, values) -> int:
        vals, cnts = np.unique(np.asarray(values).ravel(),
                               return_counts=True)
        with self._lock:
            for v, c in zip(vals.tolist(), cnts.tolist()):
                key = str(v)
                if key in self._counts:
                    self._counts[key] += int(c)
                elif len(self._counts) < self.k:
                    self._counts[key] = int(c)
                else:
                    victim = min(self._counts, key=self._counts.get)
                    inherited = self._counts.pop(victim)
                    self._counts[key] = inherited + int(c)
                self._total += int(c)
        return int(cnts.sum())

    @property
    def total(self) -> int:
        return self._total

    def top(self, n=None) -> list:
        """[(value, count)] sorted by count desc (counts are
        space-saving upper bounds)."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return items[:n] if n else items

    def to_dict(self) -> dict:
        with self._lock:
            return {"k": self.k, "total": int(self._total),
                    "counts": dict(self._counts)}

    def merge(self, other) -> "CategoricalSketch":
        snap = other.to_dict() if isinstance(other, CategoricalSketch) \
            else other
        with self._lock:
            for key, c in snap["counts"].items():
                if key in self._counts:
                    self._counts[key] += int(c)
                elif len(self._counts) < self.k:
                    self._counts[key] = int(c)
                else:
                    victim = min(self._counts, key=self._counts.get)
                    self._counts[key] = self._counts.pop(victim) + int(c)
            self._total += int(snap["total"])
        return self
