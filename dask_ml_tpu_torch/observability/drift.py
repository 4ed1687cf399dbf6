"""Drift scoring of served traffic, the hot-swap canary and the drift
monitor: the data-quality half of the live plane.

Counterpart of ``dask_ml_tpu/observability/drift.py``, the same numpy
arithmetic over the same sketches (``sketch.py``), so the same rows give
the same scores in both packages:

- **train vs serve**: a streamed fit attaches a per-feature training
  profile (``training_profile_``); ``ModelServer`` registers it per
  (model, version) and folds a sample of its served rows into
  per-(model, version, method) serving sketches. PSI and KS over the
  fixed-boundary histogram pairs score the covariate shift;
- **window vs window**: consecutive snapshots of one serving sketch
  subtract into windows (fixed boundaries make the delta exact), and
  window N is scored against window N-1, which catches a shift that
  starts after serving did;
- **version vs version (canary)**: a hot swap runs a shadow sample of
  recent traffic through the outgoing and the incoming parameters in
  the SAME captured entry points (no new CUDA graph) and records the
  disagreement rate and the largest quantile shift.

Scores publish as ``drift_score{model=,version=,method=,feature=,kind=}``
and ``drift_score_max`` gauges (capped by ``config.obs_max_series``),
below-to-above threshold crossings count once each in ``drift_alerts``
and drive the alert engine's ``builtin:drift`` rule, every score writes
a JSONL ``drift`` record for the report CLI, and ``/status`` carries
:func:`status_block`.

``config.obs_drift`` gates the CALL SITES (the streamer, the serving
worker, the swap path); this module is host numpy only and never
touches the card.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from ._counters import record_drift_alert
from .sketch import CategoricalSketch, FeatureSketch, profile_from_dict

__all__ = ["psi_from_counts", "ks_from_counts", "score_pair",
           "note_training_profile", "fold_serving", "serving_sketch",
           "record_canary", "compute", "status_block", "ShadowBuffer",
           "ensure_monitor", "stop_monitor", "monitor_active", "reset"]

# smoothing floor for PSI proportions: an empty bucket on one side must
# contribute a finite, bounded term, not log(0)
_PSI_EPS = 1e-4

# serving-fold rate budget (token bucket per sketch key): the fold runs
# on the serving worker thread, and an uncapped fold of every admitted
# row would tax its throughput. A fresh key gets a burst (a test folds
# its whole window at once); steady state is rate-limited. The sketch
# is a uniform row sample either way, and a few thousand rows already
# pin the scores
_FOLD_BURST_ROWS = 4096
_FOLD_ROWS_PER_SEC = 10_000.0

# widest model a per-feature serving sketch covers: past this the
# sketch matrix (d x ~80 int64) and the shadow reservoir (256 x d f32)
# stop being cheap host state — hashed/ultra-wide feature spaces skip
# quality capture rather than tax the serving worker's memory
_MAX_SKETCH_FEATURES = 1024

_lock = threading.Lock()
# serializes whole scoring passes (compute()) without blocking folds
_compute_lock = threading.Lock()
# (model, version) -> training-profile snapshot dict
_train: dict = {}
# (model, version, method) -> {"features": FeatureSketch,
#   "predictions": FeatureSketch|None, "classes": CategoricalSketch|None}
_serving: dict = {}
# (model, version, method) -> previous cumulative feature-counts matrix
# (the window-vs-window cursor)
_window_prev: dict = {}
# latched alert keys: (key..., feature, kind) currently above threshold
_alerted: set = set()
# versions per model the registries keep: serve_while_training publishes
# a version per partial_fit pass, and without eviction the sketch
# matrices, the per-tick scoring loop, and the per-version /metrics
# series would all grow forever with the version counter
_VERSIONS_KEEP = 4
# recent canary verdicts (swap-time deltas), newest last
_canaries: list = []
_CANARY_KEEP = 32
# last computed scores per (model, version, method): the /status block
_last_scores: dict = {}


# -- scores -------------------------------------------------------------------

def _proportions(counts):
    counts = np.asarray(counts, np.float64)
    tot = counts.sum()
    if tot <= 0:
        return None
    return np.maximum(counts / tot, _PSI_EPS)


def _coarsen(ref, cur, min_frac=0.05):
    """Merge adjacent fine buckets until each coarse bucket holds at
    least ``min_frac`` of the REFERENCE mass (the same merge applied to
    both sides). The sketches keep ~80 fine buckets so KS and quantiles
    stay sharp; PSI on buckets that fine is dominated by small-count
    noise and the smoothing floor — coarsening to ~deciles restores the
    classic, stable PSI (0.2 alarm line) without re-binning raw data."""
    ref = np.asarray(ref, np.float64)
    cur = np.asarray(cur, np.float64)
    tot = ref.sum()
    out_r, out_c = [], []
    acc_r = acc_c = 0.0
    for r, c in zip(ref, cur):
        acc_r += r
        acc_c += c
        if acc_r >= min_frac * tot:
            out_r.append(acc_r)
            out_c.append(acc_c)
            acc_r = acc_c = 0.0
    if not out_r:
        return np.asarray([acc_r]), np.asarray([acc_c])
    out_r[-1] += acc_r
    out_c[-1] += acc_c
    return np.asarray(out_r), np.asarray(out_c)


def psi_from_counts(p_counts, q_counts) -> float:
    """Population stability index between two aligned histogram count
    vectors (same fixed boundaries; ``p`` is the reference side). The
    fine buckets coarsen to >=5%-of-reference-mass bins first — the
    classic decile PSI — so an in-distribution pair scores near 0 even
    at modest sample sizes. 0 = identical; > 0.2 is the classic
    "significant shift" alarm line."""
    p_counts, q_counts = _coarsen(p_counts, q_counts)
    p = _proportions(p_counts)
    q = _proportions(q_counts)
    if p is None or q is None:
        return float("nan")
    return float(np.sum((p - q) * np.log(p / q)))


def ks_from_counts(p_counts, q_counts) -> float:
    """Kolmogorov–Smirnov statistic (max CDF gap) between two aligned
    count vectors — scale-free companion to PSI."""
    p = np.asarray(p_counts, np.float64)
    q = np.asarray(q_counts, np.float64)
    if p.sum() <= 0 or q.sum() <= 0:
        return float("nan")
    return float(np.max(np.abs(
        np.cumsum(p) / p.sum() - np.cumsum(q) / q.sum()
    )))


def score_pair(ref_counts, cur_counts) -> list:
    """Per-feature [(psi, ks)] over two (n_features, n_buckets) count
    matrices with identical boundaries."""
    ref = np.asarray(ref_counts)
    cur = np.asarray(cur_counts)
    return [(psi_from_counts(ref[f], cur[f]),
             ks_from_counts(ref[f], cur[f]))
            for f in range(ref.shape[0])]


# -- registries ---------------------------------------------------------------

def note_training_profile(model, version, profile) -> None:
    """Register a (model, version)'s training profile snapshot (a
    ``FeatureSketch.to_dict``) — called by ModelServer on start / swap /
    rebuild with whatever ``training_profile_`` the estimator carries.
    None clears nothing and registers nothing."""
    if not profile:
        return
    with _lock:
        _train[(str(model), int(version))] = profile
        evicted = _evict_versions_locked(str(model))
    _drop_version_series(str(model), evicted)


def _evict_versions_locked(model):
    """Caller holds ``_lock``: drop every registry entry for ``model``
    whose version trails the newest by more than ``_VERSIONS_KEEP``;
    returns the evicted versions (the caller drops their /metrics
    series OUTSIDE the lock — live's lock nests inside ours, never
    while we hold it)."""
    versions = {v for (m, v) in _train if m == model}
    versions.update(v for (m, v, _meth) in _serving if m == model)
    doomed = set(sorted(versions)[:-_VERSIONS_KEEP])
    if not doomed:
        return ()
    for reg in (_train, _serving, _window_prev, _last_scores):
        for k in [k for k in reg if k[0] == model and k[1] in doomed]:
            del reg[k]
    for k in [k for k in _alerted if k[0] == model and k[1] in doomed]:
        _alerted.discard(k)
    return tuple(sorted(doomed))


def _drop_version_series(model, evicted) -> None:
    """Unlatch an evicted version's per-version gauge series (stale
    drift scores / canary quantiles must not sit on /metrics forever)."""
    if not evicted:
        return
    try:
        from .live import drop_labeled_series

        for v in evicted:
            for fam in ("drift_score", "canary_prediction"):
                drop_labeled_series(
                    fam, (("model", model), ("version", str(v)))
                )
    except Exception:
        pass


def training_profile(model, version):
    with _lock:
        return _train.get((str(model), int(version)))


def serving_sketch(model, version, method, n_features=None,
                   bounds=None):
    """Create-or-get the serving sketch set for (model, version,
    method). Returns None until the first call that supplies
    ``n_features``."""
    key = (str(model), int(version), str(method))
    if n_features and n_features > _MAX_SKETCH_FEATURES:
        return None
    evicted = ()
    with _lock:
        entry = _serving.get(key)
        if entry is None and n_features:
            entry = _serving[key] = {
                "features": FeatureSketch(n_features, bounds=bounds),
                "predictions": None,
                "classes": None,
                # fold rate-limiter state (token bucket)
                "credit": float(_FOLD_BURST_ROWS),
                "t_credit": time.monotonic(),
            }
            evicted = _evict_versions_locked(key[0])
    _drop_version_series(key[0], evicted)
    return entry


def fold_serving(model, version, method, X_rows, outputs=None,
                 max_rows=256) -> int:
    """Fold one served batch's admitted rows (and its outputs) into the
    (model, version, method) serving sketches. ``max_rows`` strides the
    batch down so a busy server's fold cost stays bounded (the sketch
    is a sample either way — the stride keeps it a uniform one).
    Returns rows folded. Never raises into the serving worker."""
    try:
        X_rows = np.asarray(X_rows)
        if X_rows.ndim != 2 or X_rows.shape[0] == 0:
            return 0
        # align the training profile's bounds when one exists, so the
        # PSI/KS pair subtracts bucket-for-bucket
        prof = training_profile(model, version)
        entry = serving_sketch(
            model, version, method, n_features=X_rows.shape[1],
            bounds=prof["bounds"] if prof else None,
        )
        if entry is None:
            return 0
        # token bucket: replenish, then take at most the credit (and
        # the per-call cap). Racy-but-benign across fleet replicas
        # sharing one key — it is a rate limiter, not an invariant.
        now = time.monotonic()
        with _lock:
            credit = min(
                entry["credit"]
                + (now - entry["t_credit"]) * _FOLD_ROWS_PER_SEC,
                float(_FOLD_BURST_ROWS),
            )
            entry["t_credit"] = now
            take = min(int(credit), X_rows.shape[0], int(max_rows))
            entry["credit"] = credit - take
        if take <= 0:
            return 0
        stride = max(int(math.ceil(X_rows.shape[0] / take)), 1)
        folded = entry["features"].fold(X_rows[::stride])
        if outputs is not None:
            _fold_predictions(entry, np.asarray(outputs), stride, method)
        return folded
    except Exception:
        return 0


def _fold_predictions(entry, out, stride, method):
    if out.ndim == 0:
        return
    numeric = out.dtype.kind in "fiu"
    if numeric:
        cols = out[:, None] if out.ndim == 1 else out
        with _lock:
            pred = entry["predictions"]
            if pred is None or pred.n_features != cols.shape[1]:
                pred = entry["predictions"] = FeatureSketch(cols.shape[1])
        pred.fold(cols[::stride])
    if method == "predict":
        with _lock:
            cat = entry["classes"]
            if cat is None:
                cat = entry["classes"] = CategoricalSketch()
        cat.fold(out[::stride])


# -- shadow sampling + canary -------------------------------------------------

class ShadowBuffer:
    """Bounded reservoir of recent request rows (one per served method):
    the sample a hot-swap canary scores against both versions. A
    credit-based fraction keeps the sampling rate proportional to
    traffic without an RNG on the hot path; the ring overwrites oldest
    rows so the sample tracks RECENT traffic."""

    __slots__ = ("cap", "_buf", "_pos", "_count", "_credit", "_lock")

    def __init__(self, cap=256):
        self.cap = int(cap)
        self._buf = None
        self._pos = 0
        self._count = 0
        self._credit = 0.0
        self._lock = threading.Lock()

    def offer(self, rows, fraction) -> int:
        """Stash ~``fraction`` of ``rows`` (strided, so the take spreads
        across the batch). Returns rows taken."""
        if fraction <= 0:
            return 0
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[0] == 0:
            return 0
        with self._lock:
            self._credit += rows.shape[0] * float(fraction)
            take = min(int(self._credit), rows.shape[0], self.cap)
            if take <= 0:
                return 0
            self._credit -= take
            if self._buf is None or self._buf.shape[1] != rows.shape[1]:
                self._buf = np.zeros((self.cap, rows.shape[1]),
                                     np.float32)
                self._pos = self._count = 0
            picks = rows[:: max(rows.shape[0] // take, 1)][:take]
            for r in picks:
                self._buf[self._pos] = r
                self._pos = (self._pos + 1) % self.cap
            self._count = min(self._count + take, self.cap)
            return take

    def sample(self):
        """A copy of the stashed rows (None when empty)."""
        with self._lock:
            if self._buf is None or self._count == 0:
                return None
            return self._buf[: self._count].copy()


def canary_delta(old_out, new_out) -> dict:
    """Prediction-delta verdict between two versions' outputs on one
    shadow sample: exact disagreement rate plus — for numeric outputs —
    the max quantile shift across p10/p50/p90, normalized by the old
    outputs' scale (max(std, |p90-p10|, eps))."""
    old = np.asarray(old_out)
    new = np.asarray(new_out)
    n = min(old.shape[0], new.shape[0])
    old, new = old[:n], new[:n]
    if old.ndim == 1:
        old, new = old[:, None], new[:, None]
    if old.dtype.kind in "fiu" and new.dtype.kind in "fiu":
        disagree = float(np.mean(
            ~np.isclose(old.astype(np.float64), new.astype(np.float64),
                        rtol=1e-5, atol=1e-6).all(axis=1)
        ))
        qs = (0.10, 0.50, 0.90)
        oq = np.quantile(old.astype(np.float64), qs, axis=0)
        nq = np.quantile(new.astype(np.float64), qs, axis=0)
        scale = max(float(old.std()), float(np.max(oq[2] - oq[0])), 1e-9)
        shift = float(np.max(np.abs(nq - oq)) / scale)
    else:
        disagree = float(np.mean(np.any(old != new, axis=1)))
        shift = disagree
    return {"disagreement": round(disagree, 6),
            "max_quantile_shift": round(shift, 6), "n_rows": int(n)}


def record_canary(model, v_old, v_new, method, old_out, new_out) -> dict:
    """Record one hot-swap canary: prediction sketches for BOTH
    versions' outputs on the shadow sample, the delta verdict, the
    /metrics gauges (per-version series + the delta), and a JSONL
    ``drift`` record. Returns the verdict dict."""
    verdict = canary_delta(old_out, new_out)
    rec = {
        "drift": True, "pair": "canary", "model": str(model),
        "version_from": int(v_old), "version_to": int(v_new),
        "method": str(method), "t_unix": round(time.time(), 6),
        **verdict,
    }
    from ..config import get_config

    threshold = float(get_config().obs_drift_threshold)
    rec["alert"] = bool(verdict["disagreement"] > threshold
                        or verdict["max_quantile_shift"] > threshold)
    if rec["alert"]:
        record_drift_alert()
        # one crossing = one event: the alert engine's builtin:drift
        # rule fires off THIS call alone (never also polled), so the
        # counter above and the engine can't double-count
        from . import alerts as _alerts

        _alerts.note_event("drift", value=verdict["disagreement"], meta={
            "pair": "canary", "model": str(model),
            "version_from": int(v_old), "version_to": int(v_new),
        })
    with _lock:
        _canaries.append(rec)
        del _canaries[:-_CANARY_KEEP]
    _publish_canary(model, v_old, v_new, method, old_out, new_out,
                    verdict)
    _emit(rec)
    return verdict


def _publish_canary(model, v_old, v_new, method, old_out, new_out,
                    verdict):
    from .live import gauge_set, live_publishing

    if not live_publishing():
        return
    base = (("model", str(model)), ("method", str(method)))
    pair = base + (("from", str(v_old)), ("to", str(v_new)))
    gauge_set("canary_disagreement", verdict["disagreement"], pair)
    gauge_set("canary_quantile_shift", verdict["max_quantile_shift"],
              pair)
    # per-VERSION prediction-delta series: the outgoing and incoming
    # versions each expose their shadow-sample prediction quantiles, so
    # a scrape sees both sides of the flip
    for v, out in ((v_old, old_out), (v_new, new_out)):
        out = np.asarray(out)
        if out.dtype.kind not in "fiu" or out.size == 0:
            continue
        flat = out.astype(np.float64).ravel()
        labels = base + (("version", str(v)),)
        gauge_set("canary_prediction_p50", float(np.quantile(flat, 0.5)),
                  labels)
        gauge_set("canary_prediction_p99", float(np.quantile(flat, 0.99)),
                  labels)
        gauge_set("canary_prediction_mean", float(flat.mean()), labels)


# -- the drift computation ----------------------------------------------------

def _emit(rec) -> None:
    """One JSONL drift record through the ambient trace sink (bound fit
    logger / config.trace_dir / config.metrics_path) — the report CLI's
    drift tables read these. Silently no-op without a sink."""
    try:
        from ._spans import _trace_sink

        sink = _trace_sink()
        if sink is not None:
            sink.log(**rec)
    except Exception:
        pass


def _pair_sources(key, cur_counts):
    """The (kind, ref, cur) score pairs for one sketch key — the
    training profile and the window delta — advancing the window
    cursors to ``cur_counts``. The only part of a scoring pass that
    needs ``_lock``, and it is O(copy), not O(scoring): the serving
    worker's fold path contends on this lock, so the PSI/KS math must
    happen outside it."""
    model, version, method = key
    pairs = []
    with _lock:
        prof = _train.get((model, version))
        if prof is not None and prof["n_features"] == cur_counts.shape[0] \
                and len(prof["bounds"]) + 1 == cur_counts.shape[1]:
            pairs.append(("train_serve",
                          np.asarray(prof["counts"], np.int64),
                          cur_counts))
        prev = _window_prev.get(key)
        if prev is not None and prev.shape == cur_counts.shape:
            window = cur_counts - prev
            prev_window = _window_prev.get(key + ("window",))
            if prev_window is not None and window.sum() > 0 \
                    and prev_window.sum() > 0:
                pairs.append(("window", prev_window, window))
            _window_prev[key + ("window",)] = window
        _window_prev[key] = cur_counts
    return pairs


def _score_key(key, pairs, rows, threshold, now):
    """Score one key's pairs (lock-free — the pure-Python coarsen loop
    over up to 1024 features is the expensive part) and then latch
    alerts + the /status summary under one brief ``_lock``."""
    model, version, method = key
    records = []
    summary = {"model": model, "version": version, "method": method,
               "t_unix": round(now, 3), "rows": rows,
               "max_psi": None, "max_ks": None, "alerts": 0}
    scored = [(kind, score_pair(ref, cur)) for kind, ref, cur in pairs]
    new_alerts = 0
    crossings = []
    with _lock:
        for kind, scores in scored:
            psis = [p for p, _ in scores if not math.isnan(p)]
            kss = [k for _, k in scores if not math.isnan(k)]
            if not psis:
                continue
            summary["max_psi"] = max(summary["max_psi"] or 0.0,
                                     max(psis))
            summary["max_ks"] = max(summary["max_ks"] or 0.0,
                                    max(kss) if kss else 0.0)
            for f, (p, k) in enumerate(scores):
                if math.isnan(p):
                    continue
                alert = p > threshold
                latch = key + (f, kind)
                if alert and latch not in _alerted:
                    _alerted.add(latch)
                    summary["alerts"] += 1
                    new_alerts += 1
                    crossings.append((kind, f, p))
                elif not alert:
                    _alerted.discard(latch)
                records.append({
                    "drift": True, "pair": kind, "model": model,
                    "version": version, "method": method,
                    "feature": f"f{f}", "psi": round(p, 6),
                    "ks": round(k, 6) if not math.isnan(k) else None,
                    "alert": alert, "t_unix": round(now, 6),
                })
        _last_scores[key] = summary
    for _ in range(new_alerts):
        record_drift_alert()
    # the same below→above latch drives the alert engine: the _alerted
    # set is the single dedupe source, so a crossing mints exactly one
    # event (builtin:drift is event-only — it is never also polled)
    if crossings:
        from . import alerts as _alerts

        for kind, f, p in crossings:
            _alerts.note_event("drift", value=p, meta={
                "pair": kind, "model": model, "version": version,
                "method": method, "feature": f"f{f}",
            })
    return records


def compute(publish=True) -> list:
    """Score every registered sketch pair now; returns the drift
    records. Publishes gauges when a live telemetry server is up,
    increments ``drift_alerts`` on below→above-threshold crossings,
    and emits each record to the ambient JSONL sink. Called by the
    background monitor on its cadence, and on demand."""
    from ..config import get_config

    # live servers batch their fold samples (pending lists amortize the
    # fold's fixed cost off the hot loop) — flush them first so an
    # on-demand compute scores CURRENT traffic, not traffic as of the
    # last flush tick
    try:
        from . import live

        with live._lock:
            servers = list(live._servers)
        for srv in servers:
            flush = getattr(srv, "_flush_quality", None)
            if flush is not None:
                flush()
    except Exception:
        pass
    threshold = float(get_config().obs_drift_threshold)
    # one scorer at a time: concurrent computes (monitor tick racing an
    # on-demand call) would double-count latch crossings and interleave
    # window-cursor advances; folds are NOT serialized by this — they
    # only touch the brief _lock sections
    with _compute_lock:
        now = time.time()
        with _lock:
            items = list(_serving.items())
        all_records = []
        for key, entry in items:
            cur_counts = entry["features"].counts()
            pairs = _pair_sources(key, cur_counts)
            all_records.extend(_score_key(
                key, pairs, entry["features"].rows, threshold, now
            ))
    if publish:
        _publish_scores(all_records)
    for rec in all_records:
        _emit(rec)
    return all_records


def _publish_scores(records) -> None:
    from .live import gauge_set, live_publishing

    if not live_publishing():
        return
    per_key_max: dict = {}
    for r in records:
        labels = (("model", r["model"]), ("version", str(r["version"])),
                  ("method", r["method"]), ("feature", r["feature"]),
                  ("kind", r["pair"]))
        gauge_set("drift_score", r["psi"], labels)
        mk = (r["model"], r["version"], r["method"], r["pair"])
        per_key_max[mk] = max(per_key_max.get(mk, 0.0), r["psi"])
    for (model, version, method, kind), v in per_key_max.items():
        gauge_set("drift_score_max", v,
                  (("model", model), ("version", str(version)),
                   ("method", method), ("kind", kind)))


def status_block() -> dict:
    """The /status drift view: last computed scores per (model,
    version, method), recent canaries, and the registered sketch keys."""
    with _lock:
        scores = [dict(v) for v in _last_scores.values()]
        canaries = [dict(c) for c in _canaries]
        tracked = [{"model": m, "version": v, "method": meth,
                    "rows": e["features"].rows}
                   for (m, v, meth), e in _serving.items()]
        profiles = [{"model": m, "version": v, "rows": p.get("rows")}
                    for (m, v), p in _train.items()]
    return {"scores": scores, "canaries": canaries,
            "serving_sketches": tracked, "training_profiles": profiles}


# -- background monitor -------------------------------------------------------

_monitor_lock = threading.Lock()
_monitor_thread = None
_monitor_stop = threading.Event()


def monitor_active() -> bool:
    t = _monitor_thread
    return t is not None and t.is_alive()


def ensure_monitor(cfg=None):
    """Start the background drift monitor (idempotent, daemon): every
    ``config.obs_drift_interval_s`` it calls :func:`compute` under the
    ARMING caller's config (config is thread-local — the monitor must
    see the trace sink and thresholds of the fit/server that armed it,
    not the env defaults). No-op when ``obs_drift`` is off or the
    interval is 0."""
    global _monitor_thread
    from .. import config as _config

    cfg = cfg or _config.get_config()
    if not cfg.obs_drift or cfg.obs_drift_interval_s <= 0:
        return None
    with _monitor_lock:
        if monitor_active():
            return _monitor_thread
        _monitor_stop.clear()

        def _loop():
            with _config.use(cfg):
                while not _monitor_stop.wait(cfg.obs_drift_interval_s):
                    try:
                        compute()
                    except Exception:
                        pass  # the monitor must never die mid-run

        _monitor_thread = threading.Thread(
            target=_loop, name="dask-ml-tpu-torch-drift", daemon=True
        )
        _monitor_thread.start()
    return _monitor_thread


def stop_monitor() -> None:
    global _monitor_thread
    with _monitor_lock:
        t, _monitor_thread = _monitor_thread, None
        _monitor_stop.set()
    if t is not None:
        t.join(5.0)


def reset() -> None:
    """Clear every registry and stop the monitor — test isolation."""
    stop_monitor()
    with _lock:
        _train.clear()
        _serving.clear()
        _window_prev.clear()
        _alerted.clear()
        _canaries.clear()
        _last_scores.clear()
