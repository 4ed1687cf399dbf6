"""The port's drift scoring (``observability/drift.py``) against
dask_ml_tpu's, on the CPU: PSI, KS, ``score_pair``, ``_coarsen`` and
``canary_delta`` within 1e-12 on seeded inputs, the serving sketches and
the scores of ``compute`` (train-vs-serve and window pairs), the servers'
quality capture (the same requests through both packages' ModelServer,
scores equal after ``_flush_quality``), the hot-swap canary, version
eviction and the monitor's lifecycle, driven by hand."""

import threading
import time

import numpy as np
import pytest

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import linear_model as JL
from dask_ml_tpu import serving as JS
from dask_ml_tpu.observability import drift as jdrift
from dask_ml_tpu.serving import _server as jserver
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import serving as TS
from dask_ml_tpu_torch.observability import FeatureSketch, alerts, drift
from dask_ml_tpu_torch.observability import _counters, live
from dask_ml_tpu_torch.serving import _server as tserver

WAIT = 30.0
TOL = 1e-12


def _reset():
    for m in (drift, jdrift, alerts):
        m.reset()


@pytest.fixture(autouse=True)
def _clean():
    # the planes are process-wide: another file's servers may have left
    # a monitor, sketches or events behind
    _reset()
    with config.set(device="cpu"):
        yield
    _reset()


def _counts(seed, n_features=3, n_buckets=80, scale=50):
    rng = np.random.RandomState(seed)
    a = rng.poisson(scale * rng.rand(n_features, n_buckets))
    b = rng.poisson(scale * rng.rand(n_features, n_buckets))
    b[:, : seed % 7] = 0           # empty buckets on one side
    return a, b


# -- the scores ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_scores_match_jax(seed):
    a, b = _counts(seed)
    for f in range(a.shape[0]):
        for min_frac in (0.05, 0.2):
            ra, ca = drift._coarsen(a[f], b[f], min_frac)
            rb, cb = jdrift._coarsen(a[f], b[f], min_frac)
            np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(ca, cb)
        assert abs(drift.psi_from_counts(a[f], b[f])
                   - jdrift.psi_from_counts(a[f], b[f])) <= TOL
        assert abs(drift.ks_from_counts(a[f], b[f])
                   - jdrift.ks_from_counts(a[f], b[f])) <= TOL
    np.testing.assert_allclose(drift.score_pair(a, b),
                               jdrift.score_pair(a, b), rtol=0, atol=TOL)
    assert drift.psi_from_counts(a[0], a[0]) == 0.0
    assert np.isnan(drift.psi_from_counts(np.zeros(5), a[0][:5]))


@pytest.mark.parametrize("kind", ["float", "labels", "columns", "strings"])
def test_canary_delta_matches_jax(kind):
    rng = np.random.RandomState(3)
    if kind == "float":
        old = rng.randn(200)
        new = old + 0.3 * (rng.rand(200) < 0.2)
    elif kind == "labels":
        old = (rng.rand(200) < 0.5).astype(np.float32)
        new = np.where(rng.rand(200) < 0.1, 1 - old, old)
    elif kind == "columns":
        old = rng.rand(200, 3)
        new = old * (1 + 0.01 * rng.randn(200, 3))
    else:
        old = np.array(["a", "b"] * 100)
        new = np.where(rng.rand(200) < 0.3, "c", old)
    got, want = drift.canary_delta(old, new), jdrift.canary_delta(old, new)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= TOL


def test_shadow_buffer_matches_jax():
    rng = np.random.RandomState(4)
    a, b = drift.ShadowBuffer(cap=32), jdrift.ShadowBuffer(cap=32)
    for n in rng.randint(1, 60, 40):
        rows = rng.randn(int(n), 5).astype(np.float32)
        assert a.offer(rows, 0.15) == b.offer(rows, 0.15)
    np.testing.assert_array_equal(a.sample(), b.sample())


# -- registries and compute ---------------------------------------------------

def _scores(records):
    return sorted((r["pair"], r["model"], r["version"], r["method"],
                   r["feature"], r["psi"], r["ks"], r["alert"])
                  for r in records)


def test_compute_matches_jax_train_serve_and_windows():
    """A training profile, then three serving windows (the last shifted
    on feature 1): the same records, alerts and status rows as JAX's."""
    rng = np.random.RandomState(8)
    prof = FeatureSketch(4)
    prof.fold(rng.randn(5000, 4).astype(np.float32))
    snap = prof.to_dict()
    for m in (drift, jdrift):
        m.note_training_profile("m", 0, snap)
    records = []
    for w in range(3):
        X = rng.randn(900, 4).astype(np.float32)
        out = (X[:, 0] > 0).astype(np.float32)
        if w == 2:
            X[:, 1] += 1.5
        folded = [m.fold_serving("m", 0, "predict", X, out, max_rows=900)
                  for m in (drift, jdrift)]
        assert folded[0] == folded[1] == 900
        records.append((_scores(drift.compute(publish=False)),
                        _scores(jdrift.compute(publish=False))))
    for got, want in records:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:5] == w[:5] and g[7] == w[7]
            assert abs(g[5] - w[5]) <= TOL and abs(g[6] - w[6]) <= TOL
    last = records[-1][0]
    assert {r[4] for r in last if r[7]} == {"f1"}
    assert {r[0] for r in last} == {"train_serve", "window"}
    ta = drift.serving_sketch("m", 0, "predict")
    ja = jdrift.serving_sketch("m", 0, "predict")
    assert ta["features"].to_dict() == ja["features"].to_dict()
    assert ta["predictions"].to_dict() == ja["predictions"].to_dict()
    assert ta["classes"].to_dict() == ja["classes"].to_dict()
    a, b = drift.status_block(), jdrift.status_block()
    strip = [{k: v for k, v in s.items() if k != "t_unix"}
             for s in a["scores"]]
    assert strip == [{k: v for k, v in s.items() if k != "t_unix"}
                     for s in b["scores"]]
    assert a["serving_sketches"] == b["serving_sketches"]


def test_drift_alert_counts_once_per_crossing():
    rng = np.random.RandomState(2)
    prof = FeatureSketch(2)
    prof.fold(rng.randn(4000, 2).astype(np.float32))
    drift.note_training_profile("m", 0, prof.to_dict())
    c0 = _counters.counters_snapshot().get("drift_alerts", 0)
    X = rng.randn(2000, 2).astype(np.float32)
    X[:, 0] += 2.0
    drift.fold_serving("m", 0, "predict", X)
    drift.compute(publish=False)
    drift.compute(publish=False)
    assert _counters.counters_snapshot()["drift_alerts"] - c0 == 1
    assert [e["feature"] for e in alerts.events("drift")] == ["f0"]


def test_version_eviction_matches_jax():
    rng = np.random.RandomState(6)
    X = rng.randn(100, 3).astype(np.float32)
    for v in range(7):
        for m in (drift, jdrift):
            m.fold_serving("m", v, "predict", X)
    assert sorted(k[1] for k in drift._serving) == \
        sorted(k[1] for k in jdrift._serving) == [3, 4, 5, 6]


def test_canary_record_publishes_gauges(tmp_path):
    srv = live.TelemetryServer(port=0).start()
    try:
        with config.set(metrics_path=str(tmp_path / "m.jsonl")):
            v = drift.record_canary("m", 0, 1, "predict",
                                    np.zeros(50), np.ones(50))
        g = live.gauges_snapshot()
    finally:
        srv.stop()
    assert v["disagreement"] == 1.0
    assert g[("canary_disagreement", (("model", "m"), ("method", "predict"),
                                      ("from", "0"), ("to", "1")))] == 1.0
    assert [e["event"] for e in alerts.events("drift")] == ["drift"]
    assert drift.status_block()["canaries"][0]["alert"] is True


# -- the servers' quality capture against JAX's --------------------------------

class _Clock:
    """time for a server module with a monotonic clock that moves one
    second a read: every batch passes the fold's rate gate and flushes
    its pending sample, so both packages fold the same batches."""

    def __init__(self):
        self.t = 0.0
        self.perf_counter = time.perf_counter
        self.time = time.time
        self.sleep = time.sleep

    def monotonic(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    X = rng.randn(800, 6).astype(np.float32)
    y = (X @ rng.randn(6) + 0.3 * rng.randn(800) > 0).astype(np.float32)
    y2 = (X @ rng.randn(6) > 0).astype(np.float32)
    with config.set(device="cpu"), jconfig.set(stream_mesh=1):
        # a streamed fit carries the training profile the servers score
        # against; both packages get the same one
        a = JL.LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
        b = JL.LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y2)
        prof = FeatureSketch(6)
        prof.fold(X)
        ta, tb = convert.convert(a), convert.convert(b)
        for est in (a, ta):
            est.training_profile_ = prof.to_dict()
        return a, b, ta, tb, X


def _serve(pkg, cfgmod, est, est2, X, shift):
    with cfgmod.set(obs_drift_interval_s=0.0, obs_shadow_fraction=0.25):
        srv = pkg.ModelServer(est, ladder=pkg.BucketLadder(8, 64, 2.0),
                              batch_window_ms=0.0, name="m").warmup()
        with srv:
            for i in range(12):
                rows = X[i * 20:i * 20 + 5 + i]
                srv.submit(rows + shift).result(WAIT)
            # the worker folds a batch after its caller wakes: park it
            # between batches before the swap reads the shadow rows
            srv.pause()
            srv._flush_quality()
            srv.swap_model(est2)
            srv.resume()
            for i in range(4):
                srv.submit(X[i:i + 30]).result(WAIT)
    return srv


def test_served_quality_matches_jax(models, monkeypatch):
    """The same requests through both packages' ModelServer: equal
    serving sketches, equal train-vs-serve scores after the flush, and
    the same canary verdict on the hot swap."""
    a, b, ta, tb, X = models
    monkeypatch.setattr(tserver, "time", _Clock())
    monkeypatch.setattr(jserver, "time", _Clock())
    shift = np.zeros(6, np.float32)
    shift[2] = 1.0
    _serve(JS, jconfig, a, b, X, shift)
    _serve(TS, config, ta, tb, X, shift)
    for v in (0, 1):
        got = drift.serving_sketch("m", v, "predict")
        want = jdrift.serving_sketch("m", v, "predict")
        assert got["features"].to_dict() == want["features"].to_dict()
        assert got["classes"].to_dict() == want["classes"].to_dict()
    got, want = drift.compute(publish=False), jdrift.compute(publish=False)
    assert len(got) == len(want) > 0
    for g, w in zip(_scores(got), _scores(want)):
        assert g[:5] == w[:5] and g[7] == w[7]
        assert abs(g[5] - w[5]) <= TOL
    assert {r["feature"] for r in got if r["alert"]} == {"f2"}
    (cg,), (cw,) = drift.status_block()["canaries"], \
        jdrift.status_block()["canaries"]
    for k in ("disagreement", "max_quantile_shift", "n_rows",
              "version_from", "version_to", "alert"):
        assert cg[k] == cw[k], k


def test_canary_captures_no_graph_and_tags_the_version(models):
    from dask_ml_tpu_torch.observability import counters_snapshot

    _, _, ta, tb, X = models
    with config.set(obs_drift_interval_s=0.0, obs_shadow_fraction=1.0):
        srv = TS.ModelServer(ta, ladder=TS.BucketLadder(8, 64, 2.0),
                             name="m").warmup()
        with srv:
            for i in range(5):
                srv.submit(X[i:i + 20]).result(WAIT)
            srv.pause()
            c0 = counters_snapshot().get("graph_captures", 0)
            srv.swap_model(tb)
            assert counters_snapshot().get("graph_captures", 0) == c0
            assert srv._canary_versions == {1}
    assert srv._drift_on
    (c,) = drift.status_block()["canaries"]
    assert c["version_to"] == 1 and c["n_rows"] > 0


def test_capture_off_and_rebuild_clears_the_shadow(models):
    _, _, ta, tb, X = models
    with config.set(obs_drift=False):
        with TS.ModelServer(ta, name="m") as srv:
            srv.submit(X[:9]).result(WAIT)
    assert drift.status_block()["serving_sketches"] == []
    with config.set(obs_drift_interval_s=0.0, obs_shadow_fraction=1.0):
        with TS.ModelServer(ta, name="m") as srv:
            srv.submit(X[:9]).result(WAIT)
            assert srv._shadow
            srv.rebuild_model(tb)
            assert not srv._shadow
    rows = {(s["version"], s["rows"])
            for s in drift.status_block()["serving_sketches"]}
    assert rows == {(0, 9)}


# -- the monitor -----------------------------------------------------------------

def test_monitor_lifecycle():
    """Interval 0 or obs_drift off: no thread; otherwise one daemon
    thread, idempotent, joined by stop_monitor (driven without waiting
    for a tick)."""
    with config.set(obs_drift_interval_s=0.0):
        assert drift.ensure_monitor() is None
    with config.set(obs_drift=False):
        assert drift.ensure_monitor() is None
    with config.set(obs_drift_interval_s=30.0):
        t = drift.ensure_monitor()
        assert t is drift.ensure_monitor() and t.daemon
        assert t.name in {x.name for x in threading.enumerate()}
    drift.stop_monitor()
    assert not drift.monitor_active()
