"""The port's serving entry points and ModelServer against dask_ml_tpu's,
on the CPU, with models fitted by the JAX package and carried across by
``convert``.

Tolerances: linear outputs (margins, probabilities, regression) within
1e-5 of JAX's ``compiled_batch_fn``, labels equal wherever |eta| > 1e-5;
the int8 flavour's eta within 1e-5 of JAX's int8 eta (relative to its
largest value) and its labels in at least 99.5 % agreement with f32, as
``tests/test_precision.py`` holds JAX; KMeans labels equal and distances
within 1e-4; PCA, TruncatedSVD and GaussianNB within 1e-5. Packing,
demux, the release rule and the policy are host math: equal. A served
answer equals a direct predict; shed, timeout, drain and pause resolve
each request as the JAX server does. Every wait has a limit of its own.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

from dask_ml_tpu import cluster as JC
from dask_ml_tpu import decomposition as JD
from dask_ml_tpu import linear_model as JL
from dask_ml_tpu import naive_bayes as JN
from dask_ml_tpu import serving as JS
from dask_ml_tpu import wrappers as JW
from dask_ml_tpu.serving import _batching as jbatch
from dask_ml_tpu.serving import policy as jpolicy
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.base import to_host
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch import serving as TS
from dask_ml_tpu_torch import wrappers as TW
from dask_ml_tpu_torch.serving import _batching as tbatch
from dask_ml_tpu_torch.serving import policy as tpolicy

WAIT = 30.0          # seconds any single future or join may take


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(seed=0, n=600, d=12, k=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k)
    y = np.argmax(X @ W + 0.3 * rng.randn(n, k), axis=1) if k > 2 \
        else (X @ W[:, 0] + 0.3 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def binary():
    X, y = _data(0)
    with config.set(device="cpu"):
        j = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
        return j, convert.convert(j), X


@pytest.fixture(scope="module")
def multi():
    X, y = _data(1, d=10, k=3)
    with config.set(device="cpu"):
        j = JL.LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
        return j, convert.convert(j), X


def _ladder(pkg=TS):
    return pkg.BucketLadder(8, 128, 2.0)


def _margin(est, X):
    eta = np.asarray(TW.compiled_batch_fn(est, "decision_function")(X))
    return eta if eta.ndim == 1 else np.sort(eta, axis=1)[:, -1] - \
        np.sort(eta, axis=1)[:, -2]


def _same_labels(got, want, margin):
    keep = np.abs(margin) > 1e-5
    np.testing.assert_array_equal(np.asarray(got)[keep],
                                  np.asarray(want)[keep])


# -- compiled_batch_fn against JAX's ------------------------------------------

@pytest.mark.parametrize("which", ["binary", "multi"])
@pytest.mark.parametrize("method", ["predict", "predict_proba",
                                    "decision_function"])
def test_linear_matches_jax(which, method, request):
    j, t, X = request.getfixturevalue(which)
    for n in (1, 37, 128, len(X)):
        want = np.asarray(JW.compiled_batch_fn(j, method)(X[:n]))
        got = TW.compiled_batch_fn(t, method)(X[:n])
        assert got.shape == want.shape
        if method == "predict":
            _same_labels(got, want, _margin(t, X[:n]))
            _same_labels(got, t.predict(X[:n]), _margin(t, X[:n]))
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["LinearRegression", "PoissonRegression"])
def test_regression_matches_jax(name):
    rng = np.random.RandomState(3)
    X = rng.randn(400, 8).astype(np.float32)
    y = X @ rng.randn(8) * 0.3 + 1.0
    if name == "PoissonRegression":
        y = rng.poisson(np.exp(np.clip(y, -3, 3))).astype(np.float64)
    j = getattr(JL, name)(solver="lbfgs", max_iter=30).fit(X, y)
    t = convert.convert(j)
    want = np.asarray(JW.compiled_batch_fn(j, "predict")(X))
    got = TW.compiled_batch_fn(t, "predict")(X)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, t.predict(X), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["binary", "multi"])
def test_int8_matches_jax(which, request):
    j, t, X = request.getfixturevalue(which)
    j8 = np.asarray(JW.compiled_batch_fn(
        j, "decision_function", quantize="int8")(X))
    t8 = TW.compiled_batch_fn(t, "decision_function", quantize="int8")
    assert t8.quantize == "int8"
    got = t8(X)
    np.testing.assert_allclose(got, j8, rtol=1e-5,
                               atol=1e-5 * np.abs(j8).max())
    q = TW.compiled_batch_fn(t, "predict", quantize="int8")(X)
    f = TW.compiled_batch_fn(t, "predict")(X)
    assert np.mean(q == f) >= 0.995
    # predict_proba has no int8 path: the f32 flavour
    assert TW.compiled_batch_fn(t, "predict_proba",
                                quantize="int8").quantize is None
    with pytest.raises(ValueError):
        TW.compiled_batch_fn(t, "predict", quantize="int4")


def test_int8_quantization_matches_jax():
    rng = np.random.RandomState(5)
    W = rng.randn(4, 30).astype(np.float32)
    W[2] = 0.0
    tq, ts = TW._quantize_w(W)
    jq, js = JW._quantize_w(W)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


def test_sgd_proba_guard_matches_jax():
    X, y = _data(2)
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    j = JSGD(loss="hinge", max_iter=3, random_state=0).fit(X, y)
    t = convert.convert(j)
    with pytest.raises(AttributeError):
        JW.compiled_batch_fn(j, "predict_proba")
    with pytest.raises(AttributeError):
        TW.compiled_batch_fn(t, "predict_proba")
    want = np.asarray(JW.compiled_batch_fn(j, "predict")(X))
    _same_labels(TW.compiled_batch_fn(t, "predict")(X), want,
                 _margin(t, X))


def test_kmeans_matches_jax():
    rng = np.random.RandomState(4)
    centers = rng.randn(5, 6) * 4
    X = (centers[np.arange(500) % 5] + rng.randn(500, 6)).astype(np.float32)
    j = JC.KMeans(n_clusters=5, random_state=0).fit(X)
    t = convert.convert(j)
    np.testing.assert_array_equal(
        TW.compiled_batch_fn(t, "predict")(X),
        np.asarray(JW.compiled_batch_fn(j, "predict")(X)))
    np.testing.assert_allclose(
        TW.compiled_batch_fn(t, "transform")(X),
        np.asarray(JW.compiled_batch_fn(j, "transform")(X)), atol=1e-4)
    np.testing.assert_array_equal(TW.compiled_batch_fn(t, "predict")(X),
                                  np.asarray(t.predict(X).to_numpy()))


@pytest.mark.parametrize("make", [
    lambda: JD.PCA(n_components=3, random_state=0),
    lambda: JD.PCA(n_components=3, whiten=True, random_state=0),
    lambda: JD.TruncatedSVD(n_components=3, random_state=0)],
    ids=["pca", "pca-whiten", "tsvd"])
def test_decomposition_matches_jax(make):
    rng = np.random.RandomState(6)
    X = (rng.randn(400, 8) @ rng.randn(8, 8) + 2.0).astype(np.float32)
    j = make().fit(X)
    t = convert.convert(j)
    np.testing.assert_allclose(
        TW.compiled_batch_fn(t, "transform")(X),
        np.asarray(JW.compiled_batch_fn(j, "transform")(X)), atol=1e-5,
        rtol=1e-5)


def test_naive_bayes_matches_jax():
    X, y = _data(7, d=6, k=3)
    j = JN.GaussianNB().fit(X, y)
    t = convert.convert(j)
    np.testing.assert_array_equal(
        TW.compiled_batch_fn(t, "predict")(X),
        np.asarray(JW.compiled_batch_fn(j, "predict")(X)))
    np.testing.assert_allclose(
        TW.compiled_batch_fn(t, "predict_proba")(X),
        np.asarray(JW.compiled_batch_fn(j, "predict_proba")(X)), atol=1e-5)


def _pipelines():
    from sklearn.pipeline import Pipeline

    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD
    from dask_ml_tpu.preprocessing import StandardScaler as JScaler

    X, y = _data(8, d=10)
    X = X * 3.0 + 1.0
    sc = JScaler().fit(X)
    clf = JSGD(max_iter=3, random_state=0).fit(sc.transform(X).to_numpy(), y)
    jp = Pipeline([("sc", sc), ("clf", clf)])
    tp = Pipeline([("sc", convert.convert(sc)), ("clf", convert.convert(clf))])
    return jp, tp, X


def test_pipeline_matches_jax():
    jp, tp, X = _pipelines()
    for method in ("predict", "predict_proba"):
        want = np.asarray(JW.compiled_batch_fn(jp, method)(X))
        fn = TW.compiled_batch_fn(tp, method)
        assert fn.jitted and fn.n_features == 10
        got = fn(X)
        if method == "predict":
            _same_labels(got, want, _margin(
                tp.steps[-1][1], to_host(tp.steps[0][1].transform(X))))
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_sparse_flavour_matches_jax(binary, multi):
    for j, t, X in (binary, multi):
        rng = np.random.RandomState(9)
        Xs = sp.csr_matrix(X * (rng.rand(*X.shape) < 0.3))
        for method in ("predict", "decision_function"):
            jf = JW.sparse_batch_fn(j, method)
            tf = TW.sparse_batch_fn(t, method)
            assert tf.nnz_ladder.buckets == jf.nnz_ladder.buckets
            for lo, n, bucket in ((0, 50, 64), (50, 8, 8), (100, 128, 128)):
                want = np.asarray(jf(Xs[lo:lo + n], n_rows=bucket))
                got = tf(Xs[lo:lo + n], n_rows=bucket)
                if method == "predict":
                    _same_labels(got, want, _margin(t, Xs[lo:lo + n]
                                                    .toarray()))
                else:
                    np.testing.assert_allclose(got, want, atol=1e-5)
        assert TW.sparse_batch_fn(t, "predict_proba") is None


def test_host_fallback_and_unknown_method(binary):
    from sklearn.linear_model import LogisticRegression as SkLR

    _, t, X = binary
    sk = SkLR().fit(X, X[:, 0] > 0)
    fn = TW.compiled_batch_fn(sk, "predict_proba")
    assert not fn.jitted and fn.graphs is None
    np.testing.assert_array_equal(fn(X[:20]), sk.predict_proba(X[:20]))
    with pytest.raises(AttributeError):
        TW.compiled_batch_fn(t, "no_such_method")


def test_swap_parity_and_refusals(binary):
    j, a, X = binary
    b = convert.convert(JL.LogisticRegression(solver="lbfgs", max_iter=30)
                        .fit(*_data(11)))
    for method in ("predict", "predict_proba", "decision_function"):
        fn = TW.compiled_batch_fn(a, method)
        fn(X[:37])
        keys = fn.graphs.keys()
        for est in (b, a, b):
            fn.swap_params(est)
            np.testing.assert_array_equal(
                fn(X[:37]), TW.compiled_batch_fn(est, method)(X[:37]))
        assert fn.graphs.keys() == keys and fn.version == 3
    wide = convert.convert(JL.LogisticRegression(
        solver="lbfgs", max_iter=10).fit(*_data(12, d=9)))
    fn = TW.compiled_batch_fn(a, "predict")
    with pytest.raises(TW.ParamSwapError):
        fn.swap_params(wide)
    assert fn.version == 0


# -- host math against JAX ---------------------------------------------------

def test_pack_and_demux_match_jax():
    rng = np.random.RandomState(0)
    blocks = [rng.randn(n, 5).astype(np.float32) for n in (3, 1, 9, 4)]
    ladder = (TS.BucketLadder(4, 64, 2.0), JS.BucketLadder(4, 64, 2.0))
    outs = []
    for mod, lad in zip((tbatch, jbatch), ladder):
        reqs = [mod.Request(b, "predict") for b in blocks]
        staging = mod.PingPongStaging()
        staging.get(32, 5)[:] = 7.0           # stale rows: zeroed by pack
        staging.get(32, 5)[:] = 7.0
        buf, segs, bucket, rows = mod.pack_batch(reqs, lad, staging)
        out = buf.sum(axis=1)
        mod.demux_outputs(out, segs)
        outs.append((buf.copy(), [s for _, s in segs], bucket, rows,
                     [r.future.result(WAIT) for r in reqs]))
    (tb, ts, tk, tr, tres), (jb, js, jk, jr, jres) = outs
    np.testing.assert_array_equal(tb, jb)
    assert ts == js and tk == jk == 32 and tr == jr == 17
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a, b)


def test_release_deadline_matches_jax():
    grid = [(10.0, 11.0, 0.005, 0.0, None), (10.0, 11.0, 0.005, 0.1, None),
            (10.0, 10.0, 0.005, 0.1, 0.02), (10.0, 11.0, 0.005, 0.05, 0.04),
            (3.0, 3.01, 0.002, 0.03, 0.001)]
    for args in grid:
        assert tbatch.release_deadline(*args) == \
            jbatch.release_deadline(*args)


def test_bounded_queue_matches_jax():
    for mod in (tbatch, jbatch):
        q = mod.BoundedQueue(4)
        reqs = [mod.Request(np.zeros((n, 2), np.float32), m)
                for n, m in ((3, "a"), (5, "b"), (2, "a"), (9, "a"))]
        assert [q.put(r) for r in reqs] == [True] * 4
        assert not q.put(mod.Request(np.zeros((1, 2)), "a"))
        assert q.put_many([reqs[0]]) == "full"
        first = q.pop_first(0.0)
        got = q.drain_method("a", 4)
        order = (first.n_rows, [r.n_rows for r in got], q.depth, q.rows)
        q.close()
        assert q.put_many([reqs[0]]) == "closed"
        if mod is tbatch:
            t_order = order
    assert t_order == order == (3, [2], 2, 14)


def test_policy_matches_jax():
    te, je = tpolicy.ExecStats(), jpolicy.ExecStats()
    rng = np.random.RandomState(0)
    for _ in range(40):
        m, b = ("predict", "proba")[rng.randint(2)], int(
            2 ** rng.randint(3, 8))
        v = float(rng.lognormal(-6, 1))
        te.observe(m, b, v)
        je.observe(m, b, v)
    assert te.snapshot() == je.snapshot()
    for m in ("predict", "proba", "none"):
        for b in (8, 16, 32, 64, 128, 256):
            assert te.predict_s(m, b) == je.predict_s(m, b)
    snap = te.snapshot()
    for args in [(0, 4, 128, 0.01), (300, 4, 128, 0.01), (10, 1, 8, None),
                 (10, 1, 8, float("nan")), (10, 1, 8, 0.0)]:
        assert tpolicy.predict_completion_s(*args) == \
            jpolicy.predict_completion_s(*args)
    for p, slo in [(None, 0.1), (0.05, 0.1), (0.2, 0.1),
                   (float("nan"), 0.1), (0.2, 0.0)]:
        assert tpolicy.admission_verdict(p, slo) == \
            jpolicy.admission_verdict(p, slo)
    for m, b in (("predict", 20), ("proba", 300), ("x", 8)):
        assert tpolicy.exec_from_snapshot(snap, m, b) == \
            jpolicy.exec_from_snapshot(snap, m, b)


def test_histograms_match_jax():
    from dask_ml_tpu.observability import _hist as jh
    from dask_ml_tpu_torch.observability import _hist as th

    rng = np.random.RandomState(1)
    vals = rng.lognormal(-5, 2, 500)
    a, b = th.Histogram(), jh.Histogram()
    for v in vals:
        a.observe(v)
        b.observe(v)
    prev_a, prev_b = a.snapshot(), b.snapshot()
    for v in vals[:50] * 3:
        a.observe(v)
        b.observe(v)
    assert a.snapshot() == b.snapshot()
    assert a.percentiles((50, 90, 99)) == b.percentiles((50, 90, 99))
    assert th.snapshot_delta(a.snapshot(), prev_a) == \
        jh.snapshot_delta(b.snapshot(), prev_b)
    assert th.merge_snapshots([prev_a, a.snapshot()]) == \
        jh.merge_snapshots([prev_b, b.snapshot()])


# -- ModelServer --------------------------------------------------------------

def _client_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a client hung"


def test_served_answers_equal_direct_predict(binary):
    _, t, X = binary
    margin = _margin(t, X)
    want, proba = t.predict(X), t.predict_proba(X)
    srv = TS.ModelServer(t, methods=("predict", "predict_proba"),
                         ladder=_ladder(), batch_window_ms=2.0,
                         timeout_ms=0).warmup()
    errs = []
    c0 = obs.counters_snapshot().get("graph_captures", 0)

    def client(s):
        rng = np.random.RandomState(100 + s)
        for _ in range(20):
            n = int(rng.randint(1, 200))     # > top bucket: chunked
            i = int(rng.randint(0, len(X) - n))
            try:
                got = srv.submit(X[i:i + n]).result(WAIT)
                _same_labels(got, want[i:i + n], margin[i:i + n])
                p = srv.submit(X[i:i + n], "predict_proba").result(WAIT)
                np.testing.assert_allclose(p, proba[i:i + n], atol=1e-5)
            except Exception as exc:  # noqa: BLE001 - reported below
                errs.append(repr(exc))

    with srv:
        _client_threads(client, 6)
        stats = srv.stats()
    assert not errs, errs[:3]
    assert obs.counters_snapshot().get("graph_captures", 0) == c0
    assert stats["batches"] < stats["requests"]
    assert stats["warmed"] and stats["exec_s"]


def test_warmup_captures_each_bucket_once(binary):
    _, t, X = binary
    c0 = obs.counters_snapshot().get("graph_captures", 0)
    srv = TS.ModelServer(t, methods=("predict", "decision_function"),
                         ladder=_ladder()).warmup()
    n_warm = obs.counters_snapshot()["graph_captures"] - c0
    assert n_warm == 2 * len(srv.ladder)
    srv.warmup()                                    # idempotent
    assert obs.counters_snapshot()["graph_captures"] - c0 == n_warm
    # a second server over the same model warms its own graphs
    TS.ModelServer(t, ladder=_ladder()).warmup()
    assert obs.counters_snapshot()["graph_captures"] - c0 == \
        n_warm + len(srv.ladder)


def test_same_shape_swap_captures_nothing(binary):
    _, a, X = binary
    b = convert.convert(JL.LogisticRegression(solver="lbfgs", max_iter=30)
                        .fit(*_data(11)))
    with config.set(serving_warm_flavors="int8"):
        srv = TS.ModelServer(a, ladder=_ladder(), batch_window_ms=1.0,
                             timeout_ms=0).warmup()
    swaps = [(b, None), (a, "int8"), (b, None), (a, None)]
    wants = [TW.compiled_batch_fn(est, "predict", quantize=q)(X[:50])
             for est, q in swaps]
    with srv:
        c0 = obs.counters_snapshot().get("graph_captures", 0)
        for k, ((est, q), want) in enumerate(zip(swaps, wants)):
            srv.swap_model(est, version=k + 2, quantize=q)
            np.testing.assert_array_equal(srv.submit(X[:50]).result(WAIT),
                                          want)
        assert obs.counters_snapshot()["graph_captures"] == c0
        assert srv.model_version == 5
        with pytest.raises(TW.ParamSwapError):
            srv.swap_model(a, quantize="int4")


def test_server_swap_is_all_or_nothing(binary):
    _, a, X = binary
    from dask_ml_tpu.models.sgd import SGDClassifier as JSGD

    hinge = convert.convert(JSGD(loss="hinge", max_iter=3, random_state=0)
                            .fit(*_data(2)))
    srv = TS.ModelServer(a, methods=("predict", "predict_proba"),
                         ladder=_ladder())
    with pytest.raises(TW.ParamSwapError):
        srv.swap_model(hinge)
    with srv:
        np.testing.assert_array_equal(srv.predict(X[:10]), a.predict(X[:10]))
    assert srv.model_version == 0


def test_pipeline_served_and_swapped():
    jp, tp, X = _pipelines()
    srv = TS.ModelServer(tp, methods=("predict", "predict_proba"),
                         ladder=_ladder(), batch_window_ms=1.0)
    with srv.warmup():
        np.testing.assert_array_equal(
            srv.predict(X[:16]),
            TW.compiled_batch_fn(tp, "predict")(X[:16]))
        srv.swap_model(tp, version=2)
        np.testing.assert_allclose(srv.predict_proba(X[:16]).sum(1), 1.0,
                                   atol=1e-5)


def test_sparse_requests_served(binary):
    _, t, X = binary
    rng = np.random.RandomState(3)
    Xs = sp.csr_matrix(X * (rng.rand(*X.shape) < 0.2))
    parts = [(0, 5), (5, 40), (45, 100)]
    wants = [(t.predict(Xs[lo:lo + n].toarray()),
              _margin(t, Xs[lo:lo + n].toarray())) for lo, n in parts]
    with config.set(serving_sparse_nnz_per_row=3, serving_max_batch=128):
        srv = TS.ModelServer(t, ladder=_ladder(), batch_window_ms=1.0,
                             timeout_ms=0)
    srv.warmup()
    srv.warmup_sparse()
    with srv:
        c0 = obs.counters_snapshot().get("graph_captures", 0)
        for (lo, n), (want, margin) in zip(parts, wants):
            _same_labels(srv.submit(Xs[lo:lo + n]).result(WAIT), want,
                         margin)
        assert obs.counters_snapshot()["graph_captures"] == c0
        spills = obs.counters_snapshot().get("serving_sparse_spills", 0)
        big = sp.csr_matrix(X[:128])          # dense rows: nnz over the top
        np.testing.assert_array_equal(srv.submit(big).result(WAIT),
                                      srv.predict(X[:128]))
        assert obs.counters_snapshot()["serving_sparse_spills"] == \
            spills + 1
        assert obs.counters_snapshot()["graph_captures"] == c0
    proba = TS.ModelServer(t, methods=("predict_proba",),
                           ladder=_ladder()).start()
    try:
        with pytest.raises(ValueError):
            proba.submit(Xs[:3], "predict_proba")
    finally:
        proba.stop()


def _scenarios(pkg, est, X):
    """Shed, timeout, drain, no-drain stop, pause and restart on one
    package's server; each request's outcome by exception type name."""
    out = {}

    def outcome(f):
        try:
            return ("ok", tuple(np.asarray(f.result(WAIT)).shape))
        except Exception as exc:  # noqa: BLE001 - the outcome itself
            return (type(exc).__name__,)

    with pkg.ModelServer(est, ladder=_ladder(pkg), max_queue=3,
                         batch_window_ms=1.0, timeout_ms=0) as srv:
        srv.pause()
        futs = [srv.submit(X[:4]) for _ in range(3)]
        try:
            srv.submit(X[:4])
            out["shed"] = "admitted"
        except pkg.ServerOverloaded:
            out["shed"] = "ServerOverloaded"
        srv.resume()
        out["after_shed"] = [outcome(f) for f in futs]
    with pkg.ModelServer(est, ladder=_ladder(pkg), batch_window_ms=1.0,
                         timeout_ms=50.0) as srv:
        srv.pause()
        f = srv.submit(X[:4])
        time.sleep(0.2)
        srv.resume()
        out["timeout"] = outcome(f)
    srv = pkg.ModelServer(est, ladder=_ladder(pkg), batch_window_ms=1.0,
                          timeout_ms=0).start()
    srv.pause()
    futs = [srv.submit(X[i:i + 5]) for i in range(0, 50, 5)]
    srv.stop(drain=True, timeout=WAIT)
    out["drain"] = [outcome(f) for f in futs]
    try:
        srv.submit(X[:4])
    except pkg.ServerClosed:
        out["closed"] = "ServerClosed"
    srv.start()                                # restart after stop
    out["restart"] = outcome(srv.submit(X[:7]))
    srv.pause()
    f = srv.submit(X[:4])
    srv.stop(drain=False, timeout=WAIT)
    out["no_drain"] = outcome(f)
    try:
        srv.submit(X[:4], method="transform")
    except ValueError:
        out["bad_method"] = "ValueError"
    # stopped after: a started server stays listed on its package's live
    # plane (a later /status test of the same process would read it)
    big = pkg.ModelServer(est, ladder=_ladder(pkg), max_queue=2).start()
    try:
        big.submit(np.zeros((1000, X.shape[1]), np.float32))
    except ValueError:
        out["oversize"] = "ValueError"
    finally:
        big.stop()
    return out


def test_backpressure_timeout_drain_pause_match_jax(binary):
    j, t, X = binary
    got = _scenarios(TS, t, X)
    want = _scenarios(JS, j, X)
    assert got == want
    assert got["shed"] == "ServerOverloaded"
    assert got["timeout"] == ("RequestTimeout",)
    assert got["no_drain"] == ("ServerClosed",)


def test_execute_fault_fails_only_its_batch(binary):
    from dask_ml_tpu_torch import reliability

    _, t, X = binary
    reliability.reset_plans()
    with config.set(fault_plan="serving_execute:crash@1"):
        srv = TS.ModelServer(t, ladder=_ladder(), batch_window_ms=0.0,
                             timeout_ms=0)
    with srv:
        results = []
        for k in range(4):
            f = srv.submit(X[k:k + 3])
            try:
                results.append(("ok", f.result(WAIT).shape))
            except TS.ServingError as exc:
                results.append(("typed", "InjectedCrash" in str(exc)))
    assert results == [("ok", (3,)), ("typed", True), ("ok", (3,)),
                       ("ok", (3,))]
    assert srv.healthy is False           # stopped, not crashed
    reliability.reset_plans()


def test_slo_deadline_release(binary):
    _, t, X = binary
    with config.set(serving_slo_ms=60.0):
        srv = TS.ModelServer(t, ladder=_ladder(), batch_window_ms=200.0,
                             timeout_ms=0).warmup()
    with srv:
        srv.predict(X[:4])
        t0 = time.perf_counter()
        srv.predict(X[:4])
        lat = time.perf_counter() - t0
    assert lat < 0.12
    srv2 = TS.ModelServer(t, ladder=_ladder(), batch_window_ms=200.0,
                          timeout_ms=0).warmup()
    with srv2:
        t0 = time.perf_counter()
        srv2.predict(X[:4])
        assert time.perf_counter() - t0 >= 0.15


def test_stats_windows_and_spans(binary, tmp_path):
    import json

    _, t, X = binary
    with config.set(trace_dir=str(tmp_path)):
        srv = TS.ModelServer(t, ladder=_ladder(), batch_window_ms=1.0,
                             timeout_ms=0)
    with srv:
        for _ in range(20):
            srv.predict(X[:8])
        s1 = srv.stats()
        s2 = srv.stats()
        for _ in range(5):
            srv.predict(X[:8])
        s3 = srv.stats()
    assert s1["requests"] == 20 and s3["requests"] == 25
    assert s1["latency_window_s"]["p50"] > 0
    assert np.isnan(s2["latency_window_s"]["p50"])
    assert s2["latency_s"]["p50"] > 0 and s3["exec_s"]
    recs = [json.loads(line) for line in
            open(tmp_path / "trace.jsonl").read().splitlines()]
    batches = [r for r in recs if r["span"] == "serving.batch"]
    assert len(batches) == 25 and batches[0]["bucket"] == 8
    assert batches[0]["rows"] == 8 and batches[0]["occupancy"] == 1.0


def test_served_score_matches_jax(binary):
    j, t, X = binary
    y = t.predict(X)
    with TS.ModelServer(t, ladder=_ladder()) as srv:
        assert srv.score(X[:100], y[:100]) == 1.0
    with JS.ModelServer(j, ladder=_ladder(JS)) as jsrv:
        assert jsrv.score(X[:100], y[:100]) == 1.0


def test_swaps_under_contention_are_never_torn():
    """Eight clients against one entry point while another thread swaps
    between two models with different weights AND labels, the switch
    interval shortened: every answer is wholly one model's (a torn swap
    would pair one model's weights with the other's labels)."""
    import sys

    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y = _data(13, n=300, d=6)
    a = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
    b = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, 5.0 + 2 * y)
    b.coef_ = -np.asarray(b.coef_)
    b.intercept_ = -np.asarray(b.intercept_)
    want = [a.predict(X[:64]), b.predict(X[:64])]
    assert set(want[0]) == {0.0, 1.0} and set(want[1]) == {5.0, 7.0}
    fn = TW.compiled_batch_fn(a, "predict")
    stop, errs = threading.Event(), []

    def client(_):
        while not stop.is_set():
            got = fn(X[:64])
            if not any(np.array_equal(got, w) for w in want):
                errs.append(got)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for k in range(60):
            fn.swap_params((b, a)[k % 2])
        stop.set()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs and fn.version == 60


def _drive_live(live, cfg):
    live.metrics_reset()
    with cfg.set(obs_max_series=2):
        for r in range(4):
            live.gauge_set("serving_replica_version", r + 10,
                           (("replica", str(r)),))
        live.gauge_set("serving_queue_depth", 3)
        live.histogram("lat", (("m", "a"),)).observe(0.01)
        live.histogram("lat", (("m", "b"),)).observe(0.02)
        live.histogram("lat", (("m", "c"),)).observe(0.03)
    dropped = live.drop_labeled_series("serving_replica",
                                       (("replica", "0"),))
    snap = live.gauges_snapshot()
    hists = {k: v.count for k, v in live.histograms_snapshot().items()}
    live.metrics_reset()
    return snap, hists, dropped, live.live_publishing()


def test_live_registry_matches_jax():
    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.observability import live as jlive
    from dask_ml_tpu_torch.observability import live as tlive

    assert _drive_live(tlive, config) == _drive_live(jlive, jconfig)


def test_replica_gauges_publish_while_armed(binary):
    from dask_ml_tpu_torch.observability import live

    _, t, X = binary
    live.metrics_reset()
    live._publishing_arm(+1)
    try:
        with TS.FleetServer(t, replicas=2, ladder=_ladder(),
                            batch_window_ms=1.0, timeout_ms=0) as fleet:
            fleet.submit(X[:9]).result(WAIT)
            fleet.publish(t)
            g = live.gauges_snapshot()
            assert g[("serving_replica_version", (("replica", "0"),))] == 2
            assert g[("serving_replicas", (("fleet", "model"),))] == 2
            assert any(k[0] == "serving_latency_seconds"
                       for k in live.histograms_snapshot())
        g = live.gauges_snapshot()
        assert not any(("replica", "0") in k[1] for k in g)
    finally:
        live._publishing_arm(-1)
        live.metrics_reset()
