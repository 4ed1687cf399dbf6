"""The port stands alone: it imports torch, numpy and scipy, and never
jax, optax, scikit-learn or the JAX package (the machine with the card
has neither jax nor scikit-learn)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "sklearn", "dask_ml_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "dask_ml_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_statement(path):
    bad = sorted(set(_imported(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_cpu_fit_loads_no_jax():
    """A tiny CPU fit of both estimators, in a fresh interpreter, leaves
    every forbidden module out of sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
rng = np.random.RandomState(0)
X = rng.randn(200, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu"):
    LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y).predict(X)
    KMeans(n_clusters=3, max_iter=5, random_state=0).fit(X).predict(X)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_cpu_streamed_fit_loads_no_jax(tmp_path):
    """A memmap fit and a streamed predict of both estimators on the CPU,
    in a fresh interpreter, leave every forbidden module out of
    sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
rng = np.random.RandomState(0)
X = np.memmap({str(tmp_path / "X.f32")!r}, dtype=np.float32, mode="w+",
              shape=(300, 4))
X[:] = rng.randn(300, 4)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu", stream_block_rows=128):
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    assert clf.solver_info_["streamed"]
    clf.predict(X)
    km = KMeans(n_clusters=3, max_iter=5, random_state=0).fit(X)
    assert isinstance(km.labels_, np.ndarray)
    km.predict(X)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_cpu_sgd_and_wrappers_load_no_jax(tmp_path):
    """SGD fits (host, memmap, device data), Incremental, ParallelPostFit
    and the batched-trial step on the CPU, in a fresh interpreter, leave
    every forbidden module out of sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import SGDClassifier, SGDRegressor
from dask_ml_tpu_torch.parallel import ShardedArray
from dask_ml_tpu_torch.wrappers import Incremental, ParallelPostFit
rng = np.random.RandomState(0)
X = np.memmap({str(tmp_path / "X.f32")!r}, dtype=np.float32, mode="w+",
              shape=(300, 4))
X[:] = rng.randn(300, 4)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu"):
    clf = SGDClassifier(max_iter=2).fit(X, y)
    assert clf.solver_info_["streamed"]
    clf.predict(X)
    SGDRegressor(max_iter=2).fit(ShardedArray.from_array(np.asarray(X)), y)
    Incremental(SGDClassifier()).fit(np.asarray(X), y).predict(X)
    ParallelPostFit(SGDClassifier(max_iter=1)).fit(X, y).predict_proba(X)
    ms = [SGDClassifier(alpha=a) for a in (1e-4, 1e-2)]
    for m in ms:
        m._batch_prepare({{"classes": np.array([0.0, 1.0])}})
    SGDClassifier._batched_fused_calls(ms, [(X[:150], y[:150]),
                                            (X[150:], y[150:])])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_cpu_searches_load_no_jax():
    """A Hyperband search over SGDClassifier (the streamed cohort plane)
    and a GridSearchCV over LogisticRegression (the C-grid fast path and
    the general path, two threads) with the metrics' scorers, on the CPU
    in a fresh interpreter, leave every forbidden module out of
    sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import LogisticRegression, SGDClassifier
from dask_ml_tpu_torch.model_selection import (GridSearchCV,
                                               HyperbandSearchCV)
rng = np.random.RandomState(0)
X = rng.randn(600, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu"):
    hb = HyperbandSearchCV(SGDClassifier(random_state=0),
                           {{"alpha": [1e-4, 1e-2], "eta0": [0.01, 0.1]}},
                           max_iter=3, random_state=0)
    hb.fit(X, y, classes=[0.0, 1.0])
    assert hb.metadata_["stream"]["streamed"]
    gs = GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=5),
                      {{"C": [0.1, 1.0]}}, cv=2, scoring="roc_auc").fit(X, y)
    assert gs._c_grid_vmapped_ == 2
    GridSearchCV(LogisticRegression(solver="lbfgs", max_iter=5),
                 {{"C": [0.1, 1.0], "intercept_scaling": [1.0]}}, cv=2,
                 n_jobs=2).fit(X, y)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_estimator_surface_array_paths_load_no_pandas():
    """Every module of the estimator surface (preprocessing, impute,
    compose, naive_bayes, ensemble, SpectralClustering, datasets,
    xgboost, convert) imported and its array paths run on the CPU, in a
    fresh interpreter, leave pandas and every forbidden module out of
    sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config, convert, datasets, xgboost
from dask_ml_tpu_torch.cluster import SpectralClustering
from dask_ml_tpu_torch.compose import ColumnTransformer
from dask_ml_tpu_torch.ensemble import (BlockwiseVotingClassifier,
                                        BlockwiseVotingRegressor)
from dask_ml_tpu_torch.impute import SimpleImputer
from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                            LogisticRegression, add_intercept)
from dask_ml_tpu_torch.naive_bayes import GaussianNB
from dask_ml_tpu_torch.preprocessing import (
    BlockTransformer, LabelEncoder, MinMaxScaler, OneHotEncoder,
    OrdinalEncoder, PolynomialFeatures, QuantileTransformer, RobustScaler,
    StandardScaler)
from dask_ml_tpu_torch.wrappers import Incremental
with config.set(device="cpu"):
    X, y = datasets.make_classification(400, 5, random_state=0)
    datasets.make_regression(50, 3, random_state=0)
    datasets.make_counts(50, 3, random_state=0)
    Xb, _ = datasets.make_blobs(300, 4, centers=3, random_state=0)
    Xh, yh = X.to_numpy(), y.to_numpy()
    Xn = Xh.copy()
    Xn[::9, 1] = np.nan
    for s in ("mean", "median", "most_frequent", "constant"):
        SimpleImputer(strategy=s).fit(Xn).transform(Xn)
    for t in (StandardScaler(), MinMaxScaler(), RobustScaler(),
              QuantileTransformer(n_quantiles=50),
              PolynomialFeatures()):
        t.fit(X).transform(X)
    codes = np.random.RandomState(0).randint(0, 3, (400, 2)).astype(
        np.float32)
    OneHotEncoder().fit(codes).transform(codes)
    OrdinalEncoder().fit(codes).transform(codes)
    LabelEncoder().fit_transform(yh)
    BlockTransformer(np.log1p).transform(np.abs(Xh))
    ct = ColumnTransformer([("s", StandardScaler(), [0, 1, 2]),
                            ("c", OneHotEncoder(), [3])],
                           remainder="passthrough").fit(Xh)
    ct.transform(Xh)
    nb = GaussianNB().fit(X, y)
    nb.predict_proba(X)
    Incremental(GaussianNB()).fit(Xh, yh).predict(Xh)
    bv = BlockwiseVotingClassifier(LogisticRegression(solver="lbfgs",
                                                      max_iter=5))
    bv.fit(Xh, yh).predict(Xh)
    BlockwiseVotingRegressor(LinearRegression(solver="lbfgs",
                                              max_iter=5)).fit(Xh, yh)
    sc = SpectralClustering(n_clusters=3, n_init=1, random_state=0,
                            gamma=0.1).fit(Xb)
    add_intercept(X)
    for est in (ct, nb, bv, sc):
        convert.convert(est)
    try:
        xgboost.XGBClassifier
    except ImportError:
        pass
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN + ("pandas",)!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_cpu_checkpointed_fits_load_no_jax(tmp_path):
    """The reliability plane (fault plans, stream checkpoints, the atomic
    writer, the counters and the training profile) killing and resuming
    a streamed fit and a search round, in a fresh interpreter, leaves
    every forbidden module out of sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config, reliability, observability
from dask_ml_tpu_torch.linear_model import LogisticRegression, SGDClassifier
from dask_ml_tpu_torch.model_selection import IncrementalSearchCV
from dask_ml_tpu_torch.utils import checkpoint
rng = np.random.RandomState(0)
X = rng.randn(600, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu", stream_block_rows=128,
                stream_checkpoint_path={str(tmp_path / "s")!r},
                checkpoint_dir={str(tmp_path / "c")!r}):
    with config.set(fault_plan="superblock_dispatch:crash@12"):
        try:
            LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
        except reliability.InjectedCrash:
            pass
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    assert clf.training_profile_["rows"] == 600
    assert observability.counters_snapshot()["stream_resumes"] == 1
    IncrementalSearchCV(SGDClassifier(), {{"alpha": [1e-4, 1e-3]}},
                        n_initial_parameters=2, max_iter=3,
                        random_state=0).fit(X, y, classes=[0.0, 1.0])
    assert reliability.status_block()["counters"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_cpu_serving_loads_no_jax():
    """The plans and the serving plane (compiled_batch_fn in its flavours,
    ModelServer, ModelRegistry, FleetServer with a supervisor and an
    autoscaler, serve_while_training, replay_load_test) serving on the
    CPU, in a fresh interpreter, leave every forbidden module out of
    sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
import scipy.sparse as sp
from dask_ml_tpu_torch import config, plans
from dask_ml_tpu_torch.linear_model import LogisticRegression, SGDClassifier
from dask_ml_tpu_torch.reliability import ReplicaSupervisor
from dask_ml_tpu_torch.serving import (BucketLadder, FleetServer,
                                       ModelRegistry, ModelServer,
                                       ReplicaAutoscaler, replay_load_test,
                                       serve_while_training,
                                       synthesize_records)
from dask_ml_tpu_torch.wrappers import (Incremental, compiled_batch_fn,
                                        sparse_batch_fn)
rng = np.random.RandomState(0)
X = rng.randn(400, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu", serving_supervise=True,
                serving_autoscale=True, serving_slo_ms=1000.0):
    clf = LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    assert compiled_batch_fn(clf, "predict", quantize="int8")(X).shape == (400,)
    assert sparse_batch_fn(clf)(sp.csr_matrix(X[:9])).shape == (9,)
    with ModelServer(clf, ladder=BucketLadder(8, 64)).warmup() as srv:
        assert srv.submit(X[:5]).result(30).shape == (5,)
    inc = Incremental(SGDClassifier(), shuffle_blocks=False)
    inc.partial_fit(X, y, classes=[0.0, 1.0])
    fleet = FleetServer(inc.estimator_, registry=ModelRegistry(),
                        replicas=2, ladder=BucketLadder(8, 64)).warmup()
    with fleet:
        assert isinstance(fleet._supervisor, ReplicaSupervisor)
        assert isinstance(fleet._autoscaler, ReplicaAutoscaler)
        serve_while_training(fleet, inc, X, y, passes=2,
                             classes=[0.0, 1.0])
        rep = replay_load_test(fleet, X, records=synthesize_records(
            10, rate_rps=1e4), result_timeout_s=30)
        assert rep["ok"] == 10, rep
    assert plans.plans_snapshot()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_observability_plane_loads_no_jax(tmp_path):
    """Every observability knob on (metrics file, kernel registry,
    exporter, watchdog) over a resident and a streamed fit, then /status,
    the report and the Chrome-trace export, in a fresh interpreter: no
    forbidden module is loaded."""
    path = str(tmp_path / "m.jsonl")
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config, observability as obs
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.observability import export, live, report
rng = np.random.RandomState(0)
X = rng.randn(600, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu", metrics_path={path!r}, obs_programs=True,
                watchdog_timeout_s=30.0):
    srv = live.TelemetryServer(port=0).start()
    LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    KMeans(n_clusters=3, init=X[:3], max_iter=5).fit(X)
    with config.set(stream_block_rows=256):
        LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    live.status_data()
    lg = obs.MetricsLogger({path!r})
    obs.log_counters(lg)
    obs.log_programs(lg)
    lg.close()
    srv.stop()
recs = report.load_records({path!r})
assert report.main([{path!r}, "--json"]) == 0
export.to_chrome_trace(recs)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]


def test_serving_observability_loads_no_jax(tmp_path):
    """Request traces, drift scoring with the canary, the alert engine
    and the incident plane, on a served streamed fit with every part-2
    knob on, then /status, /traces, /alerts, the report's --incidents
    and the capture replay, in a fresh interpreter: no forbidden module
    is loaded, and each of _requests, drift, alerts and incidents ran."""
    inc = str(tmp_path / "inc")
    path = str(tmp_path / "m.jsonl")
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.observability import (_requests, alerts, drift,
                                             incidents, live, report)
from dask_ml_tpu_torch.serving import ModelServer
rng = np.random.RandomState(0)
X = rng.randn(600, 4).astype(np.float32)
y = (X[:, 0] > 0).astype(np.float32)
with config.set(device="cpu", stream_block_rows=256, obs_trace_sample=0.5,
                obs_drift_interval_s=0.0, obs_shadow_fraction=1.0,
                obs_alert_rules="drift_score_max:gauge>0.2",
                obs_alert_interval_s=60.0, incident_dir={inc!r},
                metrics_path={path!r}):
    clf = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    srv = live.TelemetryServer(port=0).start()
    with ModelServer(clf).warmup() as ms:
        for i in range(6):
            ms.submit(X[i:i + 20] + 3.0).result(30)
        ms.swap_model(clf)
    assert any(r["alert"] for r in drift.compute())
    assert "builtin:drift" in alerts.alerts_data()["firing"]
    live.status_data()
    assert _requests.traces_data()["counts"]["completed"] == 6
    assert incidents.deep_profile(1)["profiled"] is False
    srv.stop()
    alerts.stop_engine()
assert len(incidents.load_bundles({inc!r})) == 1
assert report.main(["--incidents", {inc!r}]) == 0
assert len(_requests.load_capture({path!r})) == 6
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(loaded)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]
