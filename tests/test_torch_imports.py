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
