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
