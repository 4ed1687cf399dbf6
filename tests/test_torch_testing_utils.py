"""dask_ml_tpu_torch.utils.testing.assert_estimator_equal, the
counterpart of dask_ml_tpu/utils/testing.py: it passes on two equal fits
and fails on a changed coef_ (on the CPU)."""

import numpy as np
import pytest

from dask_ml_tpu.utils.testing import assert_estimator_equal as jequal
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.utils.testing import assert_estimator_equal


def _fit(est):
    rng = np.random.RandomState(0)
    X = rng.randn(500, 5).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(500) > 0).astype(np.float32)
    with config.set(device="cpu"):
        return est.fit(X, y)


@pytest.mark.parametrize("make", [
    lambda: LogisticRegression(solver="lbfgs", max_iter=20),
    lambda: KMeans(n_clusters=3, random_state=0, max_iter=10),
])
def test_equal_fits_pass_and_a_changed_coef_fails(make):
    a, b = _fit(make()), _fit(make())
    assert_estimator_equal(a, b)
    attr = "coef_" if hasattr(a, "coef_") else "cluster_centers_"
    bumped = getattr(b, attr).copy()
    bumped.flat[0] += 1e-3
    setattr(b, attr, bumped)
    with pytest.raises(AssertionError, match=attr):
        assert_estimator_equal(a, b)
    # the JAX package's helper agrees on the same pair
    with pytest.raises(AssertionError, match=attr):
        jequal(a, b)
    assert_estimator_equal(a, b, exclude={attr})
