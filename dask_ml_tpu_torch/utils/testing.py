"""Testing helpers. Counterpart of ``dask_ml_tpu/utils/testing.py`` (ref:
``dask_ml/utils.py::assert_estimator_equal``): attribute-wise comparison
of fitted estimators."""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import ShardedArray


def _to_comparable(v):
    if isinstance(v, ShardedArray):
        return v.to_numpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def assert_estimator_equal(left, right, exclude=None, **kwargs):
    """Check that two fitted estimators have equal learned attributes
    (the public names ending in ``_`` both hold).

    kwargs are forwarded to np.testing.assert_allclose (rtol/atol).
    """
    exclude = set(exclude or ())
    l_attrs = {a for a in vars(left) if a.endswith("_")
               and not a.startswith("_")}
    r_attrs = {a for a in vars(right) if a.endswith("_")
               and not a.startswith("_")}
    attrs = (l_attrs & r_attrs) - exclude
    assert attrs, "no common fitted attributes to compare"
    for attr in sorted(attrs):
        lv = _to_comparable(getattr(left, attr))
        rv = _to_comparable(getattr(right, attr))
        assert type(lv).__name__ == type(rv).__name__ or (
            np.isscalar(lv) and np.isscalar(rv)
        ) or (isinstance(lv, np.ndarray) == isinstance(rv, np.ndarray)), (
            f"{attr}: type mismatch {type(lv)} vs {type(rv)}"
        )
        if isinstance(lv, np.ndarray):
            np.testing.assert_allclose(
                lv, rv, err_msg=f"attribute {attr}", **kwargs
            )
        elif np.isscalar(lv) and isinstance(lv, (int, float, np.floating)):
            np.testing.assert_allclose(
                lv, rv, err_msg=f"attribute {attr}", **kwargs
            )
        else:
            assert lv == rv, f"attribute {attr}: {lv!r} != {rv!r}"


def copy_learned_attributes(from_estimator, to_estimator):
    """Ref: dask_ml/utils.py::copy_learned_attributes."""
    for attr, v in vars(from_estimator).items():
        if attr.endswith("_") and not attr.startswith("_"):
            setattr(to_estimator, attr, v)
    return to_estimator
