"""The port's blockwise ensembles against dask_ml_tpu's on host arrays,
on the CPU: eight blocks in both packages, each member fitted on its
block with each package's own estimator. Members' coef_ to 5e-4 (the
GLM parity tolerance of tests/test_torch_glm.py), predictions equal,
soft-vote probabilities to 1e-5, scores to 1e-6 (JAX's accuracy is
f32)."""

import numpy as np
import pytest

from dask_ml_tpu import ensemble as JE
from dask_ml_tpu import linear_model as JL
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import ensemble as TE
from dask_ml_tpu_torch import linear_model as TL
from dask_ml_tpu_torch.parallel import ShardedArray


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _data(seed=0, n=1600, d=5, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, classes)
    y = np.argmax(X @ w + 0.3 * rng.randn(n, classes), axis=1)
    return X, y.astype(np.float32)


@pytest.mark.parametrize("voting", ["hard", "soft"])
@pytest.mark.parametrize("classes", [2, 3])
def test_voting_classifier_matches_jax(voting, classes):
    X, y = _data(classes=classes)
    kw = dict(solver="lbfgs", max_iter=50)
    j = JE.BlockwiseVotingClassifier(JL.LogisticRegression(**kw),
                                     voting=voting).fit(X, y)
    t = TE.BlockwiseVotingClassifier(TL.LogisticRegression(**kw),
                                     voting=voting).fit(X, y)
    assert len(t.estimators_) == len(j.estimators_) == 8
    for a, b in zip(t.estimators_, j.estimators_):
        np.testing.assert_allclose(a.coef_, b.coef_, atol=5e-4)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    assert t.score(X, y) == pytest.approx(j.score(X, y), abs=1e-6)
    if voting == "soft":
        np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                                   atol=1e-5)
    else:
        with pytest.raises(AttributeError, match="soft"):
            t.predict_proba(X)
    c = convert.convert(j)
    assert len(c.estimators_) == 8
    np.testing.assert_array_equal(c.predict(X), j.predict(X))


def test_voting_regressor_matches_jax():
    rng = np.random.RandomState(1)
    X = rng.randn(1200, 4).astype(np.float32)
    y = (X @ [1.0, -2.0, 0.5, 3.0] + 0.1 * rng.randn(1200)).astype(
        np.float32)
    kw = dict(solver="lbfgs", max_iter=50)
    j = JE.BlockwiseVotingRegressor(JL.LinearRegression(**kw)).fit(X, y)
    t = TE.BlockwiseVotingRegressor(TL.LinearRegression(**kw)).fit(X, y)
    assert len(t.estimators_) == 8
    np.testing.assert_allclose(t.predict(X), j.predict(X), atol=1e-3)
    assert t.score(X, y) == pytest.approx(j.score(X, y), abs=1e-5)


def test_sharded_input_is_one_block_and_bad_voting():
    X, y = _data(2)
    t = TE.BlockwiseVotingClassifier(
        TL.LogisticRegression(solver="lbfgs", max_iter=20)).fit(
        ShardedArray.from_array(X), ShardedArray.from_array(y))
    assert len(t.estimators_) == 1
    out = t.predict(ShardedArray.from_array(X))
    assert isinstance(out, ShardedArray)
    with pytest.raises(ValueError, match="voting"):
        TE.BlockwiseVotingClassifier(TL.LogisticRegression(),
                                     voting="x").fit(X, y)


def test_clone_safe_like_scikit_learn():
    """The members are clones: clone(safe=True) refuses an object without
    get_params (and a class), as scikit-learn 1.9's does; safe=False
    deep-copies it; parameters are cloned with safe=False."""
    from sklearn.base import clone as sk_clone

    from dask_ml_tpu_torch.base import clone

    for bad in (object(), TL.LogisticRegression):
        with pytest.raises(TypeError) as ours:
            clone(bad)
        with pytest.raises(TypeError) as theirs:
            sk_clone(bad)
        assert str(ours.value).split(":")[0] == \
            str(theirs.value).split(":")[0]
    payload = {"a": [1, 2]}
    copied = clone(payload, safe=False)
    assert copied == payload and copied["a"] is not payload["a"]
    est = TE.BlockwiseVotingClassifier(
        TL.LogisticRegression(C=0.5, solver_kwargs={"use_kernel": False}))
    twin = clone(est)
    assert twin.estimator is not est.estimator
    assert twin.estimator.get_params() == est.estimator.get_params()
