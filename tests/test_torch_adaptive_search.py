"""The port's adaptive searches against dask_ml_tpu's, on the CPU.

HyperbandSearchCV, SuccessiveHalvingSearchCV, IncrementalSearchCV and
InverseDecaySearchCV over SGD estimators run in both packages on the
same host data. dask_ml_tpu runs on one device (``stream_mesh=1`` and a
one-device mesh, as in tests/test_torch_sgd.py), so both cut the same
train split (``np.random.RandomState``), the same candidates (the port's
ParameterSampler draws scikit-learn's sequence) and the same
``fit_block_rows`` partition: the searches must agree in
``cv_results_["params"]`` and ``partial_fit_calls``, every test score
within 2 / n_test (one holdout row) and ``best_params_``.

The port's streamed cohort plane (one BlockStream pass a round, one
``fused_sgd_many_block_grad`` launch a block step on the card) is held
to its device-resident plane (``config.search_stream=False``), and
``_streamed_cohort_round`` itself to per-model ``partial_fit`` loops
over the same blocks (1e-6), with the rows of models not active at a
step left bit-identical.
"""

import numpy as np
import pytest
import torch

import jax

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import model_selection as JMS
from dask_ml_tpu.models import sgd as JSGD
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import model_selection as TMS
from dask_ml_tpu_torch.models import sgd as TSGD
from dask_ml_tpu_torch.model_selection import _incremental
from dask_ml_tpu_torch.parallel.sharded import ShardedArray
from dask_ml_tpu_torch.parallel.streaming import BlockStream

N, D = 3000, 12
TEST_SIZE = 0.15
N_TEST = int(np.ceil(N * TEST_SIZE))
PARAMS = {"alpha": [1e-5, 1e-4, 1e-3, 1e-2],
          "eta0": [0.01, 0.05, 0.1, 0.3]}


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every superblock in fresh buffers
    (the reference's own switch; see tests/test_torch_sgd.py)."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _jax(fn, **cfg):
    with jconfig.set(stream_mesh=1, **cfg), \
            use_mesh(device_mesh(devices=jax.devices()[:1])):
        return fn()


def _data(kind="binary", seed=4, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D).astype(np.float32)
    if kind == "binary":
        return X, (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, (X @ rng.randn(D) + 0.3 * rng.randn(n)).astype(np.float32)


def _compare(got, ref):
    assert got.cv_results_["params"] == ref.cv_results_["params"]
    np.testing.assert_array_equal(got.cv_results_["partial_fit_calls"],
                                  ref.cv_results_["partial_fit_calls"])
    np.testing.assert_allclose(got.cv_results_["test_score"],
                               ref.cv_results_["test_score"],
                               atol=2.0 / N_TEST)
    assert got.best_params_ == ref.best_params_
    assert got.metadata_["partial_fit_calls"] == \
        ref.metadata_["partial_fit_calls"]
    assert len(got.history_) == len(ref.history_)


def _search(ms, sgd, which, **kw):
    est = sgd.SGDClassifier(tol=1e-3, random_state=0)
    if which == "hyperband":
        return ms.HyperbandSearchCV(est, PARAMS, max_iter=9,
                                    aggressiveness=3, random_state=0, **kw)
    if which == "sha":
        return ms.SuccessiveHalvingSearchCV(
            est, PARAMS, n_initial_parameters=9, n_initial_iter=2,
            max_iter=12, aggressiveness=3, random_state=1, **kw)
    if which == "incremental":
        return ms.IncrementalSearchCV(est, PARAMS, n_initial_parameters=6,
                                      max_iter=8, random_state=2, **kw)
    return ms.InverseDecaySearchCV(est, PARAMS,
                                   n_initial_parameters="grid",
                                   decay_rate=2.0, max_iter=5,
                                   patience=2, tol=1e-3, random_state=3,
                                   **kw)


@pytest.mark.parametrize("which", ["hyperband", "sha", "incremental",
                                   "inverse_decay"])
def test_search_matches_jax(which):
    X, y = _data()
    classes = {"classes": [0.0, 1.0]}
    ref = _jax(lambda: _search(JMS, JSGD, which).fit(X, y, **classes))
    got = _search(TMS, TSGD, which).fit(X, y, **classes)
    _compare(got, ref)
    assert got.metadata_["stream"]["streamed"]
    assert got.metadata_["stream"]["block_rows"] == \
        ref.metadata_["stream"]["block_rows"]
    np.testing.assert_allclose(got.best_estimator_.coef_,
                               ref.best_estimator_.coef_, atol=1e-5)
    if which == "hyperband":
        assert got.metadata_["brackets"] == ref.metadata_["brackets"]
        assert got.metadata() == ref.metadata()
        np.testing.assert_array_equal(got.cv_results_["bracket"],
                                      ref.cv_results_["bracket"])
    assert got.score(X, y) == pytest.approx(ref.score(X, y), abs=2.0 / N)


def test_streamed_plane_matches_device_plane():
    X, y = _data(seed=5)

    def run(stream):
        with config.set(search_stream=stream):
            return _search(TMS, TSGD, "hyperband").fit(
                X, y, classes=[0.0, 1.0])

    streamed, device = run(True), run(False)
    _compare(streamed, device)
    assert not device.metadata_["stream"]["streamed"]
    meta = streamed.metadata_["stream"]
    # one launch per block step of each round's timeline; a round's
    # steps are the union of its models' windows
    assert meta["dispatches"] >= meta["rounds"] > 0
    for a, b in zip(sorted(streamed.history_, key=lambda r: (
            r["model_id"], r["partial_fit_calls"])),
            sorted(device.history_, key=lambda r: (
                r["model_id"], r["partial_fit_calls"]))):
        assert a["partial_fit_calls"] == b["partial_fit_calls"]
        assert a["score"] == pytest.approx(b["score"], abs=2.0 / N_TEST)


def test_regressor_cohort_matches_jax():
    X, y = _data("regression", seed=6)

    def search(ms, sgd):
        return ms.SuccessiveHalvingSearchCV(
            sgd.SGDRegressor(tol=1e-3, random_state=0),
            {"alpha": [1e-4, 1e-3, 1e-2], "eta0": [0.001, 0.005, 0.01]},
            n_initial_parameters=6, n_initial_iter=2, max_iter=8,
            random_state=0)

    ref = _jax(lambda: search(JMS, JSGD).fit(X, y))
    got = search(TMS, TSGD).fit(X, y)
    assert got.cv_results_["params"] == ref.cv_results_["params"]
    np.testing.assert_array_equal(got.cv_results_["partial_fit_calls"],
                                  ref.cv_results_["partial_fit_calls"])
    np.testing.assert_allclose(got.cv_results_["test_score"],
                               ref.cv_results_["test_score"], atol=1e-5)
    assert got.best_params_ == ref.best_params_
    with config.set(search_stream=False):
        dev = search(TMS, TSGD).fit(X, y)
    np.testing.assert_allclose(got.cv_results_["test_score"],
                               dev.cv_results_["test_score"], atol=1e-6)


def _cohort(n_models=4, kind="binary"):
    cls = TSGD.SGDClassifier if kind == "binary" else TSGD.SGDRegressor
    settings = [dict(alpha=1e-4, eta0=0.05), dict(alpha=1e-3, eta0=0.1,
                                                 penalty="elasticnet"),
                dict(alpha=1e-2, eta0=0.02, learning_rate="constant"),
                dict(alpha=1e-5, eta0=0.3, fit_intercept=False)][:n_models]
    ms = [cls(**kw) for kw in settings]
    for m in ms:
        m._batch_prepare({"classes": np.array([0.0, 1.0])})
    return cls, ms


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_streamed_cohort_round_matches_partial_fit_loops(kind):
    """Heterogeneous windows: model i is active on its own steps of the
    round's timeline; each lands where its partial_fit loop over the
    same blocks does, and a model's row is untouched where it is not
    active."""
    X, y = _data(kind, seed=7, n=800)
    cls, ms = _cohort(kind=kind)
    _, solo = _cohort(kind=kind)
    block_rows = 100
    stream = BlockStream((X, np.asarray(ms[0]._encode_y(y), np.float32)),
                         block_rows=block_rows)
    # a warm first round so the models enter with their own clocks
    for m, s in zip(ms, solo):
        m.partial_fit(X[:block_rows], y[:block_rows])
        s.partial_fit(X[:block_rows], y[:block_rows])
    order = np.array([1, 2, 3, 4, 5, 6, 7, 0, 1, 2])
    act = np.zeros((len(order), len(ms)), np.float32)
    act[:, 0] = 1                      # every step
    act[2:5, 1] = 1                    # a middle window
    act[7:, 2] = 1                     # the tail, across the wrap
    # model 3 sits the round out
    before = [m._w.clone() for m in ms]
    info = cls._streamed_cohort_round(ms, stream, order, act, n_slots=6,
                                      warm=True)
    assert info["dispatches"] == len(order)
    assert info["warm_dispatches"] == 0 and info["streamed"]
    for i, (m, s) in enumerate(zip(ms, solo)):
        for step in np.flatnonzero(act[:, i]):
            lo = int(order[step]) * block_rows
            s.partial_fit(X[lo:lo + block_rows], y[lo:lo + block_rows])
        np.testing.assert_allclose(m._w.numpy(), s._w.numpy(), atol=1e-6)
        assert m._t == s._t
        np.testing.assert_allclose(m.coef_, s.coef_, atol=1e-6)
    assert torch.equal(ms[3]._w, before[3])
    assert ms[3]._t == 1


def test_inactive_rows_are_bit_identical():
    """A round where only model 0 trains leaves every other row of the
    stack bit for bit, whatever the kernel's rows carry."""
    X, y = _data(seed=8, n=400)
    cls, ms = _cohort()
    for m in ms:
        m.partial_fit(X[:100], y[:100])
    before = [m._w.clone() for m in ms]
    stream = BlockStream((X, np.asarray(ms[0]._encode_y(y), np.float32)),
                         block_rows=100)
    act = np.zeros((4, len(ms)), np.float32)
    act[:, 0] = 1
    cls._streamed_cohort_round(ms, stream, np.arange(4), act, n_slots=8)
    assert not torch.equal(ms[0]._w, before[0])
    for m, b in zip(ms[1:], before[1:]):
        assert torch.equal(m._w, b)
    holdout = cls._cohort_holdout(X[:150], y[:150], ms[0])
    scores = cls._cohort_holdout_scores(ms, holdout, n_slots=8)
    assert scores.shape == (len(ms),)
    np.testing.assert_allclose(scores, [m.score(X[:150], y[:150])
                                        for m in ms], atol=1e-6)


class _HostSGD:
    """A model of another package: host numpy partial_fit (least
    squares steps) and score; the controller trains it on host blocks in
    threads."""

    def __init__(self, lr=0.1):
        self.lr = lr

    def get_params(self, deep=True):
        return {"lr": self.lr}

    def set_params(self, **params):
        self.lr = params.get("lr", self.lr)
        return self

    def partial_fit(self, X, y, **kw):
        X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
        w = getattr(self, "w_", np.zeros(X.shape[1]))
        self.w_ = w - self.lr * X.T @ (X @ w - y) / len(y)
        return self

    def score(self, X, y):
        r = np.asarray(y) - np.asarray(X) @ self.w_
        return -float(np.mean(r ** 2))


def test_host_models_and_device_data_match_jax():
    X, y = _data("regression", seed=9, n=1200)

    def search(ms):
        return ms.IncrementalSearchCV(_HostSGD(), {"lr": [0.01, 0.05, 0.1]},
                                      n_initial_parameters=3, max_iter=4,
                                      random_state=0)

    ref = _jax(lambda: search(JMS).fit(X, y))
    got = search(TMS).fit(X, y)
    assert not got.metadata_["stream"]["streamed"]
    np.testing.assert_allclose(got.cv_results_["test_score"],
                               ref.cv_results_["test_score"], rtol=1e-10)
    # a device-resident X keeps its split on the device: one block
    Xd, yd = _data(seed=10, n=1200)
    dev = TMS.IncrementalSearchCV(
        TSGD.SGDClassifier(random_state=0), PARAMS, n_initial_parameters=4,
        max_iter=3, random_state=0).fit(ShardedArray.from_array(Xd),
                                        ShardedArray.from_array(yd),
                                        classes=[0.0, 1.0])
    assert not dev.metadata_["stream"]["streamed"]
    assert dev.cv_results_["partial_fit_calls"].max() == 3
    # disable_process_distribution: a search on this process alone, even
    # as a rank of a world of two (the thread-local switch of the JAX
    # package): every candidate trained here, the same results
    from dask_ml_tpu_torch.parallel import distributed as dist

    def alone(rank):
        with _incremental.disable_process_distribution():
            assert _incremental._dist_is_disabled()
            assert dist.process_count() == 1
            s = TMS.IncrementalSearchCV(
                TSGD.SGDClassifier(random_state=0), PARAMS,
                n_initial_parameters=4, max_iter=3,
                random_state=0).fit(Xd, yd, classes=[0.0, 1.0])
        assert not _incremental._dist_is_disabled()
        assert dist.process_count() == 2
        assert {r["owner"] for r in s.history_} == {0}
        return np.asarray(s.cv_results_["test_score"])

    solo = TMS.IncrementalSearchCV(
        TSGD.SGDClassifier(random_state=0), PARAMS, n_initial_parameters=4,
        max_iter=3, random_state=0).fit(Xd, yd, classes=[0.0, 1.0])
    for scores in dist.run_virtual_processes(alone, world=2, timeout=300):
        np.testing.assert_array_equal(scores, solo.cv_results_["test_score"])
