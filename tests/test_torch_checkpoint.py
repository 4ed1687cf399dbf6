"""Checkpoints of the port on the CPU: the atomic writer, and
kill-and-resume of every checkpointed fit.

A streamed fit is killed by an injected crash at the yield of a block
(``superblock_dispatch:crash@N``, N counting blocks) mid-fit, with
``config.stream_checkpoint_path`` set, and rerun alike: the rerun
resumes at the last saved pass and ends **bit-equal** to an
uninterrupted, uncheckpointed fit, with the same iteration and pass
counts, one ``stream_resumes``, and no checkpoint left behind. A
resident fit (lbfgs in chunks, KMeans) is killed after its second save
(``utils.checkpoint.save_pytree`` patched to raise), a search after a
round (``SearchCheckpoint.save_round`` patched alike), an Incremental
pass loop by dropping its wrapper. The port's kernels run their plain
versions here, which are deterministic, so any difference would be state
a checkpoint failed to carry.
"""

import os

import numpy as np
import pytest
import torch

import dask_ml_tpu_torch.linear_model as T
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.model_selection import (HyperbandSearchCV,
                                               IncrementalSearchCV)
from dask_ml_tpu_torch.observability import counters_reset, counters_snapshot
from dask_ml_tpu_torch.reliability import InjectedCrash, reset_plans
from dask_ml_tpu_torch.utils import checkpoint as ckpt
from dask_ml_tpu_torch.wrappers import Incremental

BLOCK = 700


@pytest.fixture(autouse=True)
def _clean():
    reset_plans()
    counters_reset()
    with config.set(device="cpu"):
        yield
    reset_plans()
    counters_reset()


def _xy(n=3000, d=8, seed=0, n_classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, max(n_classes, 2)) / np.sqrt(d)
    y = np.argmax(X @ W + 0.5 * rng.randn(n, W.shape[1]), 1)
    if n_classes == 2:
        y = (X @ W[:, 0] + 0.5 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


class _Killed(Exception):
    pass


def _kill_and_resume(make, crash_at, tmp, **cfg):
    """(control, checkpointed, resumed) fits of ``make``: no checkpoint;
    a checkpoint and no kill; killed at block ``crash_at`` and rerun."""
    with config.set(**cfg):
        control = make()
    with config.set(stream_checkpoint_path=tmp, **cfg):
        checkpointed = make()
    assert os.listdir(tmp) == []            # completion cleared it
    counters_reset()
    reset_plans()
    with config.set(stream_checkpoint_path=tmp,
                    fault_plan=f"superblock_dispatch:crash@{crash_at}", **cfg):
        with pytest.raises(InjectedCrash):
            make()
    assert os.listdir(tmp) != []
    saves = counters_snapshot()["stream_checkpoint_saves"]
    reset_plans()
    with config.set(stream_checkpoint_path=tmp, **cfg):
        resumed = make()
    snap = counters_snapshot()
    assert saves >= 1 and snap["stream_resumes"] == 1
    assert os.listdir(tmp) == []
    return control, checkpointed, resumed


def _same(a, b, attrs):
    for attr in attrs:
        np.testing.assert_array_equal(np.asarray(getattr(a, attr)),
                                      np.asarray(getattr(b, attr)), attr)


GLM_CASES = {
    "lbfgs": dict(solver="lbfgs", max_iter=12, tol=0.0),
    "gradient_descent": dict(solver="gradient_descent", max_iter=10,
                             tol=0.0),
    "proximal_grad": dict(solver="proximal_grad", penalty="l1", C=0.1,
                          max_iter=10, tol=0.0),
    "newton": dict(solver="newton", max_iter=6, tol=0.0),
    "admm": dict(solver="admm", max_iter=8, tol=0.0),
}


@pytest.mark.parametrize("solver", sorted(GLM_CASES))
def test_streamed_glm_kill_and_resume(tmp_path, solver):
    X, y = _xy()

    def make():
        return T.LogisticRegression(**GLM_CASES[solver]).fit(X, y)

    with config.set(stream_block_rows=BLOCK):
        passes = make().solver_info_["data_passes"]
    n_blocks = -(-len(X) // BLOCK)
    ctl, chk, res = _kill_and_resume(make, passes // 2 * n_blocks + 2,
                                     str(tmp_path), stream_block_rows=BLOCK)
    for est in (chk, res):
        _same(est, ctl, ("coef_", "intercept_", "n_iter_"))
        assert est.solver_info_["data_passes"] == passes
    # the resumed fit ran only the passes after its checkpoint
    assert res.stream_stats_["passes"] < passes


def test_streamed_ovr_lbfgs_kill_and_resume(tmp_path):
    X, y = _xy(n_classes=3)

    def make():
        return T.LogisticRegression(solver="lbfgs", max_iter=10,
                                    tol=0.0).fit(X, y)

    ctl, chk, res = _kill_and_resume(make, 27, str(tmp_path),
                                     stream_block_rows=BLOCK)
    assert ctl.coef_.shape == (3, 8)
    for est in (chk, res):
        _same(est, ctl, ("coef_", "intercept_", "n_iter_"))


def test_streamed_sgd_shuffled_kill_and_resume(tmp_path):
    X, y = _xy()

    def make():
        return T.SGDClassifier(max_iter=4, shuffle=True,
                               random_state=0).fit(X, y)

    # 12 blocks of 256 rows an epoch: killed in epoch 3
    ctl, chk, res = _kill_and_resume(make, 12 * 2 + 5, str(tmp_path),
                                     stream_block_rows=256)
    for est in (chk, res):
        _same(est, ctl, ("coef_", "intercept_", "_t"))
    assert res.stream_stats_["passes"] == 2


def test_wrong_fingerprint_checkpoint_ignored(tmp_path):
    X, y = _xy()
    with config.set(stream_block_rows=256, stream_checkpoint_path=str(
            tmp_path), fault_plan="superblock_dispatch:crash@30"):
        with pytest.raises(InjectedCrash):
            T.SGDClassifier(max_iter=4, random_state=0).fit(X, y)
    assert os.path.isdir(tmp_path / "sgd")
    reset_plans()
    counters_reset()
    with config.set(stream_block_rows=256):
        ref = T.SGDClassifier(max_iter=4, random_state=0).fit(X + 1.0, y)
    with config.set(stream_block_rows=256,
                    stream_checkpoint_path=str(tmp_path)):
        # other data content: another fingerprint, a fresh fit
        got = T.SGDClassifier(max_iter=4, random_state=0).fit(X + 1.0, y)
    assert counters_snapshot().get("stream_resumes", 0) == 0
    _same(got, ref, ("coef_", "intercept_"))


@pytest.mark.parametrize("where", ["config", "estimator"])
def test_streamed_kmeans_kill_and_resume(tmp_path, where):
    """Killed in a Lloyd pass: the rerun skips k-means|| and the passes
    done, and ends bit-equal."""
    X, _ = _xy(n=4000, d=5)
    X[:2000] += 4.0

    def make(path=None):
        kw = {} if path is None else dict(checkpoint_path=path,
                                          checkpoint_every=1)
        return KMeans(n_clusters=4, random_state=0, max_iter=6, tol=0.0,
                      **kw).fit(X)

    with config.set(stream_block_rows=BLOCK):
        ctl = make()
    n_blocks = -(-len(X) // BLOCK)
    total = ctl.stream_stats_["passes"]
    # the moments pass, the init, then Lloyd: killed in Lloyd pass 3
    crash_at = (total - 1 - ctl.n_iter_ + 2) * n_blocks + 1
    if where == "config":
        ctl, chk, res = _kill_and_resume(make, crash_at, str(tmp_path),
                                         stream_block_rows=BLOCK)
    else:
        path = str(tmp_path / "km")
        with config.set(stream_block_rows=BLOCK,
                        fault_plan=f"superblock_dispatch:crash@{crash_at}"):
            with pytest.raises(InjectedCrash):
                make(path)
        assert os.path.isdir(path)
        reset_plans()
        with config.set(stream_block_rows=BLOCK):
            res = chk = make(path)
        assert not os.path.exists(path)
    for est in (chk, res):
        _same(est, ctl, ("cluster_centers_", "inertia_", "n_iter_",
                         "labels_"))
    assert res.stream_stats_["passes"] == 1 + (ctl.n_iter_ - 2) + 1


def _dying_saves(monkeypatch, after):
    real = ckpt.save_pytree
    n = {"saves": 0}

    def dying(path, tree):
        real(path, tree)
        n["saves"] += 1
        if n["saves"] == after:
            raise _Killed("killed after a save")

    monkeypatch.setattr(ckpt, "save_pytree", dying)
    return real


def test_resident_kmeans_kill_and_resume(tmp_path, monkeypatch):
    X, _ = _xy(n=2000, d=5)
    X[:1000] += 3.0
    path = str(tmp_path / "km")

    def make(**kw):
        return KMeans(n_clusters=3, random_state=1, max_iter=9, tol=0.0,
                      **kw).fit(X)

    ctl = make()
    chk = make(checkpoint_path=path, checkpoint_every=2)
    real = _dying_saves(monkeypatch, 2)
    with pytest.raises(_Killed):
        make(checkpoint_path=path, checkpoint_every=2)
    monkeypatch.setattr(ckpt, "save_pytree", real)
    res = make(checkpoint_path=path, checkpoint_every=2)
    assert counters_snapshot()["stream_resumes"] == 1
    for est in (chk, res):
        _same(est, ctl, ("cluster_centers_", "inertia_", "n_iter_"))
        np.testing.assert_array_equal(est.labels_.to_numpy(),
                                      ctl.labels_.to_numpy())
    assert not os.path.exists(path)


@pytest.mark.parametrize("classes", [2, 3])
def test_resident_lbfgs_chunks_kill_and_resume(tmp_path, monkeypatch,
                                               classes):
    """lbfgs in chunks of 10 iterations, killed after its second save:
    the rerun resumes at iteration 20 and ends bit-equal. Three classes
    take the per-class loop, one checkpoint per class."""
    X, y = _xy(n=1500, n_classes=classes)
    path = str(tmp_path / "solver")
    base = dict(solver="lbfgs", max_iter=40, tol=0.0)
    kw = dict(base, solver_kwargs={"checkpoint_path": path,
                                   "checkpoint_every": 10})
    # the per-class loop without chunks is the three-class control
    ctl = T.LogisticRegression(**(base if classes == 2 else dict(
        base, solver_kwargs={"checkpoint_path": path}))).fit(X, y)
    real = _dying_saves(monkeypatch, 2)
    with pytest.raises(_Killed):
        T.LogisticRegression(**kw).fit(X, y)
    monkeypatch.setattr(ckpt, "save_pytree", real)
    assert ckpt.checkpoint_exists(path if classes == 2
                                  else os.path.join(path, "class0"))
    res = T.LogisticRegression(**kw).fit(X, y)
    _same(res, ctl, ("coef_", "intercept_", "n_iter_"))
    assert not os.path.exists(path)
    if classes == 2:
        assert res.solver_info_["resumed_from"] == 20
        again = T.LogisticRegression(**kw).fit(X, y)
        assert again.solver_info_["resumed_from"] == 0
        _same(again, ctl, ("coef_", "intercept_"))
        # a state of another shape is another solve's: a fresh start
        ckpt.save_pytree(path, {"beta": np.zeros(3, np.float32)})
        other = T.LogisticRegression(**kw).fit(X, y)
        assert other.solver_info_["resumed_from"] == 0
        _same(other, ctl, ("coef_",))


def test_incremental_pass_kill_and_resume(tmp_path):
    X, y = _xy(n=2000)

    def make():
        return Incremental(T.SGDClassifier(random_state=0),
                           shuffle_blocks=True, random_state=0)

    ctl = make()
    for _ in range(5):
        ctl.partial_fit(X, y, classes=[0.0, 1.0])
    with config.set(stream_checkpoint_path=str(tmp_path)):
        a = make()
        for _ in range(3):
            a.partial_fit(X, y, classes=[0.0, 1.0])
        assert a.completed_passes_ == 3
        # "killed": a fresh wrapper restores the last pass's state
        assert make().resume_from_checkpoint(
            X, y, classes=[0.0, 1.0]) == 3
        counters_reset()
        b = make()
        b.partial_fit(X, y, classes=[0.0, 1.0])
        assert b.completed_passes_ == 4
        assert counters_snapshot()["stream_resumes"] == 1
        b.partial_fit(X, y, classes=[0.0, 1.0])
        b._clear_pass_checkpoint()
        assert os.listdir(tmp_path) == []
        # fit() is one fresh pass: it clears, never resumes
        make().partial_fit(X, y, classes=[0.0, 1.0])
        assert os.listdir(tmp_path) != []
        f = make().fit(X, y)
        assert not hasattr(f, "completed_passes_")
    _same(b.estimator_, ctl.estimator_, ("coef_", "intercept_", "_t"))
    assert b.training_profile_ is not None


# ---------------------------------------------------------------------------
# adaptive searches
# ---------------------------------------------------------------------------

def _search(kind, random_state=0, max_iter=9):
    params = {"alpha": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
              "eta0": [0.01, 0.1], "learning_rate": ["constant"]}
    est = T.SGDClassifier(random_state=0)
    if kind == "hyperband":
        return HyperbandSearchCV(est, params, max_iter=max_iter,
                                 random_state=random_state)
    return IncrementalSearchCV(est, params, n_initial_parameters=6,
                               max_iter=max_iter, random_state=random_state)


_KEYS = ("model_id", "params", "partial_fit_calls", "score")


def _same_search(a, b):
    assert [{k: r[k] for k in _KEYS} for r in a.history_] == \
        [{k: r[k] for k in _KEYS} for r in b.history_]
    for key in ("test_score", "partial_fit_calls", "rank_test_score"):
        np.testing.assert_array_equal(a.cv_results_[key],
                                      b.cv_results_[key])
    assert a.best_params_ == b.best_params_
    _same(a.best_estimator_, b.best_estimator_, ("coef_", "intercept_"))


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("kind", ["hyperband", "incremental"])
def test_search_kill_and_resume(tmp_path, monkeypatch, kind, stream):
    X, y = _xy(n=2000, d=6)
    d = str(tmp_path / "ck")
    with config.set(search_stream=stream):
        ctl = _search(kind).fit(X, y, classes=[0.0, 1.0])
        real = ckpt.SearchCheckpoint.save_round
        n = {"rounds": 0}

        def dying(self, *args, **kw):
            real(self, *args, **kw)
            n["rounds"] += 1
            if n["rounds"] == 2:
                raise _Killed("killed after round 2")

        monkeypatch.setattr(ckpt.SearchCheckpoint, "save_round", dying)
        with config.set(checkpoint_dir=d):
            with pytest.raises(_Killed):
                _search(kind).fit(X, y, classes=[0.0, 1.0])
            (sub,) = os.listdir(d)
            saved = ckpt.SearchCheckpoint(os.path.join(d, sub)).load()
            assert saved["round"] == 2
            monkeypatch.setattr(ckpt.SearchCheckpoint, "save_round", real)
            res = _search(kind).fit(X, y, classes=[0.0, 1.0])
        assert os.listdir(d) == []
    _same_search(res, ctl)
    assert ctl.metadata_["stream"]["streamed"] == stream


def test_search_checkpoint_isolation_and_no_seed(tmp_path, monkeypatch):
    """A search with random_state=None writes nothing; two searches under
    one directory keep apart: a second one neither resumes nor clears
    the first's state."""
    X, y = _xy(n=1500, d=6)
    d = str(tmp_path / "ck")
    with config.set(checkpoint_dir=d):
        _search("incremental", random_state=None).fit(X, y, classes=[0.0, 1.0])
    assert not os.path.exists(d) or os.listdir(d) == []
    ctl = _search("incremental").fit(X, y, classes=[0.0, 1.0])
    real = ckpt.SearchCheckpoint.save_round

    def dying(self, *args, **kw):
        real(self, *args, **kw)
        raise _Killed("killed after round 1")

    monkeypatch.setattr(ckpt.SearchCheckpoint, "save_round", dying)
    with config.set(checkpoint_dir=d):
        with pytest.raises(_Killed):
            _search("incremental").fit(X, y, classes=[0.0, 1.0])
        monkeypatch.setattr(ckpt.SearchCheckpoint, "save_round", real)
        (first,) = os.listdir(d)
        other = _search("incremental", max_iter=4).fit(
            X, y, classes=[0.0, 1.0])
        assert os.listdir(d) == [first]
        assert int(other.cv_results_["partial_fit_calls"].max()) <= 4
        res = _search("incremental").fit(X, y, classes=[0.0, 1.0])
    assert os.listdir(d) == []
    _same_search(res, ctl)


# ---------------------------------------------------------------------------
# the atomic writer (dask_ml_tpu's TestAtomicCheckpoint)
# ---------------------------------------------------------------------------

def test_kill_mid_save_keeps_previous_state(tmp_path):
    p = str(tmp_path / "state")
    ckpt.save_pytree(p, {"x": np.arange(4.0), "it": 3})
    # a killed save leaves a partial temp sibling; the live slot stands
    os.makedirs(p + ".tmp", exist_ok=True)
    with open(os.path.join(p + ".tmp", "junk"), "w") as f:
        f.write("partial garbage")
    st = ckpt.restore_pytree(p)
    np.testing.assert_array_equal(st["x"], np.arange(4.0))
    assert int(st["it"]) == 3
    ckpt.save_pytree(p, {"x": np.arange(5.0)})
    assert ckpt.restore_pytree(p)["x"].size == 5
    assert sorted(os.listdir(tmp_path)) == ["state"]


def test_crash_window_between_renames_restores_old(tmp_path):
    p = str(tmp_path / "state")
    ckpt.save_pytree(p, {"x": np.arange(3.0)})
    os.rename(p, p + ".old")      # killed between retire and publish
    assert ckpt.checkpoint_exists(p)
    np.testing.assert_array_equal(ckpt.restore_pytree(p)["x"],
                                  np.arange(3.0))


def test_repeated_crash_keeps_old_until_publish(tmp_path, monkeypatch):
    p = str(tmp_path / "state")
    ckpt.save_pytree(p, {"x": np.arange(2.0)})
    os.rename(p, p + ".old")      # crash 1: retired, never published
    real_rename = os.rename

    def killed_publish(src, dst):
        if dst == p:
            raise _Killed("kill mid-publish")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", killed_publish)
    with pytest.raises(_Killed):
        ckpt.save_pytree(p, {"x": np.arange(9.0)})
    monkeypatch.undo()
    assert ckpt.checkpoint_exists(p)
    np.testing.assert_array_equal(ckpt.restore_pytree(p)["x"],
                                  np.arange(2.0))


def test_save_host_atomic_and_tensors(tmp_path):
    p = str(tmp_path / "h.pkl")
    ckpt.save_host(p, {"v": 1, "w": torch.arange(3.0),
                       "b": torch.ones(2, dtype=torch.bfloat16)})

    class Boom:
        def __reduce__(self):
            raise _Killed("kill mid-write")

    with pytest.raises(_Killed):
        ckpt.save_host(p, Boom())
    got = ckpt.restore_host(p)
    assert got["v"] == 1 and got["b"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.arange(3.0))
    assert not any(f.startswith("h.pkl.tmp") for f in os.listdir(tmp_path))


def test_foreign_and_corrupt_checkpoints_start_fresh(tmp_path):
    """A directory of another package (an orbax checkpoint of
    dask_ml_tpu) or a corrupt state restores as None; a state saved from
    tensors restores as host numpy, whatever device saved it."""
    foreign = tmp_path / "orbax"
    foreign.mkdir()
    (foreign / "_CHECKPOINT_METADATA").write_text("{}")
    assert ckpt.restore_pytree(str(foreign)) is None
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / ckpt.STATE_FILE).write_bytes(b"not an npz")
    assert ckpt.restore_pytree(str(bad)) is None
    p = str(tmp_path / "t")
    ckpt.save_pytree(p, {"w": torch.arange(4.0), "t": 7})
    st = ckpt.restore_pytree(p)
    assert isinstance(st["w"], np.ndarray) and int(st["t"]) == 7
    from dask_ml_tpu_torch.reliability.stream_ckpt import StreamCheckpoint

    assert StreamCheckpoint(str(foreign), "a" * 40).restore() is None
    assert StreamCheckpoint(p, "a" * 40).restore() is None   # no token
