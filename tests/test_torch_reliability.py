"""The port's reliability plane on the CPU: fault plans, the data
fingerprint and the training profile against dask_ml_tpu's, and the
hardening of ``BlockStream`` (read retries, the non-finite block policy,
a crashed pass, block autotune).

Fault plans fire by invocation index: the same spec fires at the same
indexes in both packages (the hash-keyed probabilistic arms included).
The data fingerprint gives the same SHA-1 hex as dask_ml_tpu's for
ndarray, memmap and CSR inputs. ``FeatureSketch`` folds give the same
``to_dict()``; a streamed lbfgs fit's ``training_profile_`` has the same
counts and moments to 1e-12 (the two packages fold the same strided
rows). Quarantine is held to dask_ml_tpu's with NaN rows in the data
(not an injected fault: the two packages' sites count differently),
coefficients within the streamed tests' tolerances. dask_ml_tpu streams
on one device (``stream_mesh=1``) with fresh staging buffers
(``_PUT_ALIASES``), as tests/test_torch_stream_glm.py does.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu import reliability as jrel
from dask_ml_tpu.observability import sketch as jsketch
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu.utils.validation import data_fingerprint as j_fingerprint

import dask_ml_tpu_torch.linear_model as T
from dask_ml_tpu_torch import config, reliability
from dask_ml_tpu_torch.observability import (counters_reset,
                                             counters_snapshot, sketch)
from dask_ml_tpu_torch.parallel.sharded import ShardedArray
from dask_ml_tpu_torch.parallel.streaming import BlockStream, streamed_map
from dask_ml_tpu_torch.reliability import (
    FaultInjected, FaultPlan, InjectedCrash, InjectedIOError, NonFiniteBlock,
    StreamIORetriesExhausted, fault_point, reset_plans)
from dask_ml_tpu_torch.utils.validation import data_fingerprint

BLOCK = 700
COEF_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)
    reset_plans()
    jrel.reset_plans()
    counters_reset()
    with config.set(device="cpu"):
        yield
    reset_plans()
    jrel.reset_plans()
    counters_reset()


def _xy(n=3000, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d) / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ beta)))).astype(
        np.float32)
    return X, y


def _memmap(tmp_path, X, name="X.f32"):
    path = os.path.join(str(tmp_path), name)
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    del mm
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)


def _rows(stream, order=None):
    """One pass's valid rows of every array, copied off the ring."""
    out = [[] for _ in stream.arrays]
    ns = []
    for blk in stream.blocks(order):
        ns.append(blk.n_rows)
        for i, a in enumerate(blk.arrays):
            out[i].append(a[: blk.n_rows].numpy().copy())
    return [np.concatenate(o) for o in out], ns


# ---------------------------------------------------------------------------
# fault plans against dask_ml_tpu's
# ---------------------------------------------------------------------------

SPECS = [
    "staging_read:io@7",
    "staging_read:io@3*4",
    "staging_read:crash@2+5",
    "staging_read:nan~0.1@seed3",
    "stream_put:io~0.5@7",
    "superblock_dispatch:crash~1.0",
    "staging_read:io@2;staging_read:nan@5*3;stream_put:hang@9/0.01",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_fires_like_jax(spec):
    """The same arms fire at the same invocation indexes over 1000
    invocations of every site, and the snapshots agree."""
    mine, ref = FaultPlan.parse(spec), jrel.FaultPlan.parse(spec)
    for site in sorted(reliability.FAULT_SITES):
        got = [(a.kind if a else None)
               for a in (mine.fire(site) for _ in range(1000))]
        want = [(a.kind if a else None)
                for a in (ref.fire(site) for _ in range(1000))]
        assert got == want, site
    assert mine.snapshot() == ref.snapshot()
    assert any(v["fired"] for v in mine.snapshot().values())


@pytest.mark.parametrize("spec", ["bogus_site:io@0", "staging_read:meteor@0",
                                  "just-nonsense", "staging_read:io~1.5"])
def test_bad_plans_raise_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jrel.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_sites_kinds_and_errors():
    assert reliability.FAULT_SITES == jrel.FAULT_SITES
    assert reliability.FAULT_KINDS == jrel.FAULT_KINDS
    assert issubclass(InjectedIOError, OSError)
    assert issubclass(InjectedIOError, FaultInjected)
    assert not issubclass(InjectedCrash, OSError)
    assert issubclass(StreamIORetriesExhausted, OSError)
    sentinel = object()
    assert fault_point("staging_read", sentinel) is sentinel
    with config.set(fault_plan="serving_execute:crash@0"):
        with pytest.raises(InjectedCrash):
            fault_point("serving_execute")


def test_nan_poisons_a_copy_like_jax():
    src = np.arange(24, dtype=np.float32).reshape(8, 3)
    with config.set(fault_plan="staging_read:nan@0"):
        out = fault_point("staging_read", src)
    with jconfig.set(fault_plan="staging_read:nan@0"):
        ref = jrel.fault_point("staging_read", src)
    assert out is not src and np.isfinite(src).all()
    np.testing.assert_array_equal(out, ref)
    assert np.isnan(out).any()


def test_status_block_and_counters():
    with config.set(fault_plan="staging_read:io@1"):
        for _ in range(3):
            try:
                fault_point("staging_read")
            except InjectedIOError:
                pass
        st = reliability.status_block()
    assert st["fault_plan"] == "staging_read:io@1"
    assert st["sites"] == {"staging_read": {"invocations": 3, "fired": 1}}
    assert st["counters"] == {"faults_injected": 1,
                              "faults_injected_staging_read": 1}
    with config.set(obs_counters=False):
        counters_reset()
        with config.set(fault_plan="staging_read:io@0"):
            reset_plans()
            with pytest.raises(InjectedIOError):
                fault_point("staging_read")
    assert counters_snapshot() == {}


# ---------------------------------------------------------------------------
# fingerprint and sketches against dask_ml_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ndarray", "float64", "memmap", "csr",
                                  "short", "labels"])
def test_data_fingerprint_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(1)
    X = rng.randn(5000, 7).astype(np.float32)
    a = {"ndarray": X, "float64": X.astype(np.float64),
         "memmap": _memmap(tmp_path, X) if kind == "memmap" else None,
         "csr": sp.random(5000, 40, density=0.05, format="csr",
                          random_state=2, dtype=np.float64),
         "short": X[:20], "labels": rng.randint(0, 3, 5000)}[kind]
    assert data_fingerprint(a) == j_fingerprint(a)
    if kind in ("ndarray", "short"):
        # a device tensor: one index_select, the same rows and bytes
        assert data_fingerprint(torch.from_numpy(a)) == j_fingerprint(a)
        assert data_fingerprint(ShardedArray(torch.from_numpy(a),
                                             len(a))) == j_fingerprint(a)
    b = np.array(a.toarray() if sp.issparse(a) else a)
    b[0] += 1    # a head row: always sampled
    assert data_fingerprint(b) != data_fingerprint(a)
    assert data_fingerprint(None) == "none"


def test_feature_sketch_matches_jax():
    rng = np.random.RandomState(3)
    blocks = [rng.randn(300, 5).astype(np.float32) * 10 ** rng.randint(-3, 4)
              for _ in range(4)]
    blocks[2][7, 1] = np.nan
    blocks[3][0, 4] = np.inf
    mine, ref = sketch.FeatureSketch(5), jsketch.FeatureSketch(5)
    for b in blocks:
        assert mine.fold(b) == ref.fold(b)
    assert mine.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(mine.quantile(0.5), ref.quantile(0.5))
    merged = sketch.merge_profiles(mine.to_dict(), mine.to_dict())
    assert merged == jsketch.merge_profiles(ref.to_dict(), ref.to_dict())
    assert sketch.profile_from_dict(merged).to_dict() == merged
    cat, jcat = sketch.CategoricalSketch(3), jsketch.CategoricalSketch(3)
    vals = rng.randint(0, 7, 500)
    cat.fold(vals)
    jcat.fold(vals)
    assert cat.to_dict() == jcat.to_dict() and cat.top() == jcat.top()


def _assert_profiles(mine, ref, moments_atol=1e-12):
    assert mine is not None and ref is not None
    for key in ("n_features", "bounds", "counts", "n", "nonfinite", "rows"):
        assert mine[key] == ref[key], key
    for key in ("mean", "m2", "min", "max"):
        np.testing.assert_allclose(np.asarray(mine[key], np.float64),
                                   np.asarray(ref[key], np.float64),
                                   rtol=moments_atol, atol=moments_atol)


@pytest.mark.parametrize("budget", [None, 2000])
def test_training_profile_matches_jax(monkeypatch, budget):
    """One streamed lbfgs fit in each package, the same block rows: the
    same strided rows fold (a small value budget makes the stride > 1)."""
    from dask_ml_tpu_torch.parallel import streaming

    if budget is not None:
        monkeypatch.setattr(streaming, "_PROFILE_VALUE_BUDGET", budget)
        monkeypatch.setattr(jstreaming, "_PROFILE_VALUE_BUDGET", budget)
    X, y = _xy()
    with config.set(stream_block_rows=BLOCK):
        t = T.LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1):
        j = J.LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    _assert_profiles(t.training_profile_, j.training_profile_)
    if budget is None:
        assert t.training_profile_["rows"] == len(X)
    else:
        assert t.training_profile_["rows"] < len(X) // 2
    with config.set(stream_block_rows=BLOCK, obs_drift=False):
        off = T.LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    assert off.training_profile_ is None
    np.testing.assert_array_equal(off.coef_, t.coef_)


@pytest.mark.parametrize("solver", ["lbfgs", "newton"])
def test_quarantine_matches_jax(tmp_path, solver):
    """NaN rows inside one block of a memmap: both packages drop that
    block and fit the rest alike."""
    X, y = _xy()
    X[1500:1510, 3] = np.nan     # block 2 of 700-row blocks
    mm = _memmap(tmp_path, X)
    tol = {"lbfgs": 1e-3, "newton": 1e-4}[solver]
    with config.set(stream_block_rows=BLOCK, stream_nonfinite="quarantine"):
        t = T.LogisticRegression(solver=solver, tol=tol).fit(mm, y)
    quarantined = counters_snapshot()["stream_quarantined_blocks"]
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1,
                     stream_nonfinite="quarantine"):
        j = J.LogisticRegression(solver=solver, tol=tol).fit(mm, y)
    assert quarantined == t.solver_info_["data_passes"]
    assert np.isfinite(t.coef_).all()
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)


def test_bad_nonfinite_value_raises():
    X, y = _xy(600)
    with config.set(stream_nonfinite="meteor"):
        with pytest.raises(ValueError, match="quarantine"):
            BlockStream((X, y), block_rows=128)


# ---------------------------------------------------------------------------
# BlockStream hardening
# ---------------------------------------------------------------------------

def test_nonfinite_policies_on_the_stream():
    X, y = _xy(1500)
    X[300:310, 2] = np.nan       # block 1 of 256-row blocks
    with config.set(stream_nonfinite="quarantine"):
        (Xs, ys), ns = _rows(BlockStream((X, y), block_rows=256))
    assert ns == [256, 0, 256, 256, 256, 220]
    np.testing.assert_array_equal(Xs, np.r_[X[:256], X[512:]])
    assert counters_snapshot()["stream_quarantined_blocks"] == 1
    with config.set(stream_nonfinite="raise"):
        with pytest.raises(NonFiniteBlock):
            _rows(BlockStream((X, y), block_rows=256))
    # a NaN past a block's valid rows is no fault: y is finite here, and
    # an inf in y is caught like one in X
    y2 = y.copy()
    y2[1400] = np.inf
    X[300:310, 2] = 0.0
    with config.set(stream_nonfinite="quarantine"):
        _, ns = _rows(BlockStream((X, y2), block_rows=256))
    assert ns == [256, 256, 256, 256, 256, 0]
    # an inference stream keeps its rows: quarantine raises there
    with config.set(stream_nonfinite="quarantine"):
        with pytest.raises(NonFiniteBlock):
            streamed_map(y2[:, None], 256, lambda blk: blk.arrays[0])


def test_sgd_quarantine_fit_survives():
    X, y = _xy(1500)
    X[300:310, 2] = np.nan
    with config.set(stream_block_rows=256, stream_nonfinite="quarantine"):
        clf = T.SGDClassifier(max_iter=2, random_state=0,
                              shuffle=False).fit(X, y)
    assert np.isfinite(clf.coef_).all()
    assert counters_snapshot()["stream_quarantined_blocks"] == 2
    # the clock still ticks on a dropped block
    assert clf._t == 2 * clf.solver_info_["n_blocks"]


@pytest.mark.parametrize("source", ["memmap", "ndarray"])
def test_io_fault_retried_bit_equal(tmp_path, source):
    """An injected io fault is retried: the reader route drops its reader
    for the positional copy, the copy route re-reads; the fit is
    bit-equal and one retry is counted."""
    X, y = _xy()
    Xs = _memmap(tmp_path, X) if source == "memmap" else X
    with config.set(stream_block_rows=BLOCK):
        clean = T.LogisticRegression(solver="lbfgs", max_iter=8).fit(Xs, y)
    # invocation 2: block 1's X (through the reader for the memmap)
    with config.set(stream_block_rows=BLOCK, fault_plan="staging_read:io@2"):
        faulted = T.LogisticRegression(solver="lbfgs", max_iter=8).fit(Xs, y)
    snap = counters_snapshot()
    assert snap["stream_retries"] == 1
    assert snap["faults_injected_staging_read"] == 1
    np.testing.assert_array_equal(faulted.coef_, clean.coef_)
    np.testing.assert_array_equal(faulted.intercept_, clean.intercept_)
    routes = faulted.stream_stats_["reader_passes"]
    if source == "memmap":
        # the failed reader is gone: every later pass copies
        assert routes["copy"] == faulted.stream_stats_["passes"] - 1
    else:
        assert routes == {"copy": faulted.stream_stats_["passes"]}


def test_retries_exhausted_and_crash():
    X, y = _xy(600)
    with config.set(stream_io_retries=2, fault_plan="staging_read:io@0*64"):
        with pytest.raises(StreamIORetriesExhausted, match="3 attempt"):
            _rows(BlockStream((X, y), block_rows=128))
    assert counters_snapshot()["stream_retries"] == 2
    counters_reset()
    with config.set(fault_plan="staging_read:crash@3"):
        with pytest.raises(InjectedCrash):
            _rows(BlockStream((X, y), block_rows=128))
    assert "stream_retries" not in counters_snapshot()
    with config.set(stream_io_retries=2, fault_plan="stream_put:io@1"):
        (Xs, _), ns = _rows(BlockStream((X, y), block_rows=128))
    assert counters_snapshot()["stream_retries"] == 1
    np.testing.assert_array_equal(Xs, X)


def test_nan_fault_poisons_the_staging_copy(tmp_path):
    """A nan arm writes into the staging slot; the memmap stays clean,
    and the policy sees the poisoned block."""
    X, y = _xy(1000)
    mm = _memmap(tmp_path, X)
    with config.set(fault_plan="staging_read:nan@2",
                    stream_nonfinite="quarantine"):
        _, ns = _rows(BlockStream((mm, y), block_rows=250))
    assert ns == [250, 0, 250, 250]    # invocation 2: block 1's X
    assert np.isfinite(np.asarray(mm)).all()


_CRASHED_PASS = """
import gc, os, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.parallel.streaming import BlockStream
from dask_ml_tpu_torch.reliability import InjectedCrash

def threads():
    return len(os.listdir("/proc/self/task"))

def maps(path):
    with open("/proc/self/maps") as f:
        return sum(line.rstrip().endswith(path) for line in f)

def rows(stream):
    return np.concatenate([b.arrays[0][:b.n_rows].numpy().copy()
                           for b in stream.blocks()])

X = np.random.RandomState(4).randn(3000, 6).astype(np.float32)
name = {path!r}
mm = np.memmap(name, dtype=np.float32, mode="w+", shape=X.shape)
mm[:] = X
mm.flush()
del mm
mm = np.memmap(name, dtype=np.float32, mode="r", shape=X.shape)
path = os.path.realpath(name)
torch.zeros(4).sum()
with config.set(device="cpu"):
    before, mapped = threads(), maps(path)
    stream = BlockStream((mm,), block_rows=200)
    rows(stream)
    assert maps(path) == mapped + 1
    if {fault!r} == "crash":
        with config.set(fault_plan="staging_read:crash@4"):
            stream = BlockStream((mm,), block_rows=200)
        try:
            rows(stream)
        except InjectedCrash:
            pass
        else:
            raise AssertionError("no crash")
    else:
        os.truncate(name, X.nbytes // 2)
        try:
            rows(stream)
        except IOError as e:
            assert "mid-stream" in str(e) or "rows of" in str(e), e
        else:
            raise AssertionError("no IOError")
    gc.collect()
    assert (threads(), maps(path)) == (before, mapped), (
        threads(), maps(path), before, mapped)
    assert stream._ring is None and stream._native is None
    if {fault!r} == "crash":
        np.testing.assert_array_equal(rows(stream), X)
        assert stream.stats["reader"] == "native"
print("ok")
"""


@pytest.mark.parametrize("fault", ["crash", "truncated"])
def test_crashed_pass_leaves_nothing_behind(tmp_path, fault):
    """A crash while the reader fills the ring (an injected crash after
    a reader read, or a file cut short under the reader) reaches the
    caller as its own error; the stream closes the reader's mapping and
    helper threads and drops its ring at once, and the next pass reads
    the file again. Counted in a fresh interpreter: the threads of a
    test process that ran JAX come and go on their own."""
    import subprocess
    import sys

    code = _CRASHED_PASS.format(
        root=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        path=str(tmp_path / "X.f32"), fault=fault)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok", out.stdout


def test_autotune_grows_at_most_twice(monkeypatch):
    """Staging that outlasts the consumer (the pass times monkeypatched)
    doubles the block after the first and the second pass, never below
    16 blocks; every pass still covers every row. Off, the partition
    stays."""
    orig = BlockStream.blocks

    def slow_staging(self, order=None):
        yield from orig(self, order)
        self.stats.update(host_s=1.0, put_s=0.0, consume_s=0.0)

    monkeypatch.setattr(BlockStream, "blocks", slow_staging)
    X, y = _xy(6400, d=4)
    s = BlockStream((X, y), block_rows=100)
    heights, rows = [], []
    for blk in s.epochs(5, autotune=True):
        heights.append(s.block_rows)
        rows.append(blk.n_rows)
    assert sorted(set(heights)) == [100, 200, 400]
    assert s.n_blocks == 16 and sum(rows) == 5 * 6400
    s = BlockStream((X, y), block_rows=320)          # 20 blocks: 10 < 16
    list(s.epochs(3, autotune=True))
    assert s.block_rows == 320
    s = BlockStream((X, y), block_rows=100)
    with config.set(stream_autotune=False):
        list(s.epochs(3))
    assert s.block_rows == 100 and s.n_blocks == 64
    s = BlockStream((X, y), block_rows=100)
    with config.set(stream_autotune=True):
        list(s.epochs(2))
    assert s.block_rows == 200
