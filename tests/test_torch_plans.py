"""The port's plans (``dask_ml_tpu_torch/plans``) against dask_ml_tpu's,
on the CPU: every ladder's rungs, ``bucket_for`` and padding equal to
the JAX package's for the same arguments (host math, exactly); the plan
build cache, the warmup registry and the plans table driven alike in
both packages give the same rows; a graph set counts one capture per new
key and swaps its static parameters in place; the sparse staging plan's
nnz rung is the plans' NnzLadder."""

import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu import plans as JP
from dask_ml_tpu.serving import BucketLadder as JBucketLadder
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch import plans as TP
from dask_ml_tpu_torch.parallel import sparse_stream
from dask_ml_tpu_torch.serving import BucketLadder


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


GEOMETRIC = [(8, 1024, 2.0), (8, 512, 2.0), (1, 1, 2.0), (1, 100, 1.5),
             (3, 1000, 3.7), (8, 9, 1.01), (16, 4096, 4.0)]


@pytest.mark.parametrize("args", GEOMETRIC, ids=str)
def test_geometric_ladder_matches_jax(args):
    t, j = TP.GeometricLadder(*args), JP.GeometricLadder(*args)
    assert t.buckets == j.buckets and len(t) == len(j)
    assert t.max_rows == j.max_rows and t.describe() == j.describe()
    for n in range(1, t.max_rows + 1):
        assert t.bucket_for(n) == j.bucket_for(n)
        assert t.padding_for(n) == j.padding_for(n)
    with pytest.raises(ValueError):
        t.rung_for(t.max_rows + 1)
    b = BucketLadder(*args)
    assert b.buckets == JBucketLadder(*args).buckets
    assert repr(b) == repr(JBucketLadder(*args))


@pytest.mark.parametrize("args", [(0, 8, 2.0), (9, 8, 2.0), (1, 8, 1.0)],
                         ids=str)
def test_geometric_ladder_refusals_match_jax(args):
    with pytest.raises(ValueError):
        JP.GeometricLadder(*args)
    with pytest.raises(ValueError):
        TP.GeometricLadder(*args)


def test_bucket_ladder_from_config_matches_jax():
    kw = dict(serving_min_batch=4, serving_max_batch=300,
              serving_bucket_growth=1.7)
    with config.set(**kw), jconfig.set(**kw):
        assert BucketLadder.from_config().buckets == \
            JBucketLadder.from_config().buckets


@pytest.mark.parametrize("min_nnz,growth", [(128, 2.0), (1, 1.5),
                                            (100, 3.0), (7, 1.1)])
def test_nnz_ladder_matches_jax(min_nnz, growth):
    t, j = TP.NnzLadder(min_nnz, growth), JP.NnzLadder(min_nnz, growth)
    assert repr(t) == repr(j) and t.describe() == j.describe()
    for nnz in [0, 1, 5, 127, 128, 129, 1000, 4097, 65536, 100_003]:
        for top in [0, 1, 200, 5000, 1 << 20]:
            assert t.rung_for(nnz, top=top) == j.rung_for(nnz, top=top)
        assert t.rungs_to(nnz) == j.rungs_to(nnz)


def test_sparse_stream_rung_is_the_nnz_ladder():
    ladder = JP.NnzLadder(min_nnz=128, growth=2.0)
    for nnz in [0, 1, 128, 129, 3000, 1 << 18]:
        for top in [0, 256, 1 << 12]:
            assert sparse_stream._nnz_rung(nnz, top) == \
                ladder.rung_for(nnz, top=top)


def test_slot_rung_ladder_matches_jax():
    t, j = TP.SlotRungLadder(), JP.SlotRungLadder()
    assert repr(t) == repr(j) and t.describe() == j.describe()
    for n_slots in range(0, 70):
        assert t.rungs_for(n_slots) == j.rungs_for(n_slots)
        for n_active in range(0, n_slots + 2):
            assert t.rung_for(n_active, n_slots) == \
                j.rung_for(n_active, n_slots)


def test_padding_and_masks_match_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(5, 3).astype(np.float32)
    for rung in (5, 8):
        np.testing.assert_array_equal(TP.ShapeLadder.pad_rows(X, rung),
                                      JP.ShapeLadder.pad_rows(X, rung))
        np.testing.assert_array_equal(TP.ShapeLadder.row_mask(5, rung),
                                      JP.ShapeLadder.row_mask(5, rung))
    with pytest.raises(ValueError):
        TP.ShapeLadder.pad_rows(X, 4)
    d, c, r = rng.rand(6), np.arange(6), np.arange(6) // 2
    for a, b in zip(TP.NnzLadder.pad_triple(d, c, r, 16),
                    JP.NnzLadder.pad_triple(d, c, r, 16)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        TP.NnzLadder.pad_triple(d, c, r, 4)


def _body(p, a):
    return a + p["w"]


def test_plan_cache_hit_miss_and_off():
    obs.counters_reset()
    p1 = TP.ProgramPlan(name="t.plan.hit", body=_body, key=("k", 1)).build()
    p2 = TP.ProgramPlan(name="t.plan.hit", body=_body, key=("k", 1)).build()
    assert p1 is p2
    base = dict(name="t.plan.miss", body=_body)
    p = TP.ProgramPlan(key=("m", 8), **base).build()
    assert TP.ProgramPlan(key=("m", 16), **base).build() is not p
    assert TP.ProgramPlan(key=("m", 8), donate=(0,), **base).build() \
        is not p
    assert TP.ProgramPlan(name="t.plan.miss2", body=_body,
                          key=("m", 8)).build() is not p
    with config.set(plan_cache=False):
        assert TP.ProgramPlan(name="t.plan.hit", body=_body,
                              key=("k", 1)).build() is not p1
    snap = obs.counters_snapshot()
    assert snap["plan_builds"] == 6 and snap["plan_cache_hits"] == 1


def test_build_cache_cap(monkeypatch):
    from dask_ml_tpu_torch.plans import plan as tplan

    monkeypatch.setattr(tplan, "_BUILD_CACHE_MAX", 3)
    first = TP.ProgramPlan(name="t.cap", body=_body, key=0).build()
    for k in range(1, 5):
        TP.ProgramPlan(name="t.cap", body=_body, key=k).build()
    assert len(tplan._BUILD_CACHE) <= 3
    assert TP.ProgramPlan(name="t.cap", body=_body, key=0).build() \
        is not first


@pytest.fixture
def fresh_plans(monkeypatch):
    """Both packages' process-wide plan state (attribution, build cache,
    warmup registry) replaced for the test and restored after it, so no
    later test in the process sees what this one did."""
    import dask_ml_tpu.plans.plan as jplan
    import dask_ml_tpu.plans.warmup as jwarm
    import dask_ml_tpu_torch.plans.plan as tplan
    import dask_ml_tpu_torch.plans.warmup as twarm

    for P, plan, warm in ((TP, tplan, twarm), (JP, jplan, jwarm)):
        reg = warm.WarmupRegistry()
        monkeypatch.setattr(plan, "_ATTR", {})
        monkeypatch.setattr(plan, "_BUILD_CACHE", {})
        monkeypatch.setattr(warm, "warmups", reg)
        monkeypatch.setattr(P, "warmups", reg)


def _drive_warmups(P, cfg):
    """One sequence of warm requests; returns the registry's rows for
    the programs it touched and the thunk calls made."""
    calls = []
    for key, rung in [(("a", 8), 8), (("a", 16), 16), (("a", 8), 8),
                      (("b", 8), 8)]:
        P.warmups.warm(key, lambda: calls.append(1), program=f"p.{key[0]}",
                       ladder="rows", rung=rung)
    P.warmups.note(("c", 4), program="p.c", ladder="nnz", rung=4)
    with cfg.set(plan_rewarm=True):
        P.warmups.warm(("a", 8), lambda: calls.append(1))
    return P.warmups.snapshot(), P.warmups.stats_by_program(), len(calls)


def test_warmup_registry_matches_jax(fresh_plans):
    t = _drive_warmups(TP, config)
    j = _drive_warmups(JP, jconfig)
    assert t == j
    assert t[2] == 4 and t[1]["p.a"] == {"warmups": 2, "hits": 1}


def test_plans_snapshot_matches_jax(fresh_plans):
    for P in (TP, JP):
        P.register_attr("p.x", group="serving", ladder="serving-rows")
        P.warmups.warm(("x", 8), lambda: None, program="p.x",
                       ladder="serving-rows", rung=8)
        P.warmups.warm(("x", 8), lambda: None, program="p.x")
        P.note_rung("p.x", 32)
    rows_t, rows_j = TP.plans_snapshot(), JP.plans_snapshot()
    assert rows_t == rows_j and rows_t[0]["rungs"] == "8,32"
    fn = TP.tracked("p.tracked", lambda: None, ladder="slots")
    assert fn.plan_name == "p.tracked" and fn.plan_token > 0


def test_graph_set_counts_captures_and_swaps_in_place():
    prog = TP.ProgramPlan(name="t.graphs", body=_body, key="g").build()
    w = np.array([1.0, 2.0], np.float32)
    gs = prog.graphs({"w": w}, "cpu", state="v1")
    assert gs.stream is None and not gs.cuda
    c0 = obs.counters_snapshot().get("graph_captures", 0)
    x = np.ones((4, 2), np.float32)
    out, state = gs.run((x,))
    np.testing.assert_array_equal(out, x + w)
    assert state == "v1"
    gs.run((x * 2,))
    gs.run((np.ones((8, 2)),))          # float64 in: float32, a new key
    assert obs.counters_snapshot()["graph_captures"] - c0 == 2
    assert len(gs.keys()) == 2
    gs.swap({"w": np.array([5.0, 6.0], np.float32)}, "v2")
    out, state = gs.run((x,))
    np.testing.assert_array_equal(out, x + [5.0, 6.0])
    assert state == "v2" and len(gs.keys()) == 2
    # the parameters were copied to the device, not aliased
    np.testing.assert_array_equal(w, [1.0, 2.0])
    assert isinstance(gs.params["w"], torch.Tensor)
