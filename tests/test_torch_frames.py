"""The port's PartitionedFrame (``dask_ml_tpu_torch/parallel/frames.py``)
and its frame paths against dask_ml_tpu's, on the CPU.

The same pandas frame, cut into the same partitions, goes through both
packages: the round trip, ``map_partitions``, ``global_categories`` (a
category seen in one partition only), Categorizer, DummyEncoder and
OrdinalEncoder (frames equal), the scalers frame-in/frame-out (partition
boundaries and index kept; values within 1e-5 of dask_ml_tpu's, both in
float32), PolynomialFeatures, ColumnTransformer, ``to_sharded`` into a
fit, ParallelPostFit over partitions and the splits (equal frames). In
a virtual world of two ranks, ``global_categories`` unions every
rank's partitions and ``to_sharded`` gives a process-local array with
the global row count; StandardScaler's statistics merge over the ranks'
partitions. In one process ``to_sharded(shard_features=True)`` places
every column (no model axis). pandas stays unloaded on the port's
array paths (tests/test_torch_imports.py).
"""

import numpy as np
import pandas as pd
import pytest

import dask_ml_tpu.preprocessing as JP
from dask_ml_tpu.parallel import from_pandas as j_from_pandas
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import preprocessing as TP
from dask_ml_tpu_torch.parallel import PartitionedFrame, from_pandas
from dask_ml_tpu_torch.parallel import distributed as dist


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture()
def df():
    rng = np.random.RandomState(0)
    n = 200
    return pd.DataFrame({
        "a": rng.randn(n),
        "b": rng.randint(0, 5, n).astype(np.int64),
        "c": np.where(rng.rand(n) < 0.5, "x", "y"),
    })


def _frames_equal(got, ref, **kw):
    assert [len(p) for p in got.partitions] == \
        [len(p) for p in ref.partitions]
    pd.testing.assert_frame_equal(got.compute(), ref.compute(), **kw)


def test_round_trip_and_partition_ops(df):
    pf, jpf = from_pandas(df, 4), j_from_pandas(df, 4)
    assert (pf.npartitions, len(pf), list(pf.columns)) == \
        (jpf.npartitions, len(jpf), list(jpf.columns))
    assert [len(p) for p in pf.partitions] == \
        [len(p) for p in jpf.partitions]
    pd.testing.assert_frame_equal(pf.compute(), df)
    doubled = pf.map_partitions(lambda p: p.assign(a=p.a * 2))
    np.testing.assert_allclose(doubled.compute()["a"], df["a"] * 2)
    assert sum(pf.map_partitions(len)) == len(df)
    assert pf.reduce_partitions(len, sum) == len(df)
    assert list(pf[["a", "b"]].columns) == ["a", "b"]
    pd.testing.assert_series_equal(pf["a"], jpf["a"])
    _frames_equal(pf.assign(z=1), jpf.assign(z=1))
    with pytest.raises(ValueError, match="mismatched columns"):
        PartitionedFrame([df[["a"]], df[["b"]]])
    with pytest.raises(ValueError, match=">= 1 partition"):
        PartitionedFrame([])
    assert "npartitions=4" in repr(pf)


def test_global_categories_match_jax(df):
    df = df.copy()
    df.iloc[-1, df.columns.get_loc("c")] = "z"   # in the last partition
    got = from_pandas(df, 4).global_categories(["c", "b"])
    ref = j_from_pandas(df, 4).global_categories(["c", "b"])
    for col in ("c", "b"):
        assert list(got[col].categories) == list(ref[col].categories)
    assert set(got["c"].categories) == {"x", "y", "z"}


def test_encoders_over_partitions_match_jax(df):
    df = df.copy()
    df.iloc[-1, df.columns.get_loc("c")] = "z"
    pf, jpf = from_pandas(df, 4), j_from_pandas(df, 4)
    cat = TP.Categorizer().fit(pf)
    jcat = JP.Categorizer().fit(jpf)
    cpf, jcpf = cat.transform(pf), jcat.transform(jpf)
    assert isinstance(cpf, PartitionedFrame)
    for p in cpf.partitions:
        assert set(p["c"].cat.categories) == {"x", "y", "z"}
    _frames_equal(cpf, jcpf)
    _frames_equal(TP.DummyEncoder().fit(cpf).transform(cpf),
                  JP.DummyEncoder().fit(jcpf).transform(jcpf))
    _frames_equal(TP.DummyEncoder(drop_first=True).fit(cpf).transform(cpf),
                  JP.DummyEncoder(drop_first=True).fit(jcpf).transform(jcpf))
    _frames_equal(TP.OrdinalEncoder().fit(cpf).transform(cpf),
                  JP.OrdinalEncoder().fit(jcpf).transform(jcpf))
    with pytest.raises(TypeError, match="PartitionedFrame"):
        TP.OneHotEncoder().fit(pf)


@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler",
                                  "RobustScaler", "QuantileTransformer"])
def test_scalers_frame_in_frame_out_match_jax(df, name):
    num = df[["a", "b"]].astype(np.float64)
    pf, jpf = from_pandas(num, 4), j_from_pandas(num, 4)
    kw = {"n_quantiles": 50} if name == "QuantileTransformer" else {}
    ours, ref = getattr(TP, name)(**kw), getattr(JP, name)(**kw)
    out = ours.fit(pf).transform(pf)
    jout = ref.fit(jpf).transform(jpf)
    assert isinstance(out, PartitionedFrame)
    assert [len(p) for p in out.partitions] == \
        [len(p) for p in pf.partitions]
    got = out.compute()
    assert got.index.equals(num.index) and list(got.columns) == ["a", "b"]
    np.testing.assert_allclose(got.to_numpy(), jout.compute().to_numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours.feature_names_in_,
                                  np.asarray(["a", "b"], dtype=object))
    back = ours.inverse_transform(out)
    np.testing.assert_allclose(back.compute().to_numpy(), num.to_numpy(),
                               rtol=1e-4, atol=1e-4)
    ft = getattr(TP, name)(**kw).fit_transform(pf)
    np.testing.assert_allclose(ft.compute().to_numpy(), got.to_numpy())
    flipped = from_pandas(num[["b", "a"]], 4)
    with pytest.raises(ValueError, match="feature names"):
        ours.transform(flipped)


def test_scalers_reject_unencoded_and_polynomial(df):
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray

    with pytest.raises(ValueError, match="encode"):
        TP.StandardScaler().fit(from_pandas(df, 3))
    pf = from_pandas(df[["a", "b"]], 3)
    out = TP.PolynomialFeatures(degree=2, preserve_dataframe=True) \
        .fit(pf).transform(pf)
    ref = JP.PolynomialFeatures(degree=2, preserve_dataframe=True) \
        .fit(j_from_pandas(df[["a", "b"]], 3)).transform(
            j_from_pandas(df[["a", "b"]], 3))
    assert isinstance(out, PartitionedFrame)
    assert list(out.columns) == list(ref.columns)
    np.testing.assert_allclose(out.compute().to_numpy(),
                               ref.compute().to_numpy(), rtol=1e-5,
                               atol=1e-5)
    assert isinstance(TP.PolynomialFeatures(degree=2).fit(pf).transform(pf),
                      ShardedArray)


def test_column_transformer_partitioned_frames(df):
    from dask_ml_tpu.compose import ColumnTransformer as JCT
    from dask_ml_tpu_torch.compose import ColumnTransformer

    num = df[["a", "b"]].astype(np.float64)
    pf, jpf = from_pandas(num, 4), j_from_pandas(num, 4)
    ct = ColumnTransformer([("scale", TP.StandardScaler(), ["a"])],
                           remainder="passthrough")
    jct = JCT([("scale", JP.StandardScaler(), ["a"])],
              remainder="passthrough")
    out, jout = ct.fit_transform(pf), jct.fit_transform(jpf)
    assert isinstance(out, PartitionedFrame)
    assert [len(p) for p in out.partitions] == \
        [len(p) for p in pf.partitions]
    assert list(out.columns) == list(jout.columns) == ["a", "b"]
    np.testing.assert_allclose(out.compute().to_numpy(),
                               jout.compute().to_numpy(), rtol=1e-5,
                               atol=1e-5)
    pd.testing.assert_frame_equal(ct.transform(pf).compute(),
                                  out.compute())
    assert isinstance(ct.fit_transform(num), pd.DataFrame)


def test_to_sharded_into_a_fit_and_post_fit(df):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray
    from dask_ml_tpu_torch.wrappers import ParallelPostFit

    pf = from_pandas(df, 4)
    cat = TP.Categorizer().fit(pf).transform(pf)
    enc = TP.DummyEncoder()
    feats = enc.fit(cat).transform(cat)
    Xs = feats.to_sharded()
    assert isinstance(Xs, ShardedArray) and not Xs.process_local
    assert Xs.shape == (len(df), len(enc.transformed_columns_))
    ref = j_from_pandas(df, 4)
    jfeats = JP.DummyEncoder().fit(JP.Categorizer().fit(ref).transform(
        ref)).transform(JP.Categorizer().fit(ref).transform(ref))
    np.testing.assert_array_equal(Xs.to_numpy(),
                                  jfeats.to_sharded().to_numpy())
    y = (df["a"] > 0).astype(np.float32).to_numpy()
    clf = LogisticRegression(solver="lbfgs", max_iter=30).fit(Xs, y)
    assert clf.score(Xs, y) > 0.9
    # ParallelPostFit maps the fitted model over the partitions
    from sklearn.linear_model import LogisticRegression as SkLR

    num = feats.map_partitions(lambda p: p.astype(np.float64))
    sk = SkLR().fit(num.compute().to_numpy(), y)
    ppf = ParallelPostFit(sk)
    np.testing.assert_array_equal(
        ppf.predict(num), sk.predict(num.compute().to_numpy()))
    with pytest.raises(ValueError, match="no numeric columns"):
        from_pandas(df[["c"]], 2).to_sharded()
    # one process has no model axis: every column is placed, as JAX's
    # "feature" rule degrades on a 1-D mesh
    whole = feats.to_sharded(shard_features=True)
    assert not whole.model_sharded
    np.testing.assert_array_equal(whole.to_numpy(), Xs.to_numpy())


def test_splits_of_frames_match_jax(df):
    from dask_ml_tpu.model_selection import train_test_split as jsplit

    from dask_ml_tpu_torch.model_selection import (KFold, ShuffleSplit,
                                                   train_test_split)

    pf, jpf = from_pandas(df, 4), j_from_pandas(df, 4)
    y, jy = from_pandas(df[["b"]], 4), j_from_pandas(df[["b"]], 4)
    for kw in ({"blockwise": True}, {"blockwise": False},
               {"shuffle": False}):
        got = train_test_split(pf, y, test_size=0.25, random_state=0, **kw)
        ref = jsplit(jpf, jy, test_size=0.25, random_state=0, **kw)
        for g, r in zip(got, ref):
            assert isinstance(g, PartitionedFrame)
            _frames_equal(g, r)
    with pytest.raises(ValueError, match="identical partition"):
        train_test_split(pf, from_pandas(df, 3))
    folds = list(KFold(4).split(pf))
    assert [len(te) for _, te in folds] == [50] * 4
    tr, te = next(ShuffleSplit(1, test_size=0.2, random_state=0).split(pf))
    assert len(tr) + len(te) == len(df)


def test_frames_across_virtual_ranks(df):
    def body(rank):
        part = df.iloc[rank * 120:(rank + 1) * 120 - 40 * rank].copy()
        if rank == 1:
            part.iloc[0, part.columns.get_loc("c")] = "w"
        pf = from_pandas(part, 3)
        cats = pf.global_categories(["c"])["c"]
        enc = TP.Categorizer().fit(pf)
        Xs = pf.to_sharded(columns=["a", "b"])
        # the scaler's statistics merge over the processes' partitions
        sc = TP.StandardScaler().fit(pf[["a", "b"]])
        return (list(cats.categories), list(enc.categories_["c"].categories),
                Xs.n_rows, Xs.global_rows, Xs.row_offset, Xs.process_local,
                (sc.mean_, sc.var_, sc.n_samples_seen_))

    (c0, e0, n0, g0, o0, p0, s0), (c1, e1, n1, g1, o1, p1, s1) = \
        dist.run_virtual_processes(body, 2)
    assert c0 == c1 == e0 == e1 and set(c0) == {"x", "y", "w"}
    assert (n0, n1, g0, g1, o0, o1, p0, p1) == (120, 80, 200, 200, 0, 120,
                                                True, True)
    rows = pd.concat([df.iloc[:120], df.iloc[120:200]])[["a", "b"]]
    one = TP.StandardScaler().fit(rows.to_numpy(np.float32))
    for got in (s0, s1):
        np.testing.assert_allclose(got[0], one.mean_, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1], one.var_, rtol=1e-5)
        assert got[2] == 200

    def bad(rank):
        cols = ["a", "b"] if rank == 0 else ["a"]
        from_pandas(df, 2).to_sharded(columns=cols)

    with pytest.raises(ValueError, match="identical numeric column sets"):
        dist.run_virtual_processes(bad, 2)
