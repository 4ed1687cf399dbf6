"""The port's SimpleImputer and ColumnTransformer against dask_ml_tpu's
on the same numpy data, on the CPU. Tolerances: statistics and outputs
to relative 1e-6 with an absolute floor of 1e-6 of the largest reference
value (f32 sums in another order); the one-hot and passthrough columns
exactly."""

import numpy as np
import pandas as pd
import pytest

from dask_ml_tpu import compose as JC
from dask_ml_tpu import impute as JI
from dask_ml_tpu import preprocessing as JP
from dask_ml_tpu.parallel.sharded import ShardedArray as JSA
from dask_ml_tpu_torch import compose as TC
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import impute as TI
from dask_ml_tpu_torch import preprocessing as TP
from dask_ml_tpu_torch.parallel import ShardedArray


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _host(v):
    return np.asarray(v.to_numpy() if hasattr(v, "to_numpy") else v)


def _close(t, j, rtol=1e-6):
    t, j = _host(t).astype(np.float64), _host(j).astype(np.float64)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(j)))


def _nan_data(seed=0, n=900, d=5):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, d) * 3, 1) + np.arange(d)
    X[rng.rand(n, d) < 0.15] = np.nan
    return X.astype(np.float32)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("kw", [
    dict(strategy="mean"), dict(strategy="median"),
    dict(strategy="most_frequent"), dict(strategy="constant"),
    dict(strategy="constant", fill_value=-7.0),
    dict(strategy="mean", missing_values=0.5),
])
def test_imputer_matches_jax(kw, sharded):
    X = _nan_data()
    if "missing_values" in kw:
        X = np.nan_to_num(X, nan=0.5)
    Xt = ShardedArray.from_array(X) if sharded else X
    Xj = JSA.from_array(X) if sharded else X
    j = JI.SimpleImputer(**kw).fit(Xj)
    t = TI.SimpleImputer(**kw).fit(Xt)
    _close(t.statistics_, j.statistics_)
    out = t.transform(Xt)
    assert isinstance(out, ShardedArray)
    assert not np.isnan(_host(out)).any()
    _close(out, j.transform(Xj))
    _close(convert.convert(j).transform(X), j.transform(X))


def test_imputer_refuses_unknown_strategy():
    with pytest.raises(ValueError, match="strategy must be one of"):
        TI.SimpleImputer(strategy="mode").fit(_nan_data())


def _mixed(seed=0, n=300):
    rng = np.random.RandomState(seed)
    num = rng.randn(n, 3) * [1.0, 5.0, 0.2] + [0.0, 2.0, -1.0]
    codes = rng.randint(0, 4, size=(n, 2))
    return np.concatenate([num, codes], axis=1).astype(np.float32)


def _pair(remainder="drop"):
    def make(P, C):
        return C.ColumnTransformer(
            [("num", P.StandardScaler(), [0, 1]),
             ("cat", P.OneHotEncoder(), [3, 4]),
             ("gone", "drop", [2])], remainder=remainder)
    return make(TP, TC), make(JP, JC)


@pytest.mark.parametrize("remainder", ["drop", "passthrough"])
@pytest.mark.parametrize("sharded", [False, True])
def test_column_transformer_integer_columns(remainder, sharded):
    X = _mixed()
    Xt = ShardedArray.from_array(X) if sharded else X
    Xj = JSA.from_array(X) if sharded else X
    t, j = _pair(remainder)
    out_t, out_j = t.fit_transform(Xt), j.fit_transform(Xj)
    assert isinstance(out_t, ShardedArray) == isinstance(out_j, JSA)
    _close(out_t, out_j)
    np.testing.assert_array_equal(_host(out_t)[:, 2:10],
                                  _host(out_j)[:, 2:10])
    _close(t.transform(Xt), j.transform(Xj))
    assert sorted(t.named_transformers_) == sorted(j.named_transformers_)
    c = convert.convert(j)
    _close(c.transform(Xt), j.transform(Xj))


def test_column_transformer_mixed_outputs_and_passthrough():
    """A device branch beside a host branch: the port concatenates on the
    device; the values equal JAX's host concatenation."""
    X = _mixed(1)

    def make(P, C):
        return C.ColumnTransformer([("num", P.StandardScaler(), [0, 1, 2]),
                                    ("raw", "passthrough", [3])])
    t, j = make(TP, TC), make(JP, JC)
    out_t = t.fit_transform(X)
    _close(out_t, j.fit_transform(X))
    Xs = ShardedArray.from_array(X)
    t2 = TC.ColumnTransformer([("num", TP.StandardScaler(), [0, 1]),
                               ("host", TP.OneHotEncoder(), [3])])
    t2.fit(X)
    j2 = JC.ColumnTransformer([("num", JP.StandardScaler(), [0, 1]),
                               ("host", JP.OneHotEncoder(), [3])]).fit(X)
    out = t2.transform(Xs)
    assert isinstance(out, ShardedArray)
    _close(out, j2.transform(X))
    with pytest.raises(ValueError, match="remainder"):
        TC.ColumnTransformer([("a", "drop", [0])], remainder="x").fit(X)


def test_column_transformer_named_columns_on_frames():
    rng = np.random.RandomState(2)
    df = pd.DataFrame({"a": rng.randn(80), "b": rng.randn(80) * 3,
                       "c": rng.randint(0, 3, 80).astype(float)},
                      index=np.arange(80) + 100)

    def make(P, C, **kw):
        return C.make_column_transformer(
            (P.StandardScaler(), ["a", "b"]), remainder="passthrough", **kw)
    t, j = make(TP, TC), make(JP, JC)
    out_t, out_j = t.fit_transform(df), j.fit_transform(df)
    assert isinstance(out_t, pd.DataFrame)
    assert list(out_t.columns) == list(out_j.columns)
    assert out_t.index.equals(df.index)
    _close(out_t.to_numpy(), out_j.to_numpy())
    assert [n for n, _, _ in t.transformers] == \
        [n for n, _, _ in j.transformers]
    t2, j2 = (make(TP, TC, preserve_dataframe=False),
              make(JP, JC, preserve_dataframe=False))
    _close(t2.fit_transform(df), j2.fit_transform(df))
