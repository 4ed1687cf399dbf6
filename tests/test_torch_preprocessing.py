"""The port's preprocessing estimators against dask_ml_tpu's on the same
numpy data, on the CPU.

Tolerances: fitted statistics and transforms to relative 1e-6, with an
absolute floor of 1e-6 of the largest reference value (f32 sums in
another order: JAX reduces over eight virtual devices); quantiles, exact
and sketched, to 1e-6 of each column's span; the normal output of
QuantileTransformer to 1e-5 (scipy's ndtri on the host against torch's
on the device). QuantileTransformer's subsample is drawn from JAX's key
and handed to the port (``jax_subsample``). Encoders, LabelEncoder and
the frame paths are compared for equality."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dask_ml_tpu import preprocessing as J
from dask_ml_tpu.models.kmeans import _gumbel_top_l
from dask_ml_tpu.parallel.sharded import ShardedArray as JSA
from dask_ml_tpu.preprocessing import data as jdata
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch import preprocessing as T
from dask_ml_tpu_torch.parallel import ShardedArray
from dask_ml_tpu_torch.preprocessing import data as tdata


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture
def jax_subsample(monkeypatch):
    def draw(X, size, random_state):
        key = jax.random.PRNGKey(0 if random_state is None
                                 else int(random_state))
        mask = jnp.asarray(X.row_mask().numpy())
        return torch.as_tensor(np.array(_gumbel_top_l(mask, key, size)),
                               device=X.device)

    monkeypatch.setattr(tdata, "_subsample_rows", draw)


def _data(seed=0, n=1500, d=6, nan=0.0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * np.geomspace(0.5, 20, d) + rng.randn(d) * 3)
    if nan:
        X[rng.rand(n, d) < nan] = np.nan
    return X.astype(np.float32)


def _host(v):
    return np.asarray(v.to_numpy() if hasattr(v, "to_numpy") else v)


def _close(t, j, rtol=1e-6):
    t, j = _host(t).astype(np.float64), _host(j).astype(np.float64)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(j)))


SCALERS = {
    "standard": (dict(), ("mean_", "var_", "scale_")),
    "standard_nomean": (dict(with_mean=False), ("var_", "scale_")),
    "minmax": (dict(feature_range=(-1, 2)),
               ("data_min_", "data_max_", "scale_", "min_")),
    "minmax_clip": (dict(clip=True), ("scale_", "min_")),
    "robust": (dict(quantile_range=(10.0, 80.0)), ("center_", "scale_")),
    "quantile": (dict(n_quantiles=50), ("quantiles_", "references_")),
    "quantile_normal": (dict(n_quantiles=100,
                             output_distribution="normal"),
                        ("quantiles_",)),
}
_CLASS = {"standard": "StandardScaler", "minmax": "MinMaxScaler",
          "robust": "RobustScaler", "quantile": "QuantileTransformer"}


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("case", sorted(SCALERS))
def test_scalers_match_jax(case, sharded):
    kw, attrs = SCALERS[case]
    name = _CLASS[case.split("_")[0]]
    X = _data(1)
    Xt = ShardedArray.from_array(X) if sharded else X
    Xj = JSA.from_array(X) if sharded else X
    j = getattr(J, name)(**kw).fit(Xj)
    t = getattr(T, name)(**kw).fit(Xt)
    for a in attrs:
        _close(getattr(t, a), getattr(j, a))
    rtol = 1e-5 if "normal" in case else 1e-6
    X2 = _data(2) * 1.2          # some values past the fitted range
    _close(t.transform(X2), j.transform(X2), rtol)
    out = t.transform(X2)
    assert isinstance(out, ShardedArray)
    _close(t.inverse_transform(out), j.inverse_transform(_host(out)), 1e-5)
    _close(t.fit_transform(Xt), j.fit_transform(Xj), rtol)


@pytest.mark.parametrize("name", ["RobustScaler", "QuantileTransformer"])
def test_quantile_scalers_skip_nan(name):
    X = _data(3, nan=0.1)
    j = getattr(J, name)().fit(X)
    t = getattr(T, name)().fit(X)
    attr = "center_" if name == "RobustScaler" else "quantiles_"
    _close(getattr(t, attr), getattr(j, attr))
    # the map alone, on JAX's statistics: a one-ulp gap between two close
    # quantiles moves the interpolation by its slope
    setattr(t, attr, getattr(j, attr))
    if name == "RobustScaler":
        t.scale_ = j.scale_
    out = _host(t.transform(X))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(X))
    _close(out, j.transform(X))


def test_moment_scalers_reject_nan():
    X = _data(3, nan=0.1)
    for est in (T.StandardScaler(), T.MinMaxScaler()):
        with pytest.raises(ValueError, match="NaN"):
            est.fit(X)


@pytest.mark.parametrize("sketch", [False, True])
@pytest.mark.parametrize("seed", [0, 4])
def test_quantiles_match_jax(sketch, seed):
    """The sort-based exact quantiles and the integer-count sketch (forced
    at a small n) against JAX's, to 1e-6 of each column's span."""
    X = _data(seed, n=2500, d=7)
    X[:, 3] = np.round(X[:, 3])          # ties
    X[:, 5] = 2.5                        # a constant column
    qs = [0.0, 0.1, 0.25, 0.5, 0.77, 1.0]
    t = _host(tdata._masked_quantiles(ShardedArray.from_array(X), qs,
                                      sketch=sketch))
    j = _host(jdata._masked_quantiles(JSA.from_array(X), qs, sketch=sketch))
    span = np.maximum(X.max(0) - X.min(0), 1e-12)
    assert np.all(np.abs(t - j) <= 1e-6 * span + 1e-6 * np.abs(j))


def test_exact_quantiles_equal_numpy_nanquantile():
    X = _data(5, n=999, d=4, nan=0.2)
    X[:, 2] = np.nan                     # an all-NaN column
    qs = np.linspace(0, 1, 11)
    out = tdata.nan_quantiles(torch.as_tensor(X), qs).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        ref = np.nanquantile(X.astype(np.float64), qs, axis=0)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_sketch_counts_in_row_chunks(monkeypatch):
    X = ShardedArray.from_array(_data(6, n=3000, d=5))
    whole = tdata._masked_quantiles(X, [0.2, 0.5, 0.9], sketch=True)
    monkeypatch.setattr(tdata, "_SKETCH_CHUNK_BYTES", 8 * 5 * 101)
    chunked = tdata._masked_quantiles(X, [0.2, 0.5, 0.9], sketch=True)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_quantile_transformer_subsample(dist, jax_subsample):
    X = _data(7, n=3000)
    kw = dict(n_quantiles=200, subsample=1000, random_state=3,
              output_distribution=dist)
    j = J.QuantileTransformer(**kw).fit(X)
    t = T.QuantileTransformer(**kw).fit(X)
    _close(t.quantiles_, j.quantiles_)
    rtol = 1e-5 if dist == "normal" else 1e-6
    _close(t.transform(X), j.transform(X), rtol)


def test_quantile_transformer_refusals():
    with pytest.raises(ValueError, match="sparse"):
        T.QuantileTransformer(ignore_implicit_zeros=True).fit(_data())
    with pytest.raises(ValueError, match="cannot be"):
        T.QuantileTransformer(n_quantiles=50, subsample=10).fit(_data())


@pytest.mark.parametrize("kw", [dict(), dict(degree=3),
                                dict(interaction_only=True),
                                dict(include_bias=False, degree=3)])
def test_polynomial_features_match_jax(kw):
    X = _data(8, n=300, d=4)
    j = J.PolynomialFeatures(**kw).fit(X)
    t = T.PolynomialFeatures(**kw).fit(ShardedArray.from_array(X))
    assert t.n_output_features_ == j.n_output_features_
    np.testing.assert_array_equal(_host(t.transform(X)),
                                  _host(j.transform(X)))
    assert list(t.get_feature_names_out(["a", "b", "c", "d"])) == \
        list(j.get_feature_names_out(["a", "b", "c", "d"]))


def _codes(seed=0, n=400):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, 4, n), rng.randint(0, 2, n) * 5,
                     rng.randint(-2, 3, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("drop", [None, "first", "if_binary",
                                  [0.0, None, 2.0]])
@pytest.mark.parametrize("sharded", [False, True])
def test_onehot_matches_jax(drop, sharded):
    C = _codes()
    Ct = ShardedArray.from_array(C) if sharded else C
    Cj = JSA.from_array(C) if sharded else C
    j = J.OneHotEncoder(drop=drop).fit(Cj)
    t = T.OneHotEncoder(drop=drop).fit(Ct)
    for a, b in zip(t.categories_, j.categories_):
        np.testing.assert_array_equal(a, b)
    out = t.transform(Ct)
    assert isinstance(out, ShardedArray) == sharded
    np.testing.assert_array_equal(_host(out), _host(j.transform(Cj)))
    assert list(t.get_feature_names_out()) == list(j.get_feature_names_out())
    np.testing.assert_array_equal(t.inverse_transform(out),
                                  j.inverse_transform(_host(out)))


@pytest.mark.parametrize("sharded", [False, True])
def test_onehot_unknown(sharded):
    C = _codes()
    t = T.OneHotEncoder().fit(C)
    bad = C.copy()
    bad[17, 1] = 3.0
    wrap = ShardedArray.from_array if sharded else (lambda a: a)
    with pytest.raises(ValueError, match="unknown categories"):
        t.transform(wrap(bad))
    ign = T.OneHotEncoder(handle_unknown="ignore").fit(C)
    j = J.OneHotEncoder(handle_unknown="ignore").fit(C)
    out = ign.transform(wrap(bad))
    np.testing.assert_array_equal(_host(out), _host(j.transform(bad)))
    assert ign.inverse_transform(out)[17, 1] is None


def test_ordinal_and_label_encoders_match_jax():
    C = _codes(2)
    for Ct, Cj in ((C, C), (ShardedArray.from_array(C), JSA.from_array(C))):
        t = T.OrdinalEncoder().fit(Ct)
        j = J.OrdinalEncoder().fit(Cj)
        np.testing.assert_array_equal(_host(t.transform(Ct)),
                                      _host(j.transform(Cj)))
    y = np.array([3.0, -1.0, 3.0, 7.5, -1.0], np.float32)
    for yt, yj in ((y, y), (ShardedArray.from_array(y), JSA.from_array(y))):
        t = T.LabelEncoder().fit(yt)
        j = J.LabelEncoder().fit(yj)
        np.testing.assert_array_equal(t.classes_, j.classes_)
        codes = t.transform(yt)
        np.testing.assert_array_equal(_host(codes), _host(j.transform(yj)))
        np.testing.assert_array_equal(t.inverse_transform(codes), y)
        np.testing.assert_array_equal(
            _host(convert.convert(j).transform(yt)), _host(codes))
        bad = np.array([3.0, 4.0], np.float32)
        with pytest.raises(ValueError, match="unseen labels"):
            t.transform(ShardedArray.from_array(bad)
                        if isinstance(yt, ShardedArray) else bad)


def _numpy_only(x, factor=2.0):
    if not isinstance(x, np.ndarray):
        raise TypeError("numpy arrays only")
    return np.log1p(np.abs(x)) * factor


def test_block_transformer():
    X = _data(9, n=50)
    Xs = ShardedArray.from_array(X)
    out = T.BlockTransformer(_numpy_only, factor=3.0).fit(Xs).transform(Xs)
    assert isinstance(out, ShardedArray)
    np.testing.assert_allclose(out.to_numpy(), _numpy_only(X, 3.0),
                               rtol=1e-6)
    tor = T.BlockTransformer(torch.exp).transform(Xs)
    np.testing.assert_allclose(tor.to_numpy(), np.exp(X), rtol=1e-6)
    np.testing.assert_array_equal(
        T.BlockTransformer(_numpy_only).transform(X), _numpy_only(X))

    def broken(x):
        raise ValueError("device path failed")

    with pytest.raises(ValueError, match="device path failed"):
        T.BlockTransformer(broken).transform(Xs)


def _frame(seed=0, n=200):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "a": rng.randn(n), "b": rng.randn(n) * 5 + 1,
        "c": rng.randint(0, 3, n).astype(np.float64),
    }, index=np.arange(n) * 3)


@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler",
                                  "RobustScaler", "QuantileTransformer"])
def test_frame_in_frame_out(name):
    df = _frame()
    t = getattr(T, name)().fit(df)
    j = getattr(J, name)().fit(df)
    out, ref = t.transform(df), j.transform(df)
    assert isinstance(out, pd.DataFrame)
    assert list(out.columns) == list(ref.columns)
    assert out.index.equals(ref.index)
    _close(out.to_numpy(), ref.to_numpy())
    back = t.inverse_transform(out)
    assert isinstance(back, pd.DataFrame)
    _close(back.to_numpy(), df.to_numpy(), 1e-5)
    with pytest.raises(ValueError, match="do not match"):
        t.transform(df.rename(columns={"a": "z"}))


def test_frame_polynomial_and_unencoded_columns():
    df = _frame(1)
    t = T.PolynomialFeatures(preserve_dataframe=True).fit_transform(df)
    j = J.PolynomialFeatures(preserve_dataframe=True).fit_transform(df)
    assert list(t.columns) == list(j.columns)
    _close(t.to_numpy(), j.to_numpy())
    with pytest.raises(ValueError, match="encode them first"):
        T.StandardScaler().fit(df.assign(s=["x"] * len(df)))


def test_frame_encoders_match_jax():
    rng = np.random.RandomState(0)
    df = pd.DataFrame({"city": rng.choice(["a", "b", "c"], 60),
                       "kind": rng.choice(["x", "y"], 60),
                       "v": rng.randn(60)})
    tc, jc = T.Categorizer().fit(df), J.Categorizer().fit(df)
    assert list(tc.columns_) == list(jc.columns_)
    cat_t, cat_j = tc.transform(df), jc.transform(df)
    pd.testing.assert_frame_equal(cat_t, cat_j)
    for kw in (dict(), dict(drop_first=True)):
        d_t = T.DummyEncoder(**kw).fit(cat_t)
        d_j = J.DummyEncoder(**kw).fit(cat_j)
        out = d_t.transform(cat_t)
        pd.testing.assert_frame_equal(out, d_j.transform(cat_j))
    pd.testing.assert_frame_equal(
        T.DummyEncoder().fit(cat_t).inverse_transform(
            T.DummyEncoder().fit_transform(cat_t)),
        J.DummyEncoder().fit(cat_j).inverse_transform(
            J.DummyEncoder().fit_transform(cat_j)))
    pd.testing.assert_frame_equal(T.OrdinalEncoder().fit_transform(cat_t),
                                  J.OrdinalEncoder().fit_transform(cat_j))
    oh_t = T.OneHotEncoder().fit(cat_t[["city", "kind"]])
    oh_j = J.OneHotEncoder().fit(cat_j[["city", "kind"]])
    np.testing.assert_array_equal(oh_t.transform(cat_t[["city", "kind"]]),
                                  oh_j.transform(cat_j[["city", "kind"]]))
    assert list(oh_t.get_feature_names_out()) == \
        list(oh_j.get_feature_names_out())
    s = cat_t["city"]
    le = T.LabelEncoder().fit(s)
    np.testing.assert_array_equal(le.transform(s),
                                  J.LabelEncoder().fit(s).transform(s))
    with pytest.raises(TypeError, match="DataFrame"):
        T.Categorizer().fit(np.zeros((3, 2)))


def test_frame_encoders_name_pandas_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    for est in (T.Categorizer(), T.DummyEncoder()):
        with pytest.raises(ImportError, match="pandas"):
            est.fit(np.zeros((3, 2)))


@pytest.mark.parametrize("name,kw", [
    ("StandardScaler", {}), ("MinMaxScaler", {}), ("RobustScaler", {}),
    ("QuantileTransformer", {"n_quantiles": 40}),
    ("PolynomialFeatures", {"degree": 3}),
    ("OneHotEncoder", {"drop": "first"}), ("OrdinalEncoder", {}),
])
def test_convert_carries_jax_fit(name, kw):
    X = _codes(4) if "Encoder" in name else _data(10, n=400, d=3)
    j = getattr(J, name)(**kw).fit(X)
    t = convert.convert(j)
    assert type(t) is getattr(T, name)
    np.testing.assert_allclose(_host(t.transform(X)), _host(j.transform(X)),
                               rtol=1e-6, atol=1e-6)
