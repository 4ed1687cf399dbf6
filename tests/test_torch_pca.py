"""The port's PCA, TruncatedSVD and IncrementalPCA against dask_ml_tpu's
on the same numpy data, in memory, on the CPU.

The randomized solvers draw Ω from a ``torch.Generator``, JAX from its
PRNG; the ``jax_omega`` fixture hands the port JAX's draw for the same
seed, so both run the same range finder. Components are compared after
both packages' V-based sign flip. Tolerances (each at least as tight as
``tests/test_pca.py``'s against sklearn): mean 1e-5, singular values and
explained variance rel 1e-4, ratios rel 1e-4, components 1e-4 (an f32
QR or SVD of the same matrix in another order), noise variance rel
1e-3, scores 1e-3 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dask_ml_tpu.decomposition import PCA as JPCA
from dask_ml_tpu.decomposition import IncrementalPCA as JIPCA
from dask_ml_tpu.decomposition import TruncatedSVD as JTSVD
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.decomposition import PCA, IncrementalPCA, TruncatedSVD
from dask_ml_tpu_torch.ops import linalg
from dask_ml_tpu_torch.parallel import ShardedArray

PCA_ATTRS = {"mean_": (0, 1e-5), "singular_values_": (1e-4, 0),
             "explained_variance_": (1e-4, 0),
             "explained_variance_ratio_": (1e-4, 0),
             "components_": (0, 1e-4), "noise_variance_": (1e-3, 1e-9)}


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


@pytest.fixture
def jax_omega(monkeypatch):
    def draw(d, size, random_state, device, dtype=torch.float32):
        key = jax.random.PRNGKey(0 if random_state is None
                                 else int(random_state))
        return torch.tensor(np.asarray(
            jax.random.normal(key, (d, size), jnp.float32)), device=device)

    monkeypatch.setattr(linalg, "draw_omega", draw)


def _data(seed, n=2000, d=16, mean=2.0):
    rng = np.random.RandomState(seed)
    scale = np.geomspace(5.0, 0.1, d)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    X = (rng.randn(n, d) * scale) @ basis + mean * rng.randn(d)
    return X.astype(np.float32)


def _host(v):
    return v.to_numpy() if hasattr(v, "to_numpy") else np.asarray(v)


def _same(t, j, attrs=PCA_ATTRS):
    for a, (rtol, atol) in attrs.items():
        if not hasattr(j, a):
            continue
        np.testing.assert_allclose(
            np.asarray(getattr(t, a), np.float64),
            np.asarray(getattr(j, a), np.float64),
            rtol=rtol, atol=atol, err_msg=a)
    for a in ("n_components_", "n_features_in_", "n_samples_"):
        if hasattr(j, a):
            assert getattr(t, a) == getattr(j, a), a


@pytest.mark.parametrize("solver", ["full", "tsqr", "randomized", "auto"])
def test_pca_solvers_match_jax(solver, jax_omega):
    n, d, k = (1200, 220, 6) if solver == "auto" else (2000, 16, 5)
    X = _data(1, n, d)
    kw = dict(n_components=k, svd_solver=solver, random_state=3,
              iterated_power=3)
    t = PCA(**kw).fit(X)
    j = JPCA(**kw).fit(X)
    assert t._solver(k, n, d) == j._solver(k, n, d)
    assert (solver != "auto") or t._solver(k, n, d) == "randomized"
    _same(t, j)


def test_pca_default_components_and_fraction():
    X = _data(2)
    for nc in (None, 0.9, 0.5, 3.0):
        t = PCA(n_components=nc).fit(X)
        j = JPCA(n_components=nc).fit(X)
        _same(t, j)
    assert PCA(n_components=0.9).fit(X).n_components_ < 16


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_transforms_match_jax(whiten):
    """transform, fit_transform, inverse_transform on numpy, tensor and
    ShardedArray input."""
    X = _data(3)
    t = PCA(n_components=4, whiten=whiten, svd_solver="full")
    j = JPCA(n_components=4, whiten=whiten, svd_solver="full")
    ft, fj = _host(t.fit_transform(X)), _host(j.fit_transform(X))
    scale = np.abs(fj).max()
    np.testing.assert_allclose(ft, fj, atol=1e-4 * scale)
    tt, tj = _host(t.transform(X)), _host(j.transform(X))
    np.testing.assert_allclose(tt, tj, atol=1e-4 * scale)
    np.testing.assert_allclose(tt, ft, atol=1e-4 * scale)
    for src in (torch.from_numpy(X), ShardedArray.from_array(X)):
        np.testing.assert_allclose(_host(t.transform(src)), tt, atol=1e-6)
    back_t = _host(t.inverse_transform(tt))
    back_j = _host(j.inverse_transform(tj))
    np.testing.assert_allclose(back_t, back_j, atol=1e-4 * np.abs(X).max())
    if whiten:
        np.testing.assert_allclose(tt.std(axis=0, ddof=1), 1.0, rtol=1e-3)


def test_pca_full_rank_round_trip():
    X = _data(4, d=8)
    p = PCA(n_components=8, svd_solver="full").fit(X)
    back = _host(p.inverse_transform(p.transform(X)))
    np.testing.assert_allclose(back, X, atol=1e-4 * np.abs(X).max())


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_probabilistic_scoring_matches_jax(whiten):
    X = _data(5, n=1500, d=10)
    t = PCA(n_components=3, whiten=whiten, svd_solver="full").fit(X)
    j = JPCA(n_components=3, whiten=whiten, svd_solver="full").fit(X)
    cov = j.get_covariance()
    np.testing.assert_allclose(t.get_covariance(), cov,
                               atol=1e-4 * np.abs(cov).max())
    prec = j.get_precision()
    np.testing.assert_allclose(t.get_precision(), prec,
                               atol=1e-3 * np.abs(prec).max())
    ll_t, ll_j = t.score_samples(X), _host(j.score_samples(X))
    assert isinstance(ll_t, np.ndarray) and ll_t.shape == (1500,)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    assert t.score(X) == pytest.approx(j.score(X), rel=1e-5)


def test_pca_errors():
    X = _data(6, n=203, d=8)
    with pytest.raises(ValueError, match="n_components"):
        PCA(n_components=100).fit(X)
    with pytest.raises(ValueError, match="tall"):
        PCA().fit(X[:4])
    with pytest.raises(ValueError, match="svd_solver"):
        PCA(svd_solver="nope").fit(X)
    with pytest.raises(ValueError, match="variance fraction"):
        PCA(n_components=0.9, svd_solver="randomized").fit(X)
    with pytest.raises(AttributeError, match="not fitted"):
        PCA().transform(X)
    # the training profile is a streamed fit's, as in dask_ml_tpu: an
    # in-memory fit has none, a streamed one folds every row here
    with pytest.raises(AttributeError, match="training_profile_"):
        PCA().fit(X).training_profile_
    with config.set(stream_block_rows=len(X) // 3):
        prof = PCA(n_components=2).fit(np.asarray(X)).training_profile_
    assert prof["rows"] == len(X) and prof["n_features"] == X.shape[1]


@pytest.mark.parametrize("algorithm", ["tsqr", "randomized"])
def test_truncated_svd_matches_jax(algorithm, jax_omega):
    X = _data(7, mean=1.0)
    kw = dict(n_components=4, algorithm=algorithm, random_state=1,
              n_iter=3)
    t, j = TruncatedSVD(**kw), JTSVD(**kw)
    ft, fj = _host(t.fit_transform(X)), _host(j.fit_transform(X))
    _same(t, j)
    scale = np.abs(fj).max()
    np.testing.assert_allclose(ft, fj, atol=1e-4 * scale)
    np.testing.assert_allclose(_host(t.transform(X)), _host(j.transform(X)),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(_host(t.inverse_transform(ft)),
                               _host(j.inverse_transform(fj)),
                               atol=1e-4 * np.abs(X).max())
    t2 = TruncatedSVD(**kw).fit(X)
    np.testing.assert_allclose(t2.components_, t.components_, atol=1e-6)


def test_truncated_svd_errors():
    X = _data(8, n=100, d=8)
    with pytest.raises(ValueError, match="n_components"):
        TruncatedSVD(n_components=8).fit(X)
    with pytest.raises(ValueError, match="algorithm"):
        TruncatedSVD(algorithm="arpack").fit(X)
    with pytest.raises(ValueError, match="n_samples >= n_features"):
        TruncatedSVD(n_components=2).fit(X[:5])


@pytest.mark.parametrize("source", ["numpy", "tensor", "sharded"])
def test_incremental_pca_matches_jax(source):
    """The block updates (batch_size 300, the ragged last block
    included) follow JAX's: components 1e-4 after alignment of signs,
    singular values rel 1e-4, mean 1e-5, ratios rel 1e-4."""
    X = _data(9, mean=50.0)
    src = {"numpy": X, "tensor": torch.from_numpy(X),
           "sharded": ShardedArray.from_array(X)}[source]
    t = IncrementalPCA(n_components=4, batch_size=300).fit(src)
    j = JIPCA(n_components=4, batch_size=300).fit(X)
    sign = np.sign(np.sum(t.components_ * j.components_, axis=1))
    np.testing.assert_allclose(t.components_ * sign[:, None],
                               j.components_, atol=1e-4)
    attrs = {a: v for a, v in PCA_ATTRS.items() if a != "components_"}
    _same(t, j, attrs)
    assert t.n_samples_seen_ == j.n_samples_seen_ == 2000
    ft = _host(IncrementalPCA(n_components=4, batch_size=300)
               .fit_transform(X))
    np.testing.assert_allclose(np.abs(ft), np.abs(_host(j.transform(X))),
                               atol=1e-3 * np.abs(ft).max())


def test_incremental_pca_default_batch_and_close_to_pca():
    """The default batch (max(n // 10, 5 d)) and the tolerances of
    tests/test_pca.py::test_incremental_pca_close_to_pca against PCA."""
    X = _data(10, n=3000)
    t = IncrementalPCA(n_components=4).fit(X)
    j = JIPCA(n_components=4).fit(X)
    _same(t, j, {a: v for a, v in PCA_ATTRS.items() if a != "components_"})
    ref = PCA(n_components=4, svd_solver="full").fit(X)
    np.testing.assert_allclose(t.mean_, ref.mean_, atol=1e-3)
    np.testing.assert_allclose(t.singular_values_, ref.singular_values_,
                               rtol=5e-2)
    np.testing.assert_allclose(np.abs(t.components_ @ ref.components_.T),
                               np.eye(4), atol=0.05)


def test_incremental_pca_partial_fit_matches_jax():
    X = _data(11)
    t, j = IncrementalPCA(n_components=3), JIPCA(n_components=3)
    for i in range(0, 2000, 400):
        t.partial_fit(X[i:i + 400])
        j.partial_fit(X[i:i + 400])
    assert t.n_samples_seen_ == 2000 and t.components_.shape == (3, 16)
    np.testing.assert_allclose(np.abs(t.components_), np.abs(j.components_),
                               atol=1e-4)
    np.testing.assert_allclose(t.singular_values_, j.singular_values_,
                               rtol=1e-4)
    np.testing.assert_allclose(t.mean_, j.mean_, atol=1e-5)


def test_incremental_pca_errors():
    with pytest.raises(ValueError, match="0 sample"):
        IncrementalPCA(n_components=2).fit(np.empty((0, 4), np.float32))
    Xbad = _data(12, n=300, d=8)
    Xbad[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        IncrementalPCA(n_components=2, batch_size=50).fit(Xbad)


def test_sparse_input_raises():
    """A sparse X no longer raises: the decompositions stream it
    densified a block at a time and fit it as its dense rows."""
    blk = sp.random(120, 8, density=0.4, format="csr",
                    random_state=np.random.RandomState(0))
    dense = blk.toarray().astype(np.float32)
    kw = dict(n_components=3)
    for make, fit in (
            (lambda: IncrementalPCA(**kw), lambda e, X: e.partial_fit(X)),
            (lambda: IncrementalPCA(**kw), lambda e, X: e.fit(X)),
            (lambda: TruncatedSVD(algorithm="randomized", n_iter=8,
                                  random_state=0, **kw),
             lambda e, X: e.fit(X)),
            (lambda: PCA(**kw), lambda e, X: e.fit(X))):
        a, b = fit(make(), blk), fit(make(), dense)
        np.testing.assert_allclose(np.abs(a.components_),
                                   np.abs(b.components_), atol=1e-4)
        np.testing.assert_allclose(a.singular_values_, b.singular_values_,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", ["PCA", "TruncatedSVD", "IncrementalPCA"])
def test_convert_round_trip(name):
    """A JAX fit's attributes carry across; transform (and for PCA
    score_samples) agree; a converted IncrementalPCA continues its
    partial_fit as the JAX one does."""
    X = _data(13)
    j = {"PCA": lambda: JPCA(n_components=3, whiten=True),
         "TruncatedSVD": lambda: JTSVD(n_components=3),
         "IncrementalPCA": lambda: JIPCA(n_components=3,
                                         batch_size=500)}[name]().fit(X)
    t = convert.convert(j)
    assert type(t).__name__ == name
    assert t.get_params() == j.get_params()
    np.testing.assert_array_equal(t.components_, j.components_)
    tj = _host(j.transform(X))
    np.testing.assert_allclose(_host(t.transform(X)), tj,
                               atol=1e-5 * np.abs(tj).max())
    if name != "TruncatedSVD":
        np.testing.assert_allclose(t.score_samples(X),
                                   _host(j.score_samples(X)),
                                   rtol=1e-5, atol=1e-4)
    if name == "IncrementalPCA":
        assert t.n_samples_seen_ == 2000
        Xn = _data(14, n=500)
        t.partial_fit(Xn)
        j.partial_fit(Xn)
        assert t.n_samples_seen_ == 2500
        np.testing.assert_allclose(np.abs(t.components_),
                                   np.abs(j.components_), atol=1e-4)
        np.testing.assert_allclose(t.mean_, j.mean_, atol=1e-5)
