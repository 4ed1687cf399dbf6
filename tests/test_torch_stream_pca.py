"""The port's streamed (out-of-core) decomposition fits against
dask_ml_tpu's streamed fits and the port's resident fits, on the CPU.

An ``np.memmap`` streams in both packages (its blocks through the port's
readahead reader); dask_ml_tpu runs on one device (``stream_mesh=1``),
so both cut the same blocks. The randomized fits take JAX's Ω for the
seed (``jax_omega``), so both run the same range passes. Tolerances:
the Gram route sums the same f32 block moments in float64 (components
1e-6, spectrum rel 1e-6); the range passes chain f32 QRs in another
order (components 1e-4, singular values rel 1e-4); against the
resident fits of the port, 1e-4 and rel 1e-4; bf16 Gram products
against JAX's bf16 einsum, components 1e-4 and spectrum rel 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.decomposition import PCA as JPCA
from dask_ml_tpu.decomposition import TruncatedSVD as JTSVD
from dask_ml_tpu.parallel import streaming as jstreaming
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
from dask_ml_tpu_torch.ops import linalg

BLOCK = 700
SPECTRUM = ("singular_values_", "explained_variance_",
            "explained_variance_ratio_")


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every superblock in fresh
    buffers, the reference's own switch for backends whose
    ``device_put`` aliases host memory (jax's CPU backend aliases a
    64-byte-aligned numpy array, so a reused staging slab could be
    rewritten under a read still queued)."""
    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)


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


def _data(seed, n=5000, d=24, mean=3.0):
    rng = np.random.RandomState(seed)
    scale = np.geomspace(5.0, 0.05, d)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    X = (rng.randn(n, d) * scale) @ basis + mean * rng.randn(d)
    return X.astype(np.float32)


def _memmap(tmp_path, X):
    path = str(tmp_path / "X.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)


def _fit_both(t, j, src):
    with jconfig.set(stream_block_rows=BLOCK, stream_mesh=1):
        j.fit(src)
    with config.set(stream_block_rows=BLOCK):
        t.fit(src)
    return t, j


def _close(t, j, comp_atol, rtol, attrs=SPECTRUM):
    np.testing.assert_allclose(t.components_, j.components_,
                               atol=comp_atol)
    for a in attrs:
        np.testing.assert_allclose(getattr(t, a), getattr(j, a), rtol=rtol,
                                   err_msg=a)


def _passes(est, n_passes, route="native"):
    tot = est.stream_stats_
    assert tot["passes"] == n_passes
    assert tot["reader_passes"] == {route: n_passes}


@pytest.mark.parametrize("nc", [5, None, 0.95])
def test_gram_matches_jax_and_resident(tmp_path, nc):
    X = _data(0)
    mm = _memmap(tmp_path, X)
    t, j = _fit_both(PCA(n_components=nc), JPCA(n_components=nc), mm)
    _passes(t, 1)
    assert t.n_components_ == j.n_components_ and t.fit_dtype_ == "float32"
    _close(t, j, 1e-6, 1e-6)
    np.testing.assert_allclose(t.mean_, j.mean_, atol=1e-6)
    assert t.noise_variance_ == pytest.approx(j.noise_variance_, rel=1e-5)
    r = PCA(n_components=nc, svd_solver="full").fit(X)
    _close(t, r, 1e-4, 1e-4)
    np.testing.assert_allclose(t.mean_, r.mean_, atol=1e-5)


def test_gram_bf16_matches_jax(tmp_path):
    """fit_dtype="bfloat16": f32 sums of exact bf16 products of the
    centered rows, as JAX's bf16 einsum with f32 results."""
    X = _data(1)
    mm = _memmap(tmp_path, X)
    t, j = _fit_both(PCA(n_components=4, fit_dtype="bfloat16"),
                     JPCA(n_components=4, fit_dtype="bfloat16"), mm)
    assert t.fit_dtype_ == j.fit_dtype_ == "bfloat16"
    _close(t, j, 1e-4, 1e-4)
    f32 = PCA(n_components=4).fit(X)
    assert not np.allclose(t.singular_values_, f32.singular_values_,
                           rtol=1e-7)


def test_randomized_pca_matches_jax_and_resident(tmp_path, jax_omega):
    X = _data(2)
    mm = _memmap(tmp_path, X)
    kw = dict(n_components=5, svd_solver="randomized", random_state=4,
              iterated_power=3)
    t, j = _fit_both(PCA(**kw), JPCA(**kw), mm)
    _passes(t, 1 + 3 + 1)
    _close(t, j, 1e-4, 1e-4)
    np.testing.assert_allclose(t.mean_, j.mean_, atol=1e-6)
    assert t.noise_variance_ == pytest.approx(j.noise_variance_, rel=1e-4)
    r = PCA(**kw).fit(X)
    _close(t, r, 1e-4, 1e-4)


@pytest.mark.parametrize("n_iter", [1, 4])
def test_truncated_svd_matches_jax_and_resident(tmp_path, jax_omega,
                                                n_iter):
    X = _data(3, mean=1.0)
    mm = _memmap(tmp_path, X)
    kw = dict(n_components=4, algorithm="randomized", random_state=2,
              n_iter=n_iter)
    t, j = _fit_both(TruncatedSVD(**kw), JTSVD(**kw), mm)
    _passes(t, 1 + n_iter + 1)
    _close(t, j, 1e-4, 1e-4)
    if n_iter == 4:
        # one power iteration leaves the range finder's own error (about
        # 5e-3 in the components here); four converge to the exact SVD
        r = TruncatedSVD(n_components=4, algorithm="tsqr").fit(X)
        _close(t, r, 1e-4, 1e-4, attrs=("singular_values_",))


def test_streamed_inference_equals_resident(tmp_path):
    """transform, fit_transform and score_samples stream a memmap (and a
    tall ndarray) and equal the resident port's."""
    X = _data(4, n=3000, d=12)
    mm = _memmap(tmp_path, X)
    p = PCA(n_components=3, whiten=True, svd_solver="full").fit(X)
    tsvd = TruncatedSVD(n_components=3).fit(X)
    ref_t = p.transform(X).to_numpy()
    ref_ll = p.score_samples(X)
    ref_s = tsvd.transform(X).to_numpy()
    for src in (mm, X):
        with config.set(stream_block_rows=BLOCK):
            got_t = p.transform(src)
            got_ll = p.score_samples(src)
            got_s = tsvd.transform(src)
        assert isinstance(got_t, np.ndarray) and got_t.shape == (3000, 3)
        np.testing.assert_allclose(got_t, ref_t, atol=1e-5)
        np.testing.assert_allclose(got_ll, ref_ll, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_s, ref_s, atol=1e-4)
    with config.set(stream_block_rows=BLOCK):
        ft = PCA(n_components=3, svd_solver="full").fit_transform(mm)
    np.testing.assert_allclose(
        np.abs(ft),
        np.abs(PCA(n_components=3, svd_solver="full").fit_transform(X)
               .to_numpy()), atol=1e-3)


def test_streamed_errors(tmp_path):
    X = _data(5, n=2000, d=8)
    mm = _memmap(tmp_path, X)
    with config.set(stream_block_rows=BLOCK):
        with pytest.raises(ValueError, match="algorithm='randomized'"):
            TruncatedSVD(n_components=2).fit(mm)
        with pytest.raises(ValueError, match="n_components"):
            TruncatedSVD(n_components=8, algorithm="randomized").fit(mm)
        with pytest.raises(ValueError, match="tall"):
            PCA().fit(mm[:4])


def test_block_products_in_row_chunks(tmp_path, monkeypatch, jax_omega):
    """A block's products run in chunks of rows (CHUNK_ROWS, 32,768 on
    the card, 128 here so each 700-row block takes six): the Gram and
    range fits still match JAX's one-product blocks, to the tolerances
    above."""
    from dask_ml_tpu_torch.models import pca, streamed_svd

    monkeypatch.setattr(pca, "CHUNK_ROWS", 128)
    monkeypatch.setattr(streamed_svd, "CHUNK_ROWS", 128)
    X = _data(6)
    mm = _memmap(tmp_path, X)
    t, j = _fit_both(PCA(n_components=5), JPCA(n_components=5), mm)
    _close(t, j, 1e-6, 1e-6)
    kw = dict(n_components=5, svd_solver="randomized", random_state=1)
    t, j = _fit_both(PCA(**kw), JPCA(**kw), mm)
    _close(t, j, 1e-4, 1e-4)
