"""The port's tall-skinny QR and randomized SVD (``ops/linalg.py``)
against ``dask_ml_tpu.ops.linalg`` on one-device inputs, on the CPU.

QR and SVD factors are unique up to signs, and LAPACK's signs differ
between the two packages' routes (JAX's TSQR takes a second QR of R), so
factors are compared after the V-based ``svd_flip``, or through products
that do not see the signs (Q R, |R|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu.ops import linalg as jlinalg
from dask_ml_tpu.parallel.mesh import device_mesh
from dask_ml_tpu_torch.ops import linalg


@pytest.fixture(scope="module")
def mesh1():
    return device_mesh(devices=jax.devices()[:1])


def _tall(seed, n, d, decay=True):
    rng = np.random.RandomState(seed)
    scale = np.geomspace(10.0, 0.05, d) if decay else np.ones(d)
    X = (rng.randn(n, d) * scale) @ np.linalg.qr(rng.randn(d, d))[0]
    return X.astype(np.float32)


def _flip_np(u, vt):
    i = np.argmax(np.abs(vt), axis=1)
    s = np.sign(vt[np.arange(len(vt)), i])
    return u * s[None, :], vt * s[:, None]


@pytest.mark.parametrize("n,d", [(2000, 8), (3001, 40), (64, 64)])
def test_tsqr_factors(n, d, mesh1):
    """Q R equals X (f32, 1e-5 of |X|), Q is orthonormal (1e-5), R is
    upper triangular and |R| equals JAX's |R| to 1e-4 of its scale."""
    X = _tall(n, n, d)
    q, r = linalg.tsqr(torch.from_numpy(X))
    q, r = q.numpy(), r.numpy()
    assert q.shape == (n, d) and r.shape == (d, d)
    np.testing.assert_allclose(q @ r, X, atol=1e-5 * np.abs(X).max())
    np.testing.assert_allclose(q.T @ q, np.eye(d), atol=1e-5)
    assert np.all(np.tril(r, -1) == 0)
    _, jr = jlinalg.tsqr(jnp.asarray(X), mesh1)
    np.testing.assert_allclose(np.abs(r), np.abs(np.asarray(jr)),
                               atol=1e-4 * np.abs(r).max())
    _, r_only = linalg.tsqr(torch.from_numpy(X), mode="r")
    np.testing.assert_allclose(r_only.numpy(), r, atol=1e-6 * np.abs(r).max())


def test_tsqr_zero_padding_rows():
    """Zero rows appended to X leave R unchanged and get zero rows of
    Q: the invariant the padded callers rely on."""
    X = _tall(5, 1000, 12)
    Xp = np.concatenate([X, np.zeros((24, 12), np.float32)])
    q, r = linalg.tsqr(torch.from_numpy(X))
    qp, rp = linalg.tsqr(torch.from_numpy(Xp))
    np.testing.assert_allclose(np.abs(rp.numpy()), np.abs(r.numpy()),
                               atol=1e-5 * float(r.abs().max()))
    assert float(qp[1000:].abs().max()) <= 1e-6
    np.testing.assert_allclose((qp @ rp).numpy(), Xp,
                               atol=1e-5 * np.abs(X).max())


@pytest.mark.parametrize("n,d", [(2000, 8), (4000, 33)])
def test_svd_tall_matches_jax(n, d, mesh1):
    """s to 1e-5 relative, flipped Vt to 1e-4 and flipped U to 1e-3 (U's
    columns of the smallest singular values carry X's f32 noise over s)
    of JAX's svd_tall, and U S Vt equals X; without U the same s and
    Vt."""
    X = _tall(n + d, n, d)
    u, s, vt = linalg.svd_tall(torch.from_numpy(X))
    u, vt = linalg.svd_flip(u, vt)
    ju, js, jvt = jlinalg.svd_tall(jnp.asarray(X), mesh1)
    ju, jvt = jlinalg.svd_flip(ju, jvt)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), atol=1e-4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-3)
    np.testing.assert_allclose((u * s[None, :]) @ vt, X,
                               atol=1e-5 * np.abs(X).max())
    none, s2, vt2 = linalg.svd_tall(torch.from_numpy(X), compute_u=False)
    assert none is None
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.abs(vt2.numpy()), np.abs(vt.numpy()),
                               atol=1e-5)


def test_svd_flip_matches_jax_and_numpy():
    """V-based signs: each row of Vt has its largest-|.| entry positive,
    U's columns follow; equal to JAX's flip and a numpy one; a zero row
    keeps its sign."""
    rng = np.random.RandomState(7)
    u = rng.randn(50, 6).astype(np.float32)
    vt = rng.randn(6, 9).astype(np.float32)
    vt[2] = 0.0
    tu, tvt = linalg.svd_flip(torch.from_numpy(u), torch.from_numpy(vt))
    ju, jvt = jlinalg.svd_flip(jnp.asarray(u), jnp.asarray(vt))
    nu, nvt = _flip_np(u, vt)
    nvt[2] = 0.0
    np.testing.assert_array_equal(tvt.numpy(), np.asarray(jvt))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tvt.numpy(), nvt)
    assert linalg.svd_flip(None, torch.from_numpy(vt))[0] is None


@pytest.mark.parametrize("n,d,k,n_iter", [(3000, 24, 5, 4), (2000, 64, 8, 2),
                                          (500, 16, 16, 1)])
def test_randomized_svd_with_jax_omega(n, d, k, n_iter, mesh1):
    """With JAX's Ω injected, the range finder follows JAX's step for
    step: s to 1e-4 relative and the flipped Vt to 1e-3 of
    randomized_svd_jit's (f32 QRs and products in another order)."""
    X = _tall(n, n, d)
    key = jax.random.PRNGKey(3)
    size = min(k + 10, d)
    omega = np.array(jax.random.normal(key, (d, size), jnp.float32))
    u, s, vt = linalg.randomized_svd(torch.from_numpy(X), k, n_iter=n_iter,
                                     omega=torch.from_numpy(omega))
    u, vt = linalg.svd_flip(u, vt)
    ju, js, jvt = jlinalg.randomized_svd_jit(jnp.asarray(X), k, key, mesh1,
                                             n_iter=n_iter)
    ju, jvt = jlinalg.svd_flip(ju, jvt)
    assert u.shape == (n, k) and s.shape == (k,) and vt.shape == (k, d)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), atol=1e-3)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-3)


def test_randomized_svd_own_draw_is_seeded():
    """Without an injected Ω the draw comes from ``random_state``: one
    seed gives the same factors twice, and on a decaying spectrum the
    top singular values agree with the exact SVD to 1e-4."""
    X = _tall(11, 3000, 32)
    t = torch.from_numpy(X)
    a = linalg.randomized_svd(t, 6, random_state=5)
    b = linalg.randomized_svd(t, 6, random_state=5)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    exact = np.linalg.svd(X.astype(np.float64), compute_uv=False)[:6]
    np.testing.assert_allclose(a[1].numpy(), exact, rtol=1e-4)
    omega = linalg.draw_omega(32, 16, 5, torch.device("cpu"))
    assert omega.shape == (32, 16) and omega.dtype == torch.float32
