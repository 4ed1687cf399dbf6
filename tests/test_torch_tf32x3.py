"""The 3xTF32 split of dask_ml_tpu_torch/csrc/tf32x3.cuh, emulated in plain
torch on the CPU: the only place its arithmetic can be checked before a
run on the card.

The kernels split each f32 operand as a = big + small with big =
tf32(a) and small = tf32(a - big), TF32 rounding to nearest with ties
away from zero on the 13 dropped mantissa bits (the bits of
cvt.rna.tf32.f32), and take every product as small_a big_b + big_a
small_b + big_a big_b in f32. The emulation lives here, not in the
package: the plain versions the CPU path runs stay exact f32. It is held
to float64 sums at chip_smoke.py's tolerances, and the resident Newton
and one-vs-rest lbfgs fits, their kernel calls replaced by the emulated
products, to dask_ml_tpu's fits as tests/test_torch_glm.py holds them.
"""

import numpy as np
import pytest
import torch

import dask_ml_tpu.linear_model as J
from chip_smoke import GLM_GRAD_RTOL, GLM_LOSS_RTOL, HESS_RTOL
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.models.solvers import solvers
from dask_ml_tpu_torch.models.solvers.families import get_family
from dask_ml_tpu_torch.ops import fused
import dask_ml_tpu_torch.linear_model as T
from tests.test_torch_glm import (
    COEF_ATOL, NEWTON_STALL, _data, _fit_multi, _multi_data,
)


def tf32(a):
    """f32 -> TF32 (as f32), round to nearest, ties away from zero."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(a):
    big = tf32(a)
    return big, tf32(a - big)


def mm3(a, b):
    """a @ b (f32) by the split: the three products, each exact in f32,
    added into one f32 sum in the kernels' order."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def vgh_emulated(x, n_valid, y, beta, family):
    """fused_glm_value_grad_hess with its Hessian products emulated: the
    row pass (eta, w, resid) and the gradient in f32 as on the CUDA
    cores, the Pallas kernel's x * w, the upper triangle mirrored."""
    n_valid = int(n_valid)
    fam = get_family(family)
    xv, yv = x[:n_valid], y[:n_valid].to(x.dtype)
    eta = xv @ beta.to(x.dtype)
    w = fam.hess_weight(eta, yv)
    h = mm3((xv * w[:, None]).T, xv)
    return (fam.pointwise(eta, yv).sum(), (fam.mean(eta) - yv) @ xv,
            torch.triu(h) + torch.triu(h, 1).T)


def multi_emulated(x, n_valid, codes, B, family):
    """fused_glm_multi_value_grad (f32 X) with both products emulated:
    eta = X B^T, then resid^T X."""
    n_valid = int(n_valid)
    fam = get_family(family)
    xv = x[:n_valid]
    Y = (codes[:n_valid, None].to(torch.int64)
         == torch.arange(B.shape[0])[None, :]).to(torch.float32)
    eta = mm3(xv, B.to(torch.float32).T)
    resid = fam.mean(eta) - Y
    return fam.pointwise(eta, Y).sum(), mm3(resid.T, xv)


def test_split_reconstructs_to_2_pow_minus_22():
    rng = np.random.RandomState(0)
    a = torch.from_numpy((rng.randn(200_000) * np.exp2(
        rng.randint(-60, 60, 200_000))).astype(np.float32))
    big, small = split(a)
    # both are TF32 values: the 13 dropped mantissa bits are zero
    for v in (big, small):
        assert not bool((v.view(torch.int32) & 0x1FFF).any())
    err = ((big.double() + small.double()) - a.double()).abs()
    assert bool((err <= a.double().abs() * 2.0 ** -22).all())


def test_tf32_rounds_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10   # a TF32 value; + half its ulp is a tie
    tie = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11)],
                       dtype=torch.float32)
    below = torch.tensor([one + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    assert tf32(tie).tolist() == [one + 2.0 ** -10, -(one + 2.0 ** -10)]
    assert tf32(below).tolist() == [one]


def test_tf32_products_are_exact_in_f32():
    rng = np.random.RandomState(1)
    a = tf32(torch.from_numpy(rng.randn(100_000).astype(np.float32)))
    b = tf32(torch.from_numpy(rng.randn(100_000).astype(np.float32)))
    assert torch.equal((a * b).double(), a.double() * b.double())


@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("n,d,n_valid", [(3000, 13, 2990), (391, 257, 350)])
def test_emulated_hessian_meets_float64(family, n, d, n_valid):
    X, y = _data(family, seed=n + d, n=n, d=d)
    x, yt = torch.from_numpy(X), torch.from_numpy(y)
    beta = torch.from_numpy(np.random.RandomState(d).randn(d).astype(
        np.float32)) / (4 * d ** 0.5)
    v, g, h = vgh_emulated(x, n_valid, yt, beta, family)
    v0, g0, h0 = fused.glm_value_grad_hess_plain(
        x.double(), n_valid, yt.double(), beta.double(), family)
    assert torch.equal(h, h.T)
    assert float((h.double() - h0).abs().max()) <= \
        HESS_RTOL * float(h0.abs().max())
    assert float((g.double() - g0).abs().max()) <= \
        GLM_GRAD_RTOL[torch.float32] * float(g0.abs().max())
    assert abs(float(v) - float(v0)) <= GLM_LOSS_RTOL * abs(float(v0))


@pytest.mark.parametrize("n,d,c,n_valid", [(3000, 13, 3, 2990),
                                           (391, 257, 10, 350)])
def test_emulated_multi_products_meet_float64(n, d, c, n_valid):
    rng = np.random.RandomState(n + c)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    codes = torch.from_numpy(rng.randint(0, c, n).astype(np.int32))
    B = torch.from_numpy(rng.randn(c, d).astype(np.float32)) / (4 * d ** 0.5)
    eta = mm3(x[:n_valid], B.T)
    eta0 = x[:n_valid].double() @ B.double().T
    assert float((eta.double() - eta0).abs().max()) <= \
        GLM_GRAD_RTOL[torch.float32] * float(eta0.abs().max())
    v, g = multi_emulated(x, n_valid, codes, B, "logistic")
    fam = get_family("logistic")
    Y = (codes[:n_valid, None].to(torch.int64)
         == torch.arange(c)[None, :]).double()
    v0 = fam.pointwise(eta0, Y).sum()
    g0 = (fam.mean(eta0) - Y).T @ x[:n_valid].double()
    assert abs(float(v) - float(v0)) <= GLM_LOSS_RTOL * abs(float(v0))
    assert float((g.double() - g0).abs().max()) <= \
        GLM_GRAD_RTOL[torch.float32] * float(g0.abs().max())


@pytest.fixture
def emulated(monkeypatch):
    """The port on the CPU with its Newton and one-vs-rest kernel calls
    replaced by the emulated products; yields their call counts."""
    calls = {"vgh": 0, "multi": 0}

    def vgh(*args):
        calls["vgh"] += 1
        return vgh_emulated(*args)

    def multi(*args):
        calls["multi"] += 1
        return multi_emulated(*args)

    monkeypatch.setattr(solvers, "fused_glm_value_grad_hess", vgh)
    monkeypatch.setattr(solvers, "fused_glm_multi_value_grad", multi)
    with config.set(device="cpu"):
        yield calls


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("family,J_est,T_est,seed", [
    ("logistic", J.LogisticRegression, T.LogisticRegression, 0),
    ("normal", J.LinearRegression, T.LinearRegression, 1),
    ("poisson", J.PoissonRegression, T.PoissonRegression, 1),
])
def test_newton_on_emulated_products_matches_jax(emulated, family, J_est,
                                                 T_est, seed, tol):
    X, y = _data(family, seed=seed)
    j = J_est(solver="newton", tol=tol).fit(X, y)
    t = T_est(solver="newton", tol=tol).fit(X, y)
    assert t.solver_info_["kernel"] == "fused_glm_value_grad_hess"
    assert emulated["vgh"] == t.n_iter_
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    if (family, tol) in NEWTON_STALL:
        assert t.n_iter_ == 100 > j.n_iter_
    else:
        assert t.n_iter_ == j.n_iter_


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("n_classes", [3, 4])
def test_ovr_lbfgs_on_emulated_products_matches_jax(emulated, n_classes,
                                                    tol):
    X, y = _multi_data(n_classes)
    j, t = _fit_multi("lbfgs", X, y, tol=tol)
    assert t.solver_info_["fused_multi"]
    assert t.solver_info_["kernel"] == "fused_glm_multi_value_grad"
    assert emulated["multi"] >= t.n_iter_ > 0
    np.testing.assert_allclose(t.coef_, j.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(t.intercept_, j.intercept_, atol=COEF_ATOL)
    assert t.n_iter_ == j.n_iter_
