"""The 3xTF32 split of dask_ml_tpu_torch/csrc/tf32x3.cuh, emulated in plain
torch on the CPU: the only place its arithmetic can be checked before a
run on the card.

The kernels split each f32 operand as a = big + small with big =
tf32(a) and small = tf32(a - big), TF32 rounding to nearest with ties
away from zero on the 13 dropped mantissa bits (the bits of
cvt.rna.tf32.f32), and take every product as small_a big_b + big_a
small_b + big_a big_b in f32 (a product with a factor exact in TF32,
such as a one-hot, as small_b + big_b). The emulation lives here, not in
the package: the plain versions the CPU path runs stay exact f32. It is
held to float64 sums at chip_smoke.py's tolerances, and the fits whose
kernel calls it replaces (resident Newton, one-vs-rest lbfgs and KMeans,
streamed one-vs-rest lbfgs, streamed KMeans, the ten-class SGDClassifier
and the batched-trial cohort step) to dask_ml_tpu's fits as the port's
own tests hold them. Products of bf16 operands are exact in f32, so the
bf16 flavours emulate as their plain versions (the streamed KMeans bf16
cross term as one product of the rounded operands).
"""

import numpy as np
import pytest
import torch

import dask_ml_tpu.linear_model as J
from chip_smoke import (
    GLM_GRAD_RTOL, GLM_LOSS_RTOL, HESS_RTOL, LLOYD_INERTIA_RTOL,
    LLOYD_SUMS_RTOL, check_block_stats, check_lloyd, check_sgd, hinge_slack,
)
from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.models import sgd as JS
from dask_ml_tpu.ops.pallas_fused import (
    fused_assign_update as pl_assign_update,
    fused_glm_multi_stream as pl_glm_multi_stream,
    fused_kmeans_block_stats as pl_kmeans_block_stats,
    fused_lloyd_stats as pl_lloyd_stats,
    fused_sgd_many_block_grad as pl_sgd_many_block_grad,
)
import jax.numpy as jnp
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.models import kmeans
from dask_ml_tpu_torch.models import sgd as TS
from dask_ml_tpu_torch.models.solvers import solvers, streamed
from dask_ml_tpu_torch.models.solvers.families import get_family
from dask_ml_tpu_torch.ops import fused
import dask_ml_tpu_torch.linear_model as T
from tests.test_torch_glm import (
    COEF_ATOL, NEWTON_STALL, _data, _fit_multi, _multi_data,
)
from tests.test_torch_stream_glm import (
    TOL as STREAM_TOL, _assert_close, _both, _data as _stream_data,
)
from tests.test_torch_stream_kmeans import (
    BLOCK as KM_BLOCK, _assert_same_fit, _data as _km_data,
)
from tests.test_torch_sgd import _jax, _same_model
from tests.test_torch_wrappers import _cohort, _same


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


def mm_exact_a(a, b):
    """a @ b with every entry of a exact in TF32 (a one-hot): b's small
    then big part, the two products of csrc/lloyd.cu's sums."""
    bb, bs = split(b)
    return a @ bs + a @ bb


def lloyd_emulated(x, mask, n_rows, centers, mxu=None):
    """csrc/lloyd.cu's tensor-core pass (fused_assign_update; with mask
    None, fused_lloyd_stats' rows < n_rows, which is also
    fused_kmeans_block_stats' pass over a block's rows < n_valid) with
    its products emulated: the cross term x c^T by the split, ||x||^2
    and ||c||^2 in f32, d2 = max(||x||^2 - 2 x.c + ||c||^2, 0), the first
    minimum, the sums as onehot^T X (mm_exact_a), int32 counts.
    ``mxu=torch.bfloat16`` (the streamed bf16 cross term): x and the
    centers rounded to bf16 for the cross term only, one exact product
    each, summed in f32; the norms from the unrounded values. Returns
    (labels, masked min-d2, sums, counts, inertia)."""
    xv, c = x[:n_rows], centers.to(torch.float32)
    if mxu is None:
        cross = mm3(xv, c.T)
    else:
        cross = xv.to(mxu).float() @ c.to(mxu).float().T
    d2 = ((xv * xv).sum(1)[:, None] - 2.0 * cross
          + (c * c).sum(1)[None, :]).clamp_min(0.0)
    labels = d2.argmin(1)
    mind = d2.gather(1, labels[:, None])[:, 0]
    w = (torch.ones(n_rows) if mask is None
         else (mask[:n_rows] > 0).to(torch.float32))
    onehot = torch.zeros((n_rows, c.shape[0])).scatter_(
        1, labels[:, None], w[:, None])
    counts = torch.bincount(labels[w > 0], minlength=c.shape[0])
    return (labels.to(torch.int32), mind * w, mm_exact_a(onehot.T, xv),
            counts.to(torch.int32), (mind * w).sum())


def block_stats_emulated(x, n_valid, centers, mxu=None, acc=None):
    """fused_kmeans_block_stats with the tensor-core pass emulated
    (lloyd_emulated over the rows < n_valid), added into ``acc`` when
    given, as the wrapper does."""
    out = lloyd_emulated(x, None, int(n_valid), centers, mxu)[2:]
    if acc is None:
        return out
    acc[0].add_(out[0])
    acc[1].add_(out[1])
    acc[2].add_(out[2])
    return acc[0], acc[1], acc[2][0]


def sgd_many_emulated(x, n_valid, y, W_ext, iflags, loss, codes, mxu=None):
    """fused_sgd_many_block_grad with its f32 products emulated: eta = X
    W^T + b0 by the split, the SGD loss's terms, the gradient resid^T X
    by the split, the intercepts' column the unrounded residual sums and
    the per-row losses (the kernel's loss column); bf16 operands make
    exact products, so mxu is the plain version."""
    if mxu is not None:
        return fused.sgd_many_block_grad_plain(x, n_valid, y, W_ext, iflags,
                                               loss, codes, mxu)
    n_valid = int(n_valid)
    W = W_ext.to(torch.float32)
    N = W.shape[0]
    xv, yv = x[:n_valid], y[:n_valid].to(torch.float32)
    eta = mm3(xv, W[:, :-1].T) + (W[:, -1] * iflags)[None, :]
    Y = (yv[:, None] == torch.arange(N, dtype=torch.float32)[None, :]
         ).to(torch.float32) if codes else yv[:, None].expand(-1, N)
    per, resid = fused.sgd_objective_terms(eta, Y, loss)
    return per.sum(0), torch.cat([mm3(resid.T, xv),
                                  resid.sum(0)[:, None]], 1)


def multi_stream_emulated(kind, x, n_valid, y_codes, B, family, intercept,
                          mxu=None, acc=None):
    """fused_glm_multi_stream with its f32 products emulated (eta = X B^T
    + b0, then resid^T X; the intercepts' column the unrounded residual
    sums); bf16 operands make exact products, so mxu is the plain
    version."""
    if mxu is not None:
        return fused.glm_multi_stream_plain(kind, x, n_valid, y_codes, B,
                                            family, intercept, mxu, acc)
    n_valid, fam, C = int(n_valid), get_family(family), B.shape[0]
    xv = x[:n_valid]
    Bm = B[:, :-1] if intercept else B
    Y = (y_codes[:n_valid, None].to(torch.float32)
         == torch.arange(C, dtype=torch.float32)[None, :]).to(torch.float32)
    eta = mm3(xv, Bm.T)
    if intercept:
        eta = eta + B[:, -1][None, :]
    outs = [fam.pointwise(eta, Y).sum()]
    if kind == "vg":
        resid = fam.mean(eta) - Y
        grad = mm3(resid.T, xv)
        if intercept:
            grad = torch.cat([grad, resid.sum(0)[:, None]], 1)
        outs.append(grad)
    if acc is not None:
        return fused._add_into(fused.glm_multi_stream_views(
            kind, acc, x.shape[1], C, intercept), outs)
    return tuple(outs)


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


def _lloyd_data(kind, n, d, k, seed):
    """Gaussian rows and centers drawn from them, or blobs around k
    centers 8 apart in each coordinate with the centers seeded near
    them."""
    rng = np.random.RandomState(seed)
    if kind == "gauss":
        x = rng.randn(n, d).astype(np.float32)
        return x, x[rng.permutation(n)[:k]].copy()
    c = (8.0 * rng.randn(k, d)).astype(np.float32)
    x = (c[np.arange(n) % k] + rng.randn(n, d)).astype(np.float32)
    return x, (c + 0.5 * rng.randn(k, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["gauss", "blobs"])
@pytest.mark.parametrize("n,d,k,n_valid", [(3000, 13, 5, 2990),
                                           (1000, 128, 64, 1000),
                                           (777, 35, 70, 700)])
def test_emulated_lloyd_meets_float64_and_pallas(kind, n, d, k, n_valid):
    """The pass at chip_smoke.py's Lloyd tolerances (check_lloyd: labels
    equal but on near-ties, min-d2 to LLOYD_MIND_RTOL of the row's norms,
    sums to LLOYD_SUMS_RTOL, inertia to LLOYD_INERTIA_RTOL) against the
    float64 pass and against the Pallas kernels run with interpret=True."""
    xn, cn = _lloyd_data(kind, n, d, k, n + k)
    x, c = torch.from_numpy(xn), torch.from_numpy(cn)
    mask = (torch.arange(n) < n_valid).to(torch.float32)
    out = lloyd_emulated(x, mask, n, c)
    xv = x[:n_valid]
    rows = tuple(v[:n_valid] for v in out[:2]) + out[2:]
    f64 = fused.assign_update_plain(x.double(), mask.double(), c.double())
    check_lloyd(xv, c, *rows, tuple(v[:n_valid] if i < 2 else v
                                    for i, v in enumerate(f64)))
    ref = [torch.from_numpy(np.array(v)) for v in pl_assign_update(
        xn, mask.numpy(), cn, interpret=True)]
    check_lloyd(xv, c, *rows, (ref[0][:n_valid], ref[1][:n_valid], ref[2],
                               ref[3].to(torch.int32), ref[4]))
    # the stats flavour: the rows < n_valid, no mask
    sums, counts, inertia = lloyd_emulated(x, None, n_valid, c)[2:]
    s_ref, n_ref, i_ref = (np.asarray(v) for v in pl_lloyd_stats(
        xn, n_valid, cn, interpret=True))
    assert torch.equal(counts, out[3])
    np.testing.assert_array_equal(counts.numpy(), n_ref.astype(np.int64))
    # check_lloyd's scale: the summed |x| of each cluster's rows
    scale = torch.zeros(k, dtype=torch.float64).index_add_(
        0, out[0][:n_valid].long(), xv.double().abs().sum(1))[:, None]
    assert float(((sums.double() - torch.from_numpy(s_ref).double()).abs()
                  / scale.clamp_min(1.0)).max()) <= LLOYD_SUMS_RTOL
    assert abs(float(inertia) - float(i_ref)) <= \
        LLOYD_INERTIA_RTOL * abs(float(i_ref))


@pytest.fixture
def emulated_lloyd(monkeypatch):
    """The port's KMeans on the CPU with both Lloyd kernels replaced by
    the emulated pass; yields their call counts."""
    calls = {"stats": 0, "assign": 0}

    def stats(x, n_valid, centers):
        calls["stats"] += 1
        return lloyd_emulated(x, None, int(n_valid), centers)[2:]

    def assign(x, mask, centers):
        calls["assign"] += 1
        return lloyd_emulated(x, mask, x.shape[0], centers)

    monkeypatch.setattr(kmeans, "fused_lloyd_stats", stats)
    monkeypatch.setattr(kmeans, "fused_assign_update", assign)
    with config.set(device="cpu"):
        yield calls


@pytest.mark.parametrize("seed,n,d,k", [(0, 2000, 6, 4), (1, 4096, 16, 8),
                                        (2, 777, 3, 5)])
def test_kmeans_on_emulated_stats_matches_jax(emulated_lloyd, seed, n, d, k):
    """tests/test_torch_kmeans.py's resident fit with the emulated pass:
    equal labels and n_iter_, centers within 1e-3."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[: n // 2] += 3.0
    init = X[:k].copy()
    j = JKMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    t = KMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    assert t.kernel_info_["kernel"] == "fused_lloyd_stats"
    assert emulated_lloyd == {"stats": t.n_iter_, "assign": 1}
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               atol=1e-3)
    np.testing.assert_array_equal(t.labels_.to_numpy(),
                                  j.labels_.to_numpy())
    assert t.n_iter_ == j.n_iter_


def _nan_tail(a, n_valid):
    a = a.copy()
    a[n_valid:] = np.nan
    return torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["val", "vg"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("n_classes", [3, 10])
def test_emulated_multi_stream_matches_plain_and_pallas(kind, bf16,
                                                        intercept, n_classes):
    """A ragged block (rows past 300 of 384 NaN in the port's copy):
    the loss to GLM_LOSS_RTOL, the gradient (its intercepts' column too)
    to GLM_GRAD_RTOL of its largest entry, against the plain version and
    the Pallas kernel run with interpret=True."""
    rng = np.random.RandomState(n_classes + 7)
    S, d, n_valid = 384, 21, 300
    X = rng.randn(S, d).astype(np.float32)
    codes = rng.randint(0, n_classes, S).astype(np.float32)
    B = (rng.randn(n_classes, d + int(intercept)) * 0.2).astype(np.float32)
    mxu = torch.bfloat16 if bf16 else None
    out = multi_stream_emulated(kind, _nan_tail(X, n_valid), n_valid,
                                _nan_tail(codes, n_valid),
                                torch.from_numpy(B), "logistic", intercept,
                                mxu=mxu)
    plain = fused.glm_multi_stream_plain(
        kind, torch.from_numpy(X), n_valid, torch.from_numpy(codes),
        torch.from_numpy(B), "logistic", intercept, mxu=mxu)
    ref = pl_glm_multi_stream(kind, X, n_valid, codes, B, "logistic",
                              intercept, mxu=jnp.bfloat16 if bf16 else None,
                              interpret=True)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for r in (plain, [torch.from_numpy(np.array(v)) for v in ref]):
        assert len(out) == len(r)
        assert abs(float(out[0]) - float(r[0])) <= \
            GLM_LOSS_RTOL * abs(float(r[0]))
        if kind == "vg":
            assert out[1].shape == (n_classes, d + int(intercept))
            assert float((out[1].double() - r[1].double()).abs().max()) \
                <= GLM_GRAD_RTOL[dtype] * float(r[1].abs().max())


def test_ovr_streamed_lbfgs_on_emulated_products_matches_jax(monkeypatch):
    """tests/test_torch_stream_glm.py's streamed one-vs-rest lbfgs fit
    with the emulated kernel: coefficients within its 5e-4, equal
    iteration and pass counts."""
    calls = []

    def multi(*args, **kw):
        calls.append(args[0])
        return multi_stream_emulated(*args, **kw)

    monkeypatch.setattr(streamed, "fused_glm_multi_stream", multi)
    X, y = _stream_data("logistic", seed=3, n_classes=3)
    with config.set(device="cpu"):
        j, t = _both("LogisticRegression", X, y, solver="lbfgs",
                     tol=STREAM_TOL["lbfgs"], max_iter=60)
    assert t.solver_info_["fused_stream"]
    assert len(calls) == t.solver_info_["data_passes"] * 5 > 0
    _assert_close(t, j)
    assert t.n_iter_ == j.n_iter_
    assert t.solver_info_["data_passes"] == j.solver_info_["data_passes"]


@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error"])
@pytest.mark.parametrize("codes", [True, False])
@pytest.mark.parametrize("n_valid", [256, 200, 0])
def test_emulated_sgd_many_meets_float64_and_pallas(loss, codes, n_valid):
    """A block of 256 rows of 37 features (rows past n_valid NaN in the
    port's copy) and N = 10 weight rows (class codes, or one y shared by
    a cohort with its own intercept flags): each row's loss to
    GLM_LOSS_RTOL of the largest, the gradient (its intercepts' column
    too) to GLM_GRAD_RTOL of its largest entry plus hinge's slack for
    margins within HINGE_TIE_RTOL of 1 (chip_smoke.check_sgd), against
    the float64 plain version and the Pallas kernel run with
    interpret=True."""
    rng = np.random.RandomState(11 + n_valid)
    S, d, N = 256, 37, 10
    x = rng.randn(S, d).astype(np.float32)
    y = (rng.randint(0, N, S) if codes else rng.rand(S) < 0.5
         ).astype(np.float32)
    if loss == "squared_error" and not codes:
        y = rng.randn(S).astype(np.float32)
    W = (rng.randn(N, d + 1) * 0.3).astype(np.float32)
    iflags = np.float32(1.0) if codes else \
        (np.arange(N) % 3 != 2).astype(np.float32)
    it = float(iflags) if codes else torch.from_numpy(iflags)
    out = sgd_many_emulated(_nan_tail(x, n_valid), n_valid,
                            _nan_tail(y, n_valid), torch.from_numpy(W), it,
                            loss, codes)
    assert out[0].shape == (N,) and out[1].shape == (N, d + 1)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    if n_valid == 0:
        assert not out[0].any() and not out[1].any()
        return
    xt, yt, Wt = (torch.from_numpy(a) for a in (x, y, W))
    it64 = it if codes else it.double()
    f64 = fused.sgd_many_block_grad_plain(xt.double(), n_valid, yt.double(),
                                          Wt.double(), it64, loss, codes)
    ref = pl_sgd_many_block_grad(jnp.asarray(x), n_valid, jnp.asarray(y),
                                 jnp.asarray(W), jnp.asarray(iflags), loss,
                                 codes=codes, interpret=True)
    slack = hinge_slack(xt, n_valid, yt, Wt, it, codes, None)[0] \
        if loss == "hinge" else 0.0
    for r in (f64, [torch.from_numpy(np.array(v)) for v in ref]):
        check_sgd(out, r, torch.float32, slack)


def test_emulated_sgd_many_loss_column_is_the_rows_sums():
    """The per-row losses (the kernel's column d + 1) add up to the
    block's loss, and at a margin of exactly 1 hinge's residual is 0, as
    in the Pallas kernel (the emulated split is exact there: x and W are
    small integers)."""
    x = torch.tensor([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0]])
    y = torch.tensor([1.0, 0.0, 1.0])
    W = torch.tensor([[1.0, 0.0, 0.0], [0.5, 0.5, 0.0]])
    losses, grads = sgd_many_emulated(x, 3, y, W, 1.0, "hinge", False)
    # model 0: margins 1, 0, 1 -> losses 0, 1, 0; only row 1 has a residual
    # (+1: its sign is -1); model 1: margins 0.5, -1, 1 -> 0.5, 2, 0
    torch.testing.assert_close(losses, torch.tensor([1.0, 2.5]))
    torch.testing.assert_close(grads[0], torch.tensor([0.0, 2.0, 1.0]))
    torch.testing.assert_close(grads[1], torch.tensor([-1.0, 2.0, 0.0]))
    plain = fused.sgd_many_block_grad_plain(x, 3, y, W, 1.0, "hinge", False)
    assert all(torch.equal(a, b) for a, b in zip(plain, (losses, grads)))


@pytest.fixture
def emulated_sgd(monkeypatch):
    """The port's SGD on the CPU with its many-rows kernel replaced by
    the emulated products; yields the number of calls."""
    calls = []

    def many(*args):
        calls.append(args[6])
        return sgd_many_emulated(*args)

    monkeypatch.setattr(TS, "fused_sgd_many_block_grad", many)
    with config.set(device="cpu"):
        yield calls


def test_ten_class_sgd_on_emulated_products_matches_jax(emulated_sgd):
    """tests/test_torch_sgd.py's multiclass fit with ten classes on the
    emulated kernel: coef_ and intercept_ within its COEF_ATOL of
    dask_ml_tpu's, equal step clocks, n_iter_ and predictions; one launch
    a block a pass, all with class codes."""
    rng = np.random.RandomState(4)
    X = rng.randn(3000, 12).astype(np.float32)
    y = np.argmax(X @ rng.randn(12, 10) + rng.randn(3000, 10), 1
                  ).astype(np.float32)
    kw = dict(loss="log_loss", penalty="elasticnet", alpha=1e-3, eta0=0.02,
              max_iter=3, random_state=3)
    j = _jax(lambda: JS.SGDClassifier(**kw).fit(X, y))
    t = TS.SGDClassifier(**kw).fit(X, y)
    assert t.coef_.shape == (10, 12)
    assert len(emulated_sgd) == t._t > 0 and all(emulated_sgd)
    _same_model(j, t, X)


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_cohort_step_on_emulated_products_matches_jax(emulated_sgd, kind):
    """tests/test_torch_wrappers.py's batched-trial step (four models of
    one batch key, a ragged block visited twice) on the emulated kernel:
    each model within COEF_ATOL of dask_ml_tpu's cohort, equal step
    clocks; one shared-target launch a step."""
    from tests.test_torch_wrappers import _data as _w_data

    X, y = _w_data(kind, seed=5, n=2000)
    blocks = [(X[lo:lo + 450], y[lo:lo + 450]) for lo in range(0, 2000, 450)]
    order = [0, 4, 1, 4, 2, 3]
    jm, tm = _cohort(kind)
    _jax(lambda: type(jm[0])._batched_fused_calls(jm, blocks, order))
    type(tm[0])._batched_fused_calls(tm, blocks, order)
    type(tm[0])._batch_publish(tm, X.shape[1])
    assert emulated_sgd == [False] * len(order)
    for j, t in zip(jm, tm):
        j._publish(X.shape[1])
        _same(j, t)


@pytest.mark.parametrize("mxu", [None, torch.bfloat16])
@pytest.mark.parametrize("kind", ["gauss", "blobs"])
# block heights that are multiples of 128, as the Pallas kernel takes them
@pytest.mark.parametrize("n,d,k,n_valid", [(3072, 13, 5, 2990),
                                           (1024, 128, 64, 1000),
                                           (768, 35, 70, 700)])
def test_emulated_block_stats_meet_float64_and_pallas(mxu, kind, n, d, k,
                                                      n_valid):
    """The streamed block's statistics (rows past n_valid NaN in the
    port's copy), f32 and bf16 cross terms, at chip_smoke.py's rule
    (check_block_stats: counts apart only on near-ties, sums to
    LLOYD_SUMS_RTOL of their scale, inertia to LLOYD_INERTIA_RTOL)
    against the float64 statistics of the same rounding points and
    against the Pallas kernel run with interpret=True; added into an
    accumulator, twice the block's."""
    xn, cn = _lloyd_data(kind, n, d, k, n + k + d)
    x, c = torch.from_numpy(xn), torch.from_numpy(cn)
    out = block_stats_emulated(_nan_tail(xn, n_valid), n_valid, c, mxu)
    assert out[1].dtype == torch.int32
    # float64: the cross term of the same (rounded) operands, norms and
    # sums of the f32 values
    xv, cd = x[:n_valid].double(), c.double()
    xr, cr = (xv, cd) if mxu is None else \
        (x[:n_valid].to(mxu).double(), c.to(mxu).double())
    d2 = ((xv * xv).sum(1)[:, None] - 2.0 * xr @ cr.T
          + (cd * cd).sum(1)[None, :]).clamp_min(0.0)
    lab = d2.argmin(1)
    f64 = (torch.zeros((k, d), dtype=torch.float64).index_add_(0, lab, xv),
           torch.bincount(lab, minlength=k), d2.min(1).values.sum())
    check_block_stats(x, n_valid, c, mxu, out, f64)
    ref = [torch.from_numpy(np.array(v)) for v in pl_kmeans_block_stats(
        xn, n_valid, cn, mxu=jnp.bfloat16 if mxu is not None else None,
        interpret=True)]
    check_block_stats(x, n_valid, c, mxu, out,
                      (ref[0], ref[1].round().to(torch.int32), ref[2]))
    acc = fused.kmeans_stream_acc(k, d, "cpu")
    block_stats_emulated(x, n_valid, c, mxu, acc)
    twice = block_stats_emulated(x, n_valid, c, mxu, acc)
    assert torch.equal(twice[1], 2 * out[1])
    torch.testing.assert_close(twice[0], 2 * out[0], rtol=0, atol=0)


@pytest.mark.parametrize("seed,n,d,k", [(0, 2000, 6, 4), (1, 3001, 16, 8),
                                        (2, 777, 3, 5)])
def test_streamed_kmeans_on_emulated_stats_matches_jax(monkeypatch, seed, n,
                                                       d, k):
    """tests/test_torch_stream_kmeans.py's streamed fit with the emulated
    block statistics: centers within 1e-3, inertia rel 1e-4, labels and
    n_iter_ equal to dask_ml_tpu's under stream_mesh=1; one launch a
    block a pass."""
    calls = []

    def stats(*args, **kw):
        calls.append(1)
        return block_stats_emulated(*args, **kw)

    monkeypatch.setattr(kmeans, "fused_kmeans_block_stats", stats)
    X, init = _km_data(seed, n, d, k)
    with jconfig.set(stream_block_rows=KM_BLOCK, stream_mesh=1):
        j = JKMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    with config.set(device="cpu", stream_block_rows=KM_BLOCK):
        t = KMeans(n_clusters=k, init=init, max_iter=50).fit(X)
    assert t.kernel_info_["kernel"] == "fused_kmeans_block_stats"
    assert len(calls) == -(-n // KM_BLOCK) * t.n_iter_
    _assert_same_fit(t, j)
