"""The port's SGD step kernels (dask_ml_tpu_torch/ops/fused.py:
fused_sgd_block_grad, fused_sgd_many_block_grad) on the CPU, where each
wrapper runs its plain PyTorch version, held against the Pallas kernels
of dask_ml_tpu/ops/pallas_fused.py run with ``interpret=True``, at the
block shape of tests/test_precision.py::_sb_fixture (S = 256, d = 8).
The Pallas kernels multiply the rows past ``n_valid`` by a zero mask, so
they are compared on finite blocks; the port's plain versions are also
run on blocks whose rows past the count are NaN, which they must never
read. The CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: rtol 1e-5, of the loss and of the largest gradient entry (f32
sums of the same 256 terms in another order; with bf16 operands both
round x, w and the residual at the same points).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.ops.pallas_fused import (
    fused_sgd_block_grad as pl_sgd_block_grad,
    fused_sgd_many_block_grad as pl_sgd_many_block_grad,
)
from dask_ml_tpu_torch.ops import fused

RTOL = 1e-5
S, D = 256, 8
LOSSES = ["log_loss", "hinge", "squared_error"]


def _block(seed=7, s=S, d=D, n_classes=None):
    r = np.random.RandomState(seed)
    x = r.randn(s, d).astype(np.float32)
    if n_classes is None:
        y = (r.rand(s) > 0.5).astype(np.float32)
    else:
        y = r.randint(0, n_classes, s).astype(np.float32)
    return x, y


def _close(out, ref):
    """Loss (or per-row losses) and gradient within RTOL of the
    reference's scale."""
    loss, grad = (np.asarray(a, np.float64) for a in out)
    loss_r, grad_r = (np.asarray(a, np.float64) for a in ref)
    assert loss.shape == loss_r.shape and grad.shape == grad_r.shape
    np.testing.assert_allclose(loss, loss_r, rtol=RTOL,
                               atol=RTOL * np.abs(loss_r).max())
    scale = max(np.abs(grad_r).max(), 1e-30)
    assert np.abs(grad - grad_r).max() <= RTOL * scale, \
        (np.abs(grad - grad_r).max(), scale)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("iflag", [1.0, 0.0])
@pytest.mark.parametrize("n_valid", [S, 200, 0])
def test_sgd_block_grad_matches_pallas(loss, bf16, iflag, n_valid):
    x, y = _block()
    w = (np.random.RandomState(1).randn(D + 1) * 0.3).astype(np.float32)
    ref = pl_sgd_block_grad(jnp.asarray(x), n_valid, jnp.asarray(y),
                            jnp.asarray(w), iflag, loss,
                            mxu=jnp.bfloat16 if bf16 else None,
                            interpret=True)
    out = fused.fused_sgd_block_grad(torch.from_numpy(x), n_valid,
                                     torch.from_numpy(y), torch.from_numpy(w),
                                     iflag, loss,
                                     mxu=torch.bfloat16 if bf16 else None)
    assert out[1].shape == (D + 1,)
    _close(out, ref)
    if n_valid == 0:
        assert float(out[0]) == 0.0 and not out[1].any()


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("codes", [True, False])
@pytest.mark.parametrize("n_valid", [S, 200, 0])
def test_sgd_many_block_grad_matches_pallas(loss, bf16, codes, n_valid):
    N = 3
    x, y = _block(n_classes=N if codes else None)
    W = (np.random.RandomState(2).randn(N, D + 1) * 0.3).astype(np.float32)
    # codes=True: one intercept flag for the C rows; codes=False: a cohort
    # with its own flag per model
    iflags = np.float32(1.0) if codes else np.array([1.0, 0.0, 1.0],
                                                    np.float32)
    ref = pl_sgd_many_block_grad(jnp.asarray(x), n_valid, jnp.asarray(y),
                                 jnp.asarray(W), jnp.asarray(iflags), loss,
                                 codes=codes,
                                 mxu=jnp.bfloat16 if bf16 else None,
                                 interpret=True)
    out = fused.fused_sgd_many_block_grad(
        torch.from_numpy(x), n_valid, torch.from_numpy(y), torch.from_numpy(W),
        float(iflags) if codes else torch.from_numpy(iflags), loss, codes,
        mxu=torch.bfloat16 if bf16 else None)
    assert out[0].shape == (N,) and out[1].shape == (N, D + 1)
    _close(out, ref)


def _nan_tail(a, n_valid):
    a = a.copy()
    a[n_valid:] = np.nan
    return torch.from_numpy(a)


# S = 300 (no multiple of 128, which the Pallas kernels refuse): the plain
# versions on a block whose rows past n_valid hold NaN equal the same
# versions on the valid rows alone
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kernel", ["block", "many_codes", "many_shared"])
def test_sgd_kernels_never_read_the_stale_tail(loss, kernel):
    nv = 211
    x, y = _block(seed=5, s=300, n_classes=4 if kernel == "many_codes"
                  else None)
    r = np.random.RandomState(3)
    if kernel == "block":
        w = torch.from_numpy((r.randn(D + 1) * 0.3).astype(np.float32))
        out = fused.fused_sgd_block_grad(_nan_tail(x, nv), nv,
                                         _nan_tail(y, nv), w, 1.0, loss)
        ref = fused.sgd_block_grad_plain(torch.from_numpy(x[:nv]), nv,
                                         torch.from_numpy(y[:nv]), w, 1.0,
                                         loss)
    else:
        W = torch.from_numpy((r.randn(4, D + 1) * 0.3).astype(np.float32))
        codes = kernel == "many_codes"
        out = fused.fused_sgd_many_block_grad(_nan_tail(x, nv), nv,
                                              _nan_tail(y, nv), W, 1.0, loss,
                                              codes)
        ref = fused.sgd_many_block_grad_plain(torch.from_numpy(x[:nv]), nv,
                                              torch.from_numpy(y[:nv]), W,
                                              1.0, loss, codes)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hinge_tie_and_stable_softplus():
    """Hinge at a margin of exactly 1 has residual 0 (the Pallas kernel's
    strict <, which the CUDA kernel's header states); log_loss stays
    finite and exact past |eta| = 80."""
    eta = torch.tensor([1.0, -1.0, 0.5, 2.0])
    y = torch.tensor([1.0, 0.0, 1.0, 0.0])
    per, resid = fused.sgd_objective_terms(eta, y, "hinge")
    torch.testing.assert_close(per, torch.tensor([0.0, 0.0, 0.5, 3.0]))
    torch.testing.assert_close(resid, torch.tensor([0.0, 0.0, -1.0, 1.0]))
    eta = torch.tensor([100.0, -100.0, 90.0])
    y = torch.tensor([0.0, 1.0, 1.0])
    per, resid = fused.sgd_objective_terms(eta, y, "log_loss")
    assert torch.isfinite(per).all() and torch.isfinite(resid).all()
    torch.testing.assert_close(per, torch.tensor([100.0, 100.0, 0.0]))


def test_many_rows_equal_the_single_kernel():
    """Each row of the many-rows kernel (codes=False) is the single-row
    kernel on that row's weights and intercept flag."""
    x, y = _block(seed=9)
    W = torch.from_numpy((np.random.RandomState(4).randn(3, D + 1) * 0.3)
                         .astype(np.float32))
    iflags = torch.tensor([1.0, 0.0, 1.0])
    losses, grads = fused.fused_sgd_many_block_grad(
        torch.from_numpy(x), 200, torch.from_numpy(y), W, iflags, "log_loss",
        False)
    for i in range(3):
        loss, grad = fused.fused_sgd_block_grad(
            torch.from_numpy(x), 200, torch.from_numpy(y), W[i],
            float(iflags[i]), "log_loss")
        torch.testing.assert_close(losses[i], loss, rtol=1e-6, atol=0)
        torch.testing.assert_close(grads[i], grad, rtol=1e-6, atol=1e-6)


def test_refused_arguments_raise():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="loss"):
        fused.fused_sgd_block_grad(x, 4, torch.zeros(4), torch.zeros(4), 1.0,
                                   "modified_huber")
    with pytest.raises(ValueError, match="mxu"):
        fused.fused_sgd_many_block_grad(x, 4, torch.zeros(4),
                                        torch.zeros((2, 4)), 1.0, "hinge",
                                        True, mxu=torch.float16)
    with pytest.raises(ValueError, match="unknown SGD loss"):
        fused.sgd_objective_terms(torch.zeros(2), torch.zeros(2), "huber")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [13, 128, 256, 2000])
def test_multi_stream_geometry_adds_the_sgd_loss_column(d, bf16):
    """The SGD many-rows kernel (kernel 8) runs kernel 7's walks with one
    more column a weight row: its partials hold 1 + N (d + 2) floats (d
    features, the residual sums, the loss sums) where kernel 7's hold 1 +
    C (d + 1), in the same shared memory."""
    st = fused.multi_stream_geometry(d, bf16, intercept=True)
    sgd = fused.multi_stream_geometry(d, bf16, loss_col=True)
    assert st[:4] == sgd[:4] and st.smem == sgd.smem
    assert (fused.multi_stream_geometry(d, bf16).ldg, st.ldg, sgd.ldg) == \
        (d, d + 1, d + 2)
    assert fused.multi_stream_geometry(d, bf16, intercept=True,
                                       loss_col=True).ldg == d + 2
    assert sgd.smem <= fused.LLOYD_SMEM_MAX
    # at the main path's widths a CTA takes more than half of an SM's
    assert d < 128 or sgd.smem > fused.LLOYD_SMEM_MAX // 2
    # the main path's widths stage a row in one chunk
    assert (sgd.n_fc == 1) == (d <= fused.MULTI_MMA_ONE_CHUNK)
    assert "fused_sgd_many_block_grad" in fused.KERNELS
    assert "fused_sgd_block_grad" in fused.KERNELS
