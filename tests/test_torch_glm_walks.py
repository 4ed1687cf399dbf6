"""The walks of csrc/glm_value_grad.cu (kernels 1, 5 and 6 "val"/"vg") as
ops/fused.py::glm_value_walk picks them, on the CPU: a pure rule on the
shape that the three wrappers follow. The main paths' shapes keep the
registers walk (bit-equal to the builds before the staged and narrow
walks: kernel 1 f32 at d = 257, kernels 5 and 6 at d = 256); bf16 X at
every width and f32 rows from the measured cut (d = 4097) take the
staged walk, and f32 rows of at most 128 features the narrow walk. Each
walk's CTAs and shared memory stay within the partials' budget and an
H100 SM. The walks run only on the card (tests/test_torch_cuda.py); here
kernel 5's plain version, which the card's walks are held to, is held to
the Pallas kernel on a block that is a row view starting off a 16-byte
boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.ops.pallas_fused import (
    fused_sgd_block_grad as pl_sgd_block_grad,
)
from dask_ml_tpu_torch.ops import fused

F32, BF16 = torch.float32, torch.bfloat16
MODES = ("resident", "val", "vg", "vg_bf16")
SMS = 132  # an H100's SMs


@pytest.mark.parametrize("d,dtype,mode", [
    (257, F32, "resident"),   # kernel 1, the lbfgs and Newton main paths
    (256, F32, "val"), (256, F32, "vg"), (256, F32, "vg_bf16"),  # kernel 6
    (256, F32, "vg"), (256, F32, "vg_bf16"),  # kernel 5 at phase 4's block
    (129, F32, "resident"), (3073, F32, "resident"), (4096, F32, "vg")])
def test_main_path_shapes_keep_the_registers_walk(d, dtype, mode):
    walk = fused.glm_value_walk(d, dtype, mode)
    assert walk.walk == "registers"
    # the registers walk's n_part rule of the builds before: one CTA per
    # GLM_BLOCK_ROWS rows, 4 an SM
    assert (walk.unit_rows, walk.per_sm) == (fused.GLM_BLOCK_ROWS, 4)
    for n_valid in (0, 5, 4_000_000):
        assert fused.glm_walk_n_part(walk, n_valid, d + 2, SMS) == max(
            1, min(-(-n_valid // 16), 4 * SMS,
                   max(SMS, fused.PARTIAL_FLOATS // (d + 2))))


@pytest.mark.parametrize("d", [1, 7, 13, 257, 600, 1025, 4097, 10_000,
                               fused.GLM_STAGED_MAX_D])
def test_bf16_x_takes_the_staged_walk(d):
    walk = fused.glm_value_walk(d, BF16)
    assert walk.walk == "staged"
    # rows of at most 1024 features: tiles of 16 or 32 rows; wider: 1-4
    assert walk.rows in ((16, 32) if d <= 1024 else (1, 2, 4))
    assert fused.glm_value_walk(d + fused.GLM_STAGED_MAX_D, BF16).walk == \
        "stream"


@pytest.mark.parametrize("d,walk", [
    (3073, "registers"), (4096, "registers"), (4097, "staged"),
    (6145, "staged"), (8192, "staged"), (8193, "staged"),
    (10_000, "staged"), (12_288, "staged"), (12_289, "stream"),
    (20_000, "stream")])
@pytest.mark.parametrize("mode", MODES)
def test_wide_f32_rows_follow_the_measured_cut(d, walk, mode):
    assert fused.glm_value_walk(d, F32, mode).walk == walk


@pytest.mark.parametrize("d", [1, 2, 4, 5, 13, 64, 100, 128])
@pytest.mark.parametrize("mode", MODES)
def test_narrow_f32_rows_take_the_narrow_walk(d, mode):
    walk = fused.glm_value_walk(d, F32, mode)
    assert walk.walk == "narrow"
    lanes = walk.rows
    # csrc narrow_lanes: 4 features a lane, a power of two, one warp
    assert lanes & (lanes - 1) == 0 and 4 * lanes >= d
    assert lanes == 1 or 2 * lanes < d
    assert walk.unit_rows == fused.GLM_WARPS * (32 // lanes) * \
        fused.GLM_NARROW_ROWS
    assert fused.glm_value_walk(129, F32, mode).walk != "narrow"


# bf16 X is kernel 1's ("resident") only; f32 rows of at most 1024
# features have no staged kernel (the narrow and registers walks take them)
@pytest.mark.parametrize("d,dtype,mode", [
    (d, BF16, "resident") for d in (1, 13, 257, 600, 1024, 1025, 2049,
                                    4097, 8193, 10_000, 12_288)] + [
    (d, F32, m) for d in (1025, 1537, 2049, 3073, 4096, 4097, 6144, 6145,
                          8193, 10_000, 12_287, 12_288)
    for m in ("resident", "vg")])
def test_staged_walk_fits_an_sm_and_the_partials_budget(d, dtype, mode):
    walk = fused.glm_walk("staged", d, dtype, mode)
    itemsize = 2 if dtype == BF16 else 4
    stage = fused._staged_stage_bytes(walk.rows, d, itemsize)
    assert stage % 16 == 0
    # a stage holds the tile's rows (16-byte chunks from the boundary at
    # or before the first) and their y
    assert stage >= walk.rows * d * itemsize + 4 * walk.rows
    stages, rest = divmod(walk.smem, stage)
    assert rest == 0 and 2 <= stages <= fused.GLM_MAX_STAGES
    assert walk.smem + fused.SMEM_CTA_RESERVE <= fused.SMEM_PER_CTA
    assert walk.per_sm >= 1
    assert walk.per_sm * (walk.smem + fused.SMEM_CTA_RESERVE) <= \
        fused.SMEM_PER_SM
    assert walk.unit_rows == walk.rows


@pytest.mark.parametrize("d,dtype,mode", [
    (257, BF16, "resident"), (4097, F32, "resident"), (10_000, F32, "vg"),
    (128, F32, "vg"), (13, F32, "vg_bf16"), (256, F32, "val"),
    (20_000, F32, "resident")])
@pytest.mark.parametrize("n_valid", [0, 1, 100_003, 4_000_000])
def test_n_part_stays_within_the_partials_budget(d, dtype, mode, n_valid):
    walk = fused.glm_value_walk(d, dtype, mode)
    width = {"resident": d + 1, "val": 1}.get(mode, d + 2)
    n_part = fused.glm_walk_n_part(walk, n_valid, width, SMS)
    assert 1 <= n_part <= walk.per_sm * SMS
    # one CTA per unit of rows at most, and partials within the budget
    # (but at least one CTA an SM)
    assert n_part <= max(1, -(-n_valid // walk.unit_rows))
    assert n_part * width <= max(fused.PARTIAL_FLOATS, SMS * width)


def test_walks_refuse_shapes_they_do_not_take():
    with pytest.raises(ValueError):
        fused.glm_walk("registers", 257, BF16)
    with pytest.raises(ValueError):
        fused.glm_walk("narrow", 129, F32)
    with pytest.raises(ValueError):
        fused.glm_walk("staged", fused.GLM_STAGED_MAX_D + 1, F32)
    with pytest.raises(ValueError):
        fused.glm_walk("registers", fused.GLM_REGISTER_MAX_D + 1, F32)
    with pytest.raises(ValueError):
        fused.glm_walk("staged", 1024, F32, "vg")
    with pytest.raises(ValueError):
        fused.glm_value_walk(257, BF16, "vg")
    with pytest.raises(ValueError):
        fused.glm_walk("staged", 257, F32, "vgh")


def test_cpu_wrappers_take_a_walk_and_run_the_plain_version():
    """On CPU tensors the wrappers run their plain versions at shapes of
    each new walk (staged for bf16 X, narrow for d = 13), and count no
    launch."""
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(50, 13).astype(np.float32))
    y = torch.from_numpy((r.rand(50) > 0.5).astype(np.float32))
    w = torch.from_numpy(r.randn(14).astype(np.float32))
    before = (fused.fused_glm_value_grad.launches,
              fused.fused_sgd_block_grad.launches)
    xb = x.to(BF16)
    assert fused.glm_value_walk(13, BF16).walk == "staged"
    a = fused.fused_glm_value_grad(xb, 40, y, w[:13], "logistic")
    b = fused.glm_value_grad_plain(xb, 40, y, w[:13], "logistic")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert fused.glm_value_walk(13, F32, "vg").walk == "narrow"
    a = fused.fused_sgd_block_grad(x, 40, y, w, 1.0, "hinge")
    b = fused.sgd_block_grad_plain(x, 40, y, w, 1.0, "hinge")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert (fused.fused_glm_value_grad.launches,
            fused.fused_sgd_block_grad.launches) == before


@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_valid", [256, 200])
def test_sgd_plain_on_an_unaligned_view_matches_pallas(loss, bf16, n_valid):
    """Kernel 5's plain version on rows 1.. of a (257, 13) X, a view
    that starts 52 bytes into its storage (off a 16-byte boundary, as
    SGD's resident blocks do at d = 13), against the Pallas kernel
    (``interpret=True``) on the same rows: rtol 1e-5 of the loss and of
    the largest gradient entry (f32 sums of the same terms in another
    order; bf16 operands round at the same points)."""
    r = np.random.RandomState(13)
    X = r.randn(257, 13).astype(np.float32)
    y = (r.rand(256) > 0.5).astype(np.float32)
    if loss == "squared_error":
        y = r.randn(256).astype(np.float32)
    w = (r.randn(14) * 0.3).astype(np.float32)
    xt = torch.from_numpy(X)[1:]
    assert xt.data_ptr() % 16 != 0 and xt.is_contiguous()
    mxu = torch.bfloat16 if bf16 else None
    out = fused.fused_sgd_block_grad(xt, n_valid, torch.from_numpy(y),
                                     torch.from_numpy(w), 1.0, loss, mxu)
    ref = pl_sgd_block_grad(jnp.asarray(X[1:]), n_valid, jnp.asarray(y),
                            jnp.asarray(w), 1.0, loss,
                            mxu=jnp.bfloat16 if bf16 else None,
                            interpret=True)
    (v, g), (v0, g0) = ((np.asarray(a, np.float64) for a in o)
                        for o in (out, ref))
    np.testing.assert_allclose(v, v0, rtol=1e-5)
    assert np.abs(g - g0).max() <= 1e-5 * np.abs(g0).max()
