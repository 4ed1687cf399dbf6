"""GLM solvers: lbfgs, gradient_descent, proximal_grad, newton, admm, the
one-vs-rest multi-target solve, and the stacked C-grid solves of the
search's fast path (``solve_lam_grid``, ``solve_lam_grid_multi``).

Counterpart of ``dask_ml_tpu/models/solvers/solvers.py``. The JAX package
runs each solver as one jitted ``lax.while_loop``; PyTorch runs eagerly,
so here the iteration and line-search control flow is host Python that
reads one or two device scalars per function evaluation, while every
vector stays a tensor on the data's device. At the main path's sizes an
evaluation is one read of X by the fused kernel, which dwarfs the scalar
reads.

The smooth loss is either the plain torch objective (``_smooth_loss``,
autograd through ``X @ beta``: two reads of X per value and gradient) or
the kernel-backed loss (``_kernel_loss``), whose data term's value and
gradient both come from ``ops.fused.fused_glm_value_grad`` in one read —
the counterpart of ``_pallas_loss``/``_custom_vjp_loss``. The penalty and
the mean scaling stay plain torch on the (d,) vector. Newton's value,
gradient and Hessian come from ``fused_glm_value_grad_hess`` in one call;
the one-vs-rest L-BFGS takes all C classes' values and gradients from
``fused_glm_multi_value_grad`` in one read of X. ADMM's local Newton
solves, the (d, d) solves and the small vectors of the L-BFGS recursion
stay plain torch, as the JAX package leaves them to XLA.

``lbfgs`` follows optax's algorithm step for step (optax is not a
dependency of the port): ``optax.lbfgs(memory_size=10,
scale_init_precond=True)`` with ``scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy="one")``, the value and
gradient of the accepted step reused as ``value_and_grad_from_state``
does, and the stopping rule of the JAX ``_lbfgs_loop``: iterate while
``it < max_iter and ‖g‖ > tol``, with g the gradient at the iterate the
step starts from. Scalars of the line search are Python floats.

Several processes (a process-local ``ShardedArray``,
``distributed.array_from_process_local``): every solver but ADMM takes
``reduce`` (``distributed.psum_host``), and each data evaluation's sums
(kernel 1's loss and gradient, kernel 3's Hessian, kernel 4's one-vs-rest
sums, or their plain versions) merge across processes on the host, in
float64 and rank order, before the mean scaling and the penalty
(``merge_sums``): every process then runs the same iterations on the
same global objective (``n_rows`` is the global count). ADMM makes each
process one consensus member (the JAX mesh shards'). The JAX package
reduces such a fit by a GSPMD psum in float32 on the devices. A process
with no rows adds zero sums (no launch) and joins every merge.

A feature-sharded design (``ShardedArray.from_array(..., shard_features=
True)`` under a ``"DxM"`` mesh, ``TiledDesign``): every solver that
evaluates through the objective (lbfgs, gradient_descent, proximal_grad,
newton, and the one-vs-rest joint lbfgs) takes ``fs=``, and its data
term's sums come from this rank's column tile: ``eta`` the "model"
collective of ``X_j @ w_j`` plus the replicated intercept (X carries no
column of ones), the gradient slice ``X_jᵀ r`` merged over "data" and
gathered over "model"; Newton's Hessian gathers the full rows of a chunk
at a time over "model". That layout runs plain torch products and the
collectives, no kernel, as JAX keeps its Pallas kernels off it
(``dask_ml_tpu/models/solvers/solvers.py:135-153``). ADMM's shard-local
Newton solve has no feature-sharded form: it raises naming ROADMAP.md
queue 1, Multi-GPU, part 3.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ...ops.fused import (
    fused_glm_multi_value_grad, fused_glm_value_grad,
    fused_glm_value_grad_hess,
)
from ...observability._metrics import emit_step, step_records_wanted
from . import regularizers
from .families import get_family

KERNEL = "fused_glm_value_grad"


def _smooth_loss(beta, X, y, mask, n_rows, lam, pmask, l1_ratio, family,
                 reg):
    """Mask-weighted mean NLL + penalty, plain torch. A bf16 X takes
    beta rounded to bf16 with f32 sums (the JAX matvec's contract)."""
    if X.dtype == torch.bfloat16:
        eta = X.to(torch.float32) @ beta.to(torch.bfloat16).to(torch.float32)
    else:
        eta = X @ beta
    base = (get_family(family).pointwise(eta, y) * mask).sum() / n_rows
    return base + regularizers.value(reg, beta, lam, pmask, l1_ratio)


class _KernelDataSum(torch.autograd.Function):
    """Σ NLL of the data from the fused kernel; its backward hands
    autograd the gradient the same kernel call computed (``ct * grad``),
    as the JAX ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, beta, data_vg):
        value, grad = data_vg(beta)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return ct * grad, None


def _data_sum_loss(data_vg, n_rows, lam, pmask, l1_ratio, reg):
    """Wrap a kernel-backed ``beta -> (Σ NLL, Σ ∂/∂β)`` into the smooth
    loss (mean scaling and penalty in plain torch), the counterpart of
    ``_custom_vjp_loss``: shared by the single- and multi-target
    kernels."""

    def loss(beta):
        return _KernelDataSum.apply(beta, data_vg) / n_rows + \
            regularizers.value(reg, beta, lam, pmask, l1_ratio)

    return loss


def _kernel_loss(X, y, n_rows, lam, pmask, l1_ratio, family, reg,
                 reduce=None, n_valid=None):
    """Smooth loss whose data term's value and gradient come from ONE
    read of X by the fused kernel (rows < n_rows are the valid prefix).
    Under ``reduce`` the sums merge across processes at each evaluation
    (:func:`merge_sums`): ``n_valid`` is then this process's count of
    valid rows and ``n_rows`` the global one."""
    nv = n_rows if n_valid is None else n_valid

    def data_vg(beta):
        if not nv:
            return merge_sums(reduce, _empty_vg(beta))
        return merge_sums(reduce, fused_glm_value_grad(
            X, nv, y, beta.detach(), family))

    return _data_sum_loss(data_vg, n_rows, lam, pmask, l1_ratio, reg)


def merge_sums(reduce, sums):
    """Local device sums -> the global sums across processes: to the host
    in one transfer, ``reduce`` in float64 (identical on every process),
    back to their device as float32. The identity without a reduce."""
    if reduce is None:
        return tuple(sums)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in sums])
    merged = np.asarray(
        reduce(np.asarray(flat.cpu().numpy(), np.float64)), np.float32)
    out, i = [], 0
    for t in sums:
        out.append(torch.as_tensor(merged[i:i + t.numel()],
                                   device=t.device).reshape(t.shape))
        i += t.numel()
    return tuple(out)


# rows of a chunk whose full width the feature-sharded Hessian gathers at
# once
_GATHER_ROWS = 1 << 14


class TiledDesign:
    """This rank's column tile ``[lo, hi)`` of a feature-sharded design
    (``data`` (rows, hi - lo), ``mask`` its row mask; None for a
    streamed design, whose blocks come to :meth:`block_sums`), the
    global width ``n_features`` and the intercept as a replicated
    operand (the last entry of beta). ``reduce`` merges over the row
    groups ("data"), None with one row group. Coefficients are
    ``W`` (d[+1],) binary or (C, d[+1]) one-vs-rest, targets ``y``
    (rows,) or (C, rows) 0/1. :meth:`block_sums` gives a tile's local
    sums, which add over blocks; :meth:`merged` merges them once: bit-
    equal on every rank of the mesh."""

    def __init__(self, data, mask, lo, hi, n_features, intercept,
                 reduce=None):
        self.data, self.mask = data, mask
        self.lo, self.hi = int(lo), int(hi)
        self.n_features = int(n_features)
        self.intercept = bool(intercept)
        self.reduce = reduce

    def eta(self, W, x):
        """(rows,) or (rows, C) eta of the tile ``x``: the "model"
        collective of ``x @ W_j``, plus the replicated intercept."""
        from ...parallel.model_axis import tile_matmul

        d = self.n_features
        Wf = W[..., :d]
        eta = tile_matmul(x, Wf if W.ndim == 1 else Wf.T, self.lo)
        return eta + W[..., d] if self.intercept else eta

    def block_sums(self, kind, W, y, family, x=None, mask=None):
        """The local sums of ``kind`` over the tile ``x`` (``data`` and
        ``mask`` by default; every row counts when ``mask`` is None):
        (value,) for "val"; then the gradient's slice (..., hi - lo) and
        intercept sums (...) for "vg"; then the Hessian's row tile
        (..., hi - lo, d) against full rows gathered over "model" a
        chunk at a time, the bordering column (..., hi - lo) and the
        weight sum (...) for "vgh"."""
        from ...parallel.model_axis import gather_features

        if x is None:
            x, mask = self.data, self.mask
        multi = W.ndim == 2
        t = y.T if multi else y
        fam = get_family(family)
        eta = self.eta(W.detach(), x)
        with torch.enable_grad():
            e = eta.detach().requires_grad_(True)
            pw = fam.pointwise(e, t)
            if mask is not None:
                pw = pw * (mask[:, None] if multi else mask)
            v = pw.sum()
            if kind == "val":
                return (v.detach(),)
            (r,) = torch.autograd.grad(v, e)
        out = (v.detach(), r.T @ x if multi else x.T @ r, r.sum(0))
        if kind == "vg":
            return out
        wgt = fam.hess_weight(eta, t)
        if mask is not None:
            wgt = wgt * (mask[:, None] if multi else mask)
        lead = (W.shape[0],) if multi else ()
        hess = torch.zeros(lead + (x.shape[1], self.n_features),
                           dtype=torch.float32, device=x.device)
        # every rank of the row group gathers the same chunks
        for i in range(0, max(x.shape[0], 1), _GATHER_ROWS):
            xc, wc = x[i:i + _GATHER_ROWS], wgt[i:i + _GATHER_ROWS]
            xf = gather_features(xc, axis=1)
            if multi:
                hess += (wc.T[:, :, None] * xc[None]).transpose(1, 2) @ xf
            else:
                hess += (xc * wc[:, None]).T @ xf
        col = wgt.T @ x if multi else wgt @ x
        return out + (hess, col, wgt.sum(0))

    def merged(self, kind, sums):
        """:meth:`block_sums`' sums merged: one "data" merge, one "model"
        gather of each per-feature piece; (value,), (value, gradient
        (..., d[+1])) or (value, gradient, Hessian (..., d[+1], d[+1]))
        bordered by ``Xᵀw`` and ``Σ w`` with an intercept."""
        from ...parallel.model_axis import gather_features

        sums = merge_sums(self.reduce, sums)
        if kind == "val":
            return sums
        val, g_loc, g_b = sums[:3]
        g = gather_features(g_loc, axis=-1)
        if self.intercept:
            g = torch.cat([g, g_b[..., None]], dim=-1)
        if kind == "vg":
            return val, g
        hess, col, wsum = sums[3:]
        H = gather_features(hess, axis=-2)
        if self.intercept:
            colf = gather_features(col, axis=-1)
            border = torch.cat([colf, wsum[..., None]], -1)
            H = torch.cat([torch.cat([H, colf[..., None]], -1),
                           border[..., None, :]], -2)
        return val, g, H

    def value_grad(self, W, y, family):
        """(Σ masked NLL, its gradient) at ``W``."""
        return self.merged("vg", self.block_sums("vg", W, y, family))

    def value_grad_hess(self, W, y, family):
        """(Σ NLL, gradient, Hessian) at ``W``."""
        return self.merged("vgh", self.block_sums("vgh", W, y, family))


def _empty_vg(beta):
    """Zero (Σ NLL, gradient) of a process with no rows: no launch."""
    return (torch.zeros((), dtype=torch.float32, device=beta.device),
            torch.zeros_like(beta, dtype=torch.float32))


def _plain_data_vg(X, y, mask, family):
    """``beta -> (Σ masked NLL, its gradient)`` in plain torch, the
    counterpart of the kernel's sums for a merged (process-local) fit."""

    def data_vg(beta):
        with torch.enable_grad():
            b = beta.detach().requires_grad_(True)
            if X.dtype == torch.bfloat16:
                eta = X.to(torch.float32) @ b.to(torch.bfloat16).to(
                    torch.float32)
            else:
                eta = X @ b
            v = (get_family(family).pointwise(eta, y) * mask).sum()
            (g,) = torch.autograd.grad(v, b)
        return v.detach(), g

    return data_vg


def resolve_kernel(use_kernel, fs=None):
    """(use the fused kernel?, why not) — the counterpart of
    ``_resolve_pallas``. The kernel takes every design the solvers give
    it (any d, f32 or bf16, the three families), so only the caller's
    ``use_kernel=False`` keeps the plain loss, and a feature-sharded
    design (``fs``) its tiled sums, as JAX's gate keeps that layout off
    its kernel; on the CPU the kernel's wrapper is its plain version."""
    if fs is not None:
        return False, "feature-sharded"
    if use_kernel is False:
        return False, "use_kernel=False"
    return True, None


def _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask, l1_ratio,
                 family, reg, reduce=None, n_valid=None, fs=None):
    """The ONE place a solver picks its smooth loss. Under ``reduce``,
    ``n_valid`` is this process's count of valid rows and ``n_rows``
    the global one; ``fs`` (a :class:`TiledDesign`) takes the tiled
    sums, merged."""
    if fs is not None:
        return _data_sum_loss(lambda b: fs.value_grad(b, y, family), n_rows,
                              lam, pmask, l1_ratio, reg)
    if use_kernel:
        return _kernel_loss(X, y, n_rows, lam, pmask, l1_ratio, family, reg,
                            reduce, n_valid)
    if reduce is not None:
        plain = _plain_data_vg(X, y, mask, family)
        return _data_sum_loss(lambda b: merge_sums(reduce, plain(b)), n_rows,
                              lam, pmask, l1_ratio, reg)

    def loss(beta):
        return _smooth_loss(beta, X, y, mask, n_rows, lam, pmask, l1_ratio,
                            family, reg)

    return loss


def _value_and_grad(loss, beta):
    with torch.enable_grad():
        b = beta.detach().requires_grad_(True)
        v = loss(b)
        (g,) = torch.autograd.grad(v, b)
    return v.detach(), g


def _value(loss, beta):
    with torch.no_grad():
        return loss(beta)


def _scalars(*vals):
    """Several device scalars as Python floats in one transfer."""
    return [float(v) for v in torch.stack(
        [torch.as_tensor(v, dtype=torch.float32) for v in vals]).tolist()]


def _f32(x):
    """A step size rounded as the JAX solvers keep it (float32)."""
    return float(np.float32(x))


def _f32_mul(a, b):
    """``a * b`` in float32 arithmetic, as the JAX loops scale a float32
    step by a weakly typed Python factor (``t * grow``): the factor is
    rounded to float32 first, then the product."""
    return float(np.float32(a) * np.float32(b))


# the JAX loops compare a float32 step with this bound
_T_MIN = _f32(1e-20)


def check_finite_result(beta, info, solver):
    """NaN/Inf sanitizer: non-finite parameters raise instead of
    becoming a model (a NaN ends a ``gnorm > tol`` loop as converged)."""
    beta_h = beta.detach().cpu().numpy()
    scalars = [v for v in info.values()
               if isinstance(v, (int, float)) and not isinstance(v, bool)]
    if not np.isfinite(beta_h).all() or not np.all(np.isfinite(scalars)):
        raise FloatingPointError(
            f"solver {solver!r} produced non-finite parameters "
            f"(info={info}): the input contains NaN/Inf or the solve "
            f"diverged — validate the data or reduce the step size / C"
        )
    return beta_h, info


def _check_smooth(reg, solver):
    if reg not in regularizers.SMOOTH:
        raise ValueError(
            f"solver {solver!r} handles smooth penalties only (l2/none), got "
            f"{reg!r}; use solver='proximal_grad' for l1/elastic_net"
        )


# --------------------------------------------------------------------------
# L-BFGS: optax.lbfgs with its zoom line search
# --------------------------------------------------------------------------

def _nan_max(a, b):
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _nan_min(a, b):
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when it has none (optax ``_cubicmin``)."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        r0 = fb - fa - C * db
        r1 = fc - fa - C * dc
        A = (dc ** 2 * r0 - db ** 2 * r1) / denom
        B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
        radical = B * B - 3.0 * A * C
        return float(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db ** 2)
        return float(a - fpa / (2.0 * B))


class _ZoomLinesearch:
    """optax ``zoom_linesearch`` (Nocedal & Wright, algorithms 3.5 and
    3.6) with optax's defaults: tol 0, increase factor 2, slope_rtol
    1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, interval threshold 1e-5,
    no maximal step size, initial guess 1."""

    slope_rtol = 1e-4
    curv_rtol = 0.9
    approx_dec_rtol = 1e-6
    interval_threshold = 1e-5
    increase_factor = 2.0
    tol = 0.0

    def __init__(self, value_and_grad, max_steps=20):
        self.vg = value_and_grad
        self.max_steps = max_steps

    def _on_line(self, step):
        v, g = self.vg(self.params + step * self.updates)
        value, slope = _scalars(v, torch.dot(g, self.updates))
        return value, g, slope

    def _decrease_error(self, step, value, slope):
        v0, s0 = self.value_init, self.slope_init
        err = value - v0 - self.slope_rtol * step * s0
        approx = slope - (2 * self.slope_rtol - 1.0) * s0
        delta = value - v0 - self.approx_dec_rtol * abs(v0)
        err = _nan_min(_nan_max(approx, delta), err)
        err = _nan_max(err, 0.0)
        return math.inf if math.isnan(err) else err

    def _curvature_error(self, slope):
        err = _nan_max(abs(slope) - self.curv_rtol * abs(self.slope_init),
                       0.0)
        return math.inf if math.isnan(err) else err

    def run(self, params, updates, value, grad):
        """(step size, value, gradient) at the accepted point."""
        self.params, self.updates = params, updates
        slope = float(torch.dot(updates, grad))
        self.value_init, self.slope_init = value, slope
        s = dict(count=0, stepsize=0.0, value=value, grad=grad, slope=slope,
                 decrease_error=math.inf, interval_found=False, done=False,
                 failed=False, low=0.0, value_low=value, slope_low=slope,
                 high=0.0, value_high=value, slope_high=slope,
                 cubic_ref=0.0, value_cubic_ref=value, safe_stepsize=0.0,
                 safe_value=value, safe_grad=grad)
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                self._zoom(s)
            else:
                self._search(s)
            if s["failed"]:
                self._try_safe_step(s)
        return s["stepsize"], s["value"], s["grad"]

    def _search(self, s):
        """Algorithm 3.5: grow the step until an interval brackets one
        that satisfies both criteria."""
        it = s["count"]
        prev_step, prev_value, prev_slope = (s["stepsize"], s["value"],
                                             s["slope"])
        step = 1.0 if it == 0 else self.increase_factor * prev_step
        value, grad, slope = self._on_line(step)
        dec = self._decrease_error(step, value, slope)
        curv = self._curvature_error(slope)
        error = max(dec, curv)
        if dec <= self.tol:
            s.update(safe_stepsize=step, safe_value=value, safe_grad=grad)
        set_high_to_new = dec > 0.0 or (value >= prev_value and it > 0)
        set_low_to_new = slope >= 0.0 and not set_high_to_new
        if set_low_to_new:
            s.update(low=step, value_low=value, slope_low=slope,
                     high=prev_step, value_high=prev_value,
                     slope_high=prev_slope)
        else:
            s.update(low=prev_step, value_low=prev_value,
                     slope_low=prev_slope, high=step, value_high=value,
                     slope_high=slope)
        done = error <= self.tol
        s.update(
            count=it + 1, stepsize=step, value=value, grad=grad,
            slope=slope, decrease_error=dec,
            interval_found=set_high_to_new or set_low_to_new or done,
            done=done, failed=(it + 1 >= self.max_steps) and not done,
            cubic_ref=s["low"], value_cubic_ref=s["value_low"],
        )

    def _zoom(self, s):
        """Algorithm 3.6: shrink the interval by cubic, quadratic or
        bisection steps."""
        it = s["count"]
        low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
        high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        too_small = delta <= self.interval_threshold
        mc = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"],
                       s["value_cubic_ref"])
        use_cubic = left + 0.2 * delta < mc < right - 0.2 * delta
        mq = _quadmin(low, vlow, slow, high, vhigh)
        use_quad = (not use_cubic) and left + 0.1 * delta < mq < \
            right - 0.1 * delta
        if use_cubic:
            middle = mc
        elif use_quad:
            middle = mq
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec = self._decrease_error(middle, value, slope)
        curv = self._curvature_error(slope)
        error = max(dec, curv)
        if dec <= self.tol and value < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = error <= self.tol
        set_high_to_middle = dec > 0.0 or value >= vlow
        set_high_to_low = slope * (high - low) >= 0.0 and \
            not set_high_to_middle
        new_high = (middle, value, slope) if set_high_to_middle else \
            (high, vhigh, shigh)
        if set_high_to_low:
            new_high = (low, vlow, slow)
        new_low = (low, vlow, slow) if set_high_to_middle else \
            (middle, value, slope)
        cubic = (high, vhigh) if set_high_to_middle or set_high_to_low \
            else (low, vlow)
        failed = (it + 1 >= self.max_steps or (
            too_small and s["safe_stepsize"] > 0.0)) and not done
        s.update(
            count=it + 1, stepsize=middle, value=value, grad=grad,
            slope=slope, decrease_error=dec, done=done, failed=failed,
            low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
            high=new_high[0], value_high=new_high[1],
            slope_high=new_high[2], cubic_ref=cubic[0],
            value_cubic_ref=cubic[1],
        )

    @staticmethod
    def _try_safe_step(s):
        """Fall back on the best step with sufficient decrease."""
        if s["safe_stepsize"] > 0.0 or math.isinf(s["decrease_error"]):
            s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                     grad=s["safe_grad"])


def _lbfgs_direction(grad, dW, dU, rhos, gamma, mem_idx):
    """optax ``_precondition_by_lbfgs``: the two-loop recursion over the
    ring buffer, newest pair first in the right product."""
    m = rhos.shape[0]
    order = [(mem_idx + i) % m for i in range(m)]
    vec = grad
    alphas = {}
    for idx in reversed(order):
        alphas[idx] = rhos[idx] * torch.dot(dW[idx], vec)
        vec = vec - alphas[idx] * dU[idx]
    vec = gamma * vec
    for idx in order:
        b = rhos[idx] * torch.dot(dU[idx], vec)
        vec = vec + (alphas[idx] - b) * dW[idx]
    return vec


def _lbfgs_state(beta0, memory, n_blocks=None):
    """The whole L-BFGS loop state at iteration 0: the iterate, the
    ring buffer of (dW, dU, rho) pairs, the previous iterate and
    gradient, the value and gradient the line search left
    (``value_and_grad_from_state``), the gradient norm and ``it``; with
    ``n_blocks`` also the stacked solve's per-block convergence record.
    A chunked solve carries it from chunk to chunk."""
    d = beta0.shape[0]
    zeros = dict(dtype=beta0.dtype, device=beta0.device)
    st = {"beta": beta0, "dW": torch.zeros((memory, d), **zeros),
          "dU": torch.zeros((memory, d), **zeros),
          "rhos": torch.zeros(memory, **zeros),
          "prev_params": torch.zeros(d, **zeros),
          "prev_grad": torch.zeros(d, **zeros),
          "state_value": math.inf, "state_grad": None,
          "gnorm": math.inf, "it": 0}
    if n_blocks is not None:
        st.update(conv=np.zeros(n_blocks, np.int64),
                  cmask=np.zeros(n_blocks, bool),
                  frozen=beta0.reshape(n_blocks, -1))
    return st


def _lbfgs_run(loss, st, stop_it, tol, memory, n_blocks=None):
    """optax L-BFGS iterations on the state ``st`` (updated in place)
    while ``it < stop_it`` and ‖g‖ > tol.

    ``n_blocks`` switches on the stacked multi-solve semantics of the JAX
    ``_lbfgs_loop``: the flat vector is ``n_blocks`` independent blocks
    (one-vs-rest classes) sharing one iteration budget; the loop stops
    when the largest per-block gradient norm reaches tol, ``conv``
    records per block the last iteration at which its norm still
    exceeded tol, and ``frozen`` keeps each block's iterate at its own
    convergence point (its first iterate whose gradient norm passed
    tol)."""
    def vg(b):
        return _value_and_grad(loss, b)

    search = _ZoomLinesearch(vg)
    dW, dU, rhos = st["dW"], st["dU"], st["rhos"]
    beta, it, gnorm = st["beta"], st["it"], st["gnorm"]
    prev_params, prev_grad = st["prev_params"], st["prev_grad"]
    state_value, state_grad = st["state_value"], st["state_grad"]
    if n_blocks is not None:
        tol32 = np.float32(tol)
        conv, cmask, frozen = st["conv"], st["cmask"], st["frozen"]
    while it < stop_it and gnorm > tol:
        # value_and_grad_from_state: reuse the line search's evaluation
        if math.isfinite(state_value):
            value, grad = state_value, state_grad
        else:
            v, grad = vg(beta)
            value = float(v)
        if n_blocks is not None:
            # the gradient is at the CURRENT iterate: a block whose norm
            # just passed tol converged at this iterate, before the step
            norms = torch.linalg.vector_norm(
                grad.reshape(n_blocks, -1), dim=1).cpu().numpy()
            frozen = torch.where(
                torch.as_tensor(cmask, device=beta.device)[:, None], frozen,
                beta.reshape(n_blocks, -1))
            cmask = cmask | (norms <= tol32)
        # scale_by_lbfgs: store the last pair, then precondition
        prev_idx = (it - 1) % memory
        if it > 0:
            dp = beta - prev_params
            du = grad - prev_grad
            vdot = torch.dot(du, dp)
            dW[prev_idx] = dp
            dU[prev_idx] = du
            rhos[prev_idx] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, vdot / den,
                                torch.ones_like(den))
        else:
            gamma = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad),
                                    1.0)
        direction = _lbfgs_direction(grad, dW, dU, rhos, gamma,
                                     it % memory)
        prev_params, prev_grad = beta, grad
        updates = -direction
        step, state_value, state_grad = search.run(beta, updates, value,
                                                   grad)
        beta = beta + step * updates
        if n_blocks is not None:
            gnorm = float(norms.max())
            conv = np.where(norms > tol32, it + 1, conv)
        else:
            gnorm = float(torch.linalg.vector_norm(grad))
        emit_step(it, loss=value, grad_norm=gnorm)
        it += 1
    st.update(beta=beta, it=it, gnorm=gnorm, prev_params=prev_params,
              prev_grad=prev_grad, state_value=state_value,
              state_grad=state_grad)
    if n_blocks is not None:
        st.update(conv=conv, cmask=cmask, frozen=frozen)
    return st


def _lbfgs_result(st, n_blocks=None):
    """(beta, it, gnorm, conv) of a finished state; a stacked solve's
    blocks come back frozen at their own convergence points."""
    beta, it, gnorm = st["beta"], st["it"], st["gnorm"]
    if n_blocks is None:
        return beta, it, gnorm, None
    merged = torch.where(
        torch.as_tensor(st["cmask"], device=beta.device)[:, None],
        st["frozen"], beta.reshape(n_blocks, -1)).reshape(beta.shape)
    return merged, it, gnorm, st["conv"]


def _lbfgs_loop(loss, beta0, max_iter, tol, memory, n_blocks=None):
    """optax L-BFGS iterations until ``it == max_iter`` or ‖g‖ <= tol;
    returns (beta, it, gnorm, conv) (``conv`` None without blocks)."""
    st = _lbfgs_run(loss, _lbfgs_state(beta0, memory, n_blocks), max_iter,
                    tol, memory, n_blocks)
    return _lbfgs_result(st, n_blocks)


# the tensors of a single-target L-BFGS state a checkpoint carries
_LBFGS_TENSORS = ("beta", "dW", "dU", "rhos", "prev_params", "prev_grad")


def _lbfgs_state_host(st):
    """The single-target state as a flat dict of host values."""
    out = {k: st[k].cpu().numpy() for k in _LBFGS_TENSORS}
    grad = st["state_grad"]
    out["state_grad"] = (np.zeros_like(out["beta"]) if grad is None
                         else grad.cpu().numpy())
    out["has_state_grad"] = int(grad is not None)
    out["state_value"] = float(st["state_value"])
    out["gnorm"] = float(st["gnorm"])
    out["it"] = int(st["it"])
    return out


def _lbfgs_state_from_host(saved, like):
    """The state restored from ``_lbfgs_state_host`` onto the device and
    dtype of ``like`` (a fresh state); None when its keys or shapes are
    another solve's."""
    try:
        st = dict(like)
        for k in _LBFGS_TENSORS:
            v = torch.as_tensor(saved[k], dtype=like[k].dtype,
                                device=like[k].device)
            if v.shape != like[k].shape:
                return None
            st[k] = v
        if int(saved["has_state_grad"]):
            st["state_grad"] = torch.as_tensor(
                saved["state_grad"], dtype=like["beta"].dtype,
                device=like["beta"].device)
        st["state_value"] = float(saved["state_value"])
        st["gnorm"] = float(saved["gnorm"])
        st["it"] = int(saved["it"])
        return st
    except (KeyError, TypeError, ValueError):
        return None


def _per_block_iters(conv, it_total):
    """Per-block iteration counts in the single-target ``n_iter``
    convention: the iteration that first sees a below-tol gradient
    counts too (+1 over the last above-tol iteration), clamped to the
    joint budget; max(per block) == the joint n_iter."""
    return np.minimum(np.asarray(conv, np.int64) + 1, int(it_total))


def lbfgs(X, y, mask, n_rows, beta0, family, reg, lam, pmask, l1_ratio=0.5,
          max_iter=100, tol=1e-6, memory=10, use_kernel=None,
          checkpoint_path=None, checkpoint_every=0, reduce=None,
          n_valid=None, fs=None, **_):
    """With ``checkpoint_path`` and ``checkpoint_every`` (through
    ``solver_kwargs``) the solve runs in ``checkpoint_every``-iteration
    chunks, the whole loop state saved after each
    (``utils/checkpoint.py``), so a killed fit resumes at its last chunk
    (``info["resumed_from"]``, the iteration it resumed at) and ends
    bit-equal to an unchunked solve. A completed solve clears the
    checkpoint; a state of another shape starts fresh."""
    _check_smooth(reg, "lbfgs")
    use_kernel, reason = resolve_kernel(use_kernel, fs)
    loss = _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask,
                        l1_ratio, family, reg, reduce, n_valid, fs)
    memory, max_iter, tol = int(memory), int(max_iter), float(tol)
    st = _lbfgs_state(beta0, memory)
    info = {}
    if checkpoint_path and checkpoint_every:
        import shutil

        from ...utils import checkpoint as ckpt

        saved = ckpt.restore_pytree(checkpoint_path) \
            if ckpt.checkpoint_exists(checkpoint_path) else None
        restored = None if saved is None \
            else _lbfgs_state_from_host(saved, st)
        if restored is not None:
            st = restored
        info["resumed_from"] = st["it"]
        while st["it"] < max_iter and st["gnorm"] > tol:
            stop = min(st["it"] + int(checkpoint_every), max_iter)
            st = _lbfgs_run(loss, st, stop, tol, memory)
            ckpt.save_pytree(checkpoint_path, _lbfgs_state_host(st))
        # completed: a finished solve's state left behind would be
        # "resumed" by the next fit given the path
        for suffix in ("", ".old", ".tmp"):
            shutil.rmtree(os.path.abspath(checkpoint_path) + suffix,
                          ignore_errors=True)
    else:
        st = _lbfgs_run(loss, st, max_iter, tol, memory)
    beta, it, gnorm, _ = _lbfgs_result(st)
    return beta, {"n_iter": int(it), "grad_norm": gnorm, **info,
                  **_kernel_info(use_kernel, reason)}


def _kernel_info(use_kernel, reason, kernel=KERNEL):
    return {"kernel": kernel if use_kernel else None,
            "kernel_reason": reason}


# --------------------------------------------------------------------------
# Gradient descent with Armijo backtracking (dask_glm::gradient_descent)
# --------------------------------------------------------------------------

def gradient_descent(X, y, mask, n_rows, beta0, family, reg, lam, pmask,
                     l1_ratio=0.5, max_iter=100, tol=1e-6, init_step=1.0,
                     armijo=1e-4, backtrack=0.5, grow=2.0, use_kernel=None,
                     reduce=None, n_valid=None, fs=None, **_):
    _check_smooth(reg, "gradient_descent")
    use_kernel, reason = resolve_kernel(use_kernel, fs)
    loss = _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask,
                        l1_ratio, family, reg, reduce, n_valid, fs)
    beta, step = beta0, _f32(init_step)
    gnorm, it = math.inf, 0
    while it < max_iter and gnorm > tol:
        v, grad = _value_and_grad(loss, beta)
        val, g2 = _scalars(v, torch.dot(grad, grad))
        t = step
        # the Armijo test in float32, as the JAX loop makes it: near
        # convergence a decrease below float32 resolution must pass
        while t > _T_MIN and np.float32(_value(loss, beta - t * grad)) > \
                np.float32(val) - np.float32(armijo) * np.float32(t) \
                * np.float32(g2):
            t = _f32_mul(t, backtrack)
        beta = beta - t * grad
        step = _f32_mul(t, grow)
        gnorm = float(np.sqrt(np.float32(g2)))
        emit_step(it, loss=val, grad_norm=gnorm)
        it += 1
    return beta, {"n_iter": it, "grad_norm": gnorm,
                  **_kernel_info(use_kernel, reason)}


# --------------------------------------------------------------------------
# Proximal gradient with backtracking (dask_glm::proximal_grad)
# --------------------------------------------------------------------------

def proximal_grad(X, y, mask, n_rows, beta0, family, reg, lam, pmask,
                  l1_ratio=0.5, max_iter=100, tol=1e-7, init_step=1.0,
                  backtrack=0.5, grow=1.2, use_kernel=None, reduce=None,
                  n_valid=None, fs=None, **_):
    use_kernel, reason = resolve_kernel(use_kernel, fs)
    # the penalty is the prox's: the selected loss is the smooth data term
    smooth = _select_loss(use_kernel, X, y, mask, n_rows, 0.0, pmask,
                          l1_ratio, family, "none", reduce, n_valid, fs)

    def candidate(beta, grad, t):
        return regularizers.prox(reg, beta - t * grad, lam, t, pmask,
                                 l1_ratio)

    beta, step = beta0, _f32(init_step)
    delta, it = math.inf, 0
    # the loop holds its value on the card only: the step records are
    # read in one transfer at the end
    steps = [] if step_records_wanted() else None
    while it < max_iter and delta > tol:
        val_t, grad = _value_and_grad(smooth, beta)
        t = step
        while t > _T_MIN:
            z = candidate(beta, grad, t)
            dz = z - beta
            quad = val_t + torch.dot(grad, dz) + (dz * dz).sum() / (2.0 * t)
            fz, q = _scalars(_value(smooth, z), quad)
            if not fz > q:
                break
            t = _f32_mul(t, backtrack)
        z = candidate(beta, grad, t)
        # float32, as the JAX loop divides
        delta = float(np.float32(torch.linalg.vector_norm(z - beta))
                      / np.float32(max(t, _T_MIN)))
        beta, step = z, _f32_mul(t, grow)
        if steps is not None:
            steps.append((val_t, delta))
        it += 1
    if steps:
        vals = _scalars(*(v for v, _ in steps))
        for i, (v, (_, dl)) in enumerate(zip(vals, steps)):
            emit_step(i, loss=v, opt_residual=dl)
    return beta, {"n_iter": it, "opt_residual": delta,
                  **_kernel_info(use_kernel, reason)}


# --------------------------------------------------------------------------
# Newton (dask_glm::newton) with a step-halving safeguard
# --------------------------------------------------------------------------

def _lstsq_min_norm(a, b):
    """``jnp.linalg.lstsq(a, b)[0]``: the minimum-norm least-squares
    solution from an SVD, singular values below ``eps * max(m, n) *
    s_max`` cut (JAX's default rcond). ``torch.linalg.lstsq`` on CUDA
    has only the full-rank ``gels`` driver, so a singular Hessian (n <
    d, a constant or duplicated column) would not give this step."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.T @ (s_inv * (u.T @ b))


def newton(X, y, mask, n_rows, beta0, family, reg, lam, pmask,
           l1_ratio=0.5, max_iter=50, tol=1e-6, use_kernel=None, reduce=None,
           n_valid=None, fs=None, **_):
    """Newton iterations while ``it < max_iter and ‖g‖ > tol``. With the
    kernel, one ``fused_glm_value_grad_hess`` call per iteration gives
    the value, gradient and Hessian; the step-halving line search
    ``loss(beta - t delta) > val and t > 1e-6`` evaluates the kernel-
    backed loss (``fused_glm_value_grad``)."""
    _check_smooth(reg, "newton")
    use_kernel, reason = resolve_kernel(use_kernel, fs)
    fam = get_family(family)
    loss = _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask,
                        l1_ratio, family, reg, reduce, n_valid, fs)
    ridge = (lam * pmask if reg == "l2" else torch.zeros_like(pmask)) + 1e-8
    nv = n_rows if n_valid is None else n_valid

    def penalty(b):
        return regularizers.value(reg, b, lam, pmask, l1_ratio)

    t_min = _f32(1e-6)
    beta, gnorm, it = beta0, math.inf, 0
    while it < max_iter and gnorm > tol:
        if fs is not None or use_kernel:
            if fs is not None:
                vs, gs, hs = fs.value_grad_hess(beta, y, family)
            elif not nv:
                D = beta.shape[0]
                vs, gs, hs = merge_sums(reduce, _empty_vg(beta) + (
                    torch.zeros((D, D), device=beta.device),))
            else:
                vs, gs, hs = merge_sums(reduce, fused_glm_value_grad_hess(
                    X, nv, y, beta, family))
            pen, pen_g = _value_and_grad(penalty, beta)
            val, grad, hess = vs / n_rows + pen, gs / n_rows + pen_g, \
                hs / n_rows
        else:
            val, grad = _value_and_grad(loss, beta)
            eta = X @ beta
            w = fam.hess_weight(eta, y) * mask
            (hess,) = merge_sums(reduce, ((X * w[:, None]).T @ X,))
            hess = hess / n_rows
        delta = _lstsq_min_norm(hess + torch.diag(ridge), grad)
        val_h, t = float(val), 1.0
        while float(_value(loss, beta - t * delta)) > val_h and t > t_min:
            t *= 0.5
        beta = beta - t * delta
        gnorm = float(torch.linalg.vector_norm(grad))
        emit_step(it, loss=val_h, grad_norm=gnorm)
        it += 1
    return beta, {"n_iter": it, "grad_norm": gnorm,
                  **_kernel_info(use_kernel, reason,
                                 "fused_glm_value_grad_hess")}


# --------------------------------------------------------------------------
# Consensus ADMM (dask_glm::admm) on one device
# --------------------------------------------------------------------------

def admm(X, y, mask, n_rows, beta0, family, reg, lam, pmask, l1_ratio=0.5,
         max_iter=250, tol=1e-4, rho=1.0, local_iter=8, reduce=None, fs=None,
         **_):
    """The JAX ``_admm_run`` with one shard (one device holds every row):
    ``local_iter`` local Newton steps on the augmented Lagrangian, the
    z-update as the penalty's prox with step ``1 / rho``, the scaled dual
    update and Boyd's residual balancing (rho ×2 or ×0.5, U rescaled).
    Every product is plain torch, as the JAX package leaves them to XLA;
    the scalars are float32 tensors, as in the JAX loop."""
    if fs is not None:
        raise NotImplementedError(
            "solver='admm' over a feature-sharded design: its shard-local "
            "Newton solve needs whole rows (ROADMAP.md queue 1, Multi-GPU, "
            "part 3); use lbfgs, newton, gradient_descent or proximal_grad")
    if reg == "none":
        reg, lam = "l2", 0.0
    fam = get_family(family)
    dev, d = beta0.device, beta0.shape[0]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    lam_t, rho_t, tol32 = f32(lam), f32(rho), np.float32(tol)
    members = float(reduce(np.asarray(1.0))) if reduce is not None else 1.0
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    b, u, z = beta0, torch.zeros_like(beta0), beta0
    it, primal, dual = 0, np.float32(np.inf), np.float32(np.inf)
    while it < max_iter and (primal > tol32 or dual > tol32):
        v = z - u  # local target
        for _ in range(local_iter):
            eta = X @ b
            g = X.T @ ((fam.mean(eta) - y) * mask) / n_rows + rho_t * (b - v)
            w = fam.hess_weight(eta, y) * mask
            h = (X * w[:, None]).T @ X / n_rows + rho_t * eye
            b = b - torch.linalg.solve(h, g)
        if reduce is None:
            z_new = regularizers.prox(reg, b + u, lam_t, 1.0 / rho_t, pmask,
                                      l1_ratio)
            u = u + b - z_new
            primal, dual = (np.float32(s) for s in _scalars(
                torch.sqrt(torch.sum((b - z_new) ** 2)),
                rho_t * torch.linalg.vector_norm(z_new - z)))
        else:
            # each process one consensus member: z from the members'
            # mean, the residuals over every member
            (bu,) = merge_sums(reduce, (b + u,))
            z_new = regularizers.prox(reg, bu / members, lam_t,
                                      1.0 / (rho_t * members), pmask,
                                      l1_ratio)
            u = u + b - z_new
            (p2,) = merge_sums(reduce, (torch.sum((b - z_new) ** 2),))
            primal, dual = (np.float32(s) for s in _scalars(
                torch.sqrt(p2), rho_t * float(np.sqrt(members))
                * torch.linalg.vector_norm(z_new - z)))
        emit_step(it, primal_residual=primal, dual_residual=dual)
        # Boyd §3.4.1 residual balancing; U is the scaled dual
        scale = 2.0 if primal > np.float32(10.0) * dual else \
            0.5 if dual > np.float32(10.0) * primal else 1.0
        u, rho_t, z = u / scale, rho_t * scale, z_new
        it += 1
    return z, {"n_iter": it, "primal_residual": float(primal),
               "dual_residual": float(dual)}


SOLVERS = {
    "admm": admm,
    "lbfgs": lbfgs,
    "newton": newton,
    "gradient_descent": gradient_descent,
    "proximal_grad": proximal_grad,
}


def solve(solver: str, **kwargs):
    if solver not in SOLVERS:
        raise ValueError(f"Unknown solver {solver!r}; options: {sorted(SOLVERS)}")
    beta, info = SOLVERS[solver](**kwargs)
    return check_finite_result(beta, info, solver)


# --------------------------------------------------------------------------
# One-vs-rest: C problems sharing one design matrix
# --------------------------------------------------------------------------

MULTI_KERNEL = "fused_glm_multi_value_grad"


def _stacked_loss(bflat, X, Y, mask, n_rows, lam, pmask_t, l1_ratio, family,
                  reg, n_classes):
    """The JAX ``_multi_stacked_body`` loss, plain torch: one (n, d) x
    (d, C) product serves every class's forward pass."""
    B = bflat.reshape(n_classes, -1)
    if X.dtype == torch.bfloat16:
        eta = X.to(torch.float32) @ B.to(torch.bfloat16).to(torch.float32).T
    else:
        eta = X @ B.T
    base = (get_family(family).pointwise(eta, Y.T) * mask[:, None]).sum() \
        / n_rows
    return base + regularizers.value(reg, bflat, lam, pmask_t, l1_ratio)


def _multi_kernel_loss(X, codes, n_rows, lam, pmask_t, l1_ratio, family, reg,
                       n_classes, reduce=None, n_valid=None):
    """Joint loss over the flat (C*d,) vector whose data term's value and
    gradient come from ONE read of X by the multi-target kernel; merged
    across processes under ``reduce`` as :func:`_kernel_loss` is."""
    nv = n_rows if n_valid is None else n_valid

    def data_vg(bflat):
        if not nv:
            v, g = merge_sums(reduce, _empty_vg(bflat))
            return v, g
        v, g = merge_sums(reduce, fused_glm_multi_value_grad(
            X, nv, codes, bflat.detach().reshape(n_classes, -1), family))
        return v, g.reshape(-1)

    return _data_sum_loss(data_vg, n_rows, lam, pmask_t, l1_ratio, reg)


def solve_multi(solver, X, Y, mask, n_rows, B0, family, reg, lam, pmask,
                l1_ratio=0.5, max_iter=100, tol=1e-6, **kwargs):
    """Solve C independent GLMs sharing ONE design matrix (one-vs-rest):
    ``Y`` (C, n) 0/1 targets with padding rows zeroed, ``B0`` (C, d)
    starts; returns ((C, d) betas as numpy, info).

    Logistic L-BFGS runs the C solves as ONE joint solve over the flat
    (C*d,) vector (the objective is separable, so the joint optimum is
    the per-class optima) with the stacked semantics of ``_lbfgs_loop``:
    its data term is ``fused_glm_multi_value_grad``, which builds the 0/1
    targets from class codes (one read of X per evaluation for every
    class), or with ``use_kernel=False`` the plain stacked loss. Every
    other solver, and lbfgs given other kwargs than ``memory`` (the
    checkpoint keys, as in the JAX package), runs a per-class loop of
    :func:`solve`; a ``checkpoint_path`` then holds one checkpoint per
    class, ``<path>/class<c>``.
    ``info["n_iter"]`` is the joint (or largest) count,
    ``info["n_iter_per_class"]`` each class's own."""
    use_kernel_arg = kwargs.pop("use_kernel", None)
    reduce = kwargs.pop("reduce", None)
    n_valid = kwargs.pop("n_valid", None)
    fs = kwargs.pop("fs", None)
    C, d = B0.shape
    if solver == "lbfgs" and family == "logistic" and \
            not {k for k in kwargs if k != "memory"}:
        _check_smooth(reg, solver)
        use_kernel, reason = resolve_kernel(use_kernel_arg, fs)
        pmask_t = pmask.repeat(C)
        if fs is not None:
            def tiled_vg(bflat):
                v, g = fs.value_grad(bflat.reshape(C, -1), Y, family)
                return v, g.reshape(-1)

            loss = _data_sum_loss(tiled_vg, n_rows, lam, pmask_t, l1_ratio,
                                  reg)
        elif use_kernel:
            codes = Y.argmax(0).to(torch.int32)
            loss = _multi_kernel_loss(X, codes, n_rows, lam, pmask_t,
                                      l1_ratio, family, reg, C, reduce,
                                      n_valid)
        elif reduce is not None:
            def vg(bflat):
                with torch.enable_grad():
                    b = bflat.detach().requires_grad_(True)
                    v = _stacked_loss(b, X, Y, mask, 1.0, 0.0, pmask_t,
                                      l1_ratio, family, "none", C)
                    (g,) = torch.autograd.grad(v, b)
                return merge_sums(reduce, (v.detach(), g))

            loss = _data_sum_loss(vg, n_rows, lam, pmask_t, l1_ratio, reg)
        else:
            def loss(bflat):
                return _stacked_loss(bflat, X, Y, mask, n_rows, lam, pmask_t,
                                     l1_ratio, family, reg, C)
        beta, it, gnorm, conv = _lbfgs_loop(
            loss, B0.reshape(-1), int(max_iter), float(tol),
            int(kwargs.get("memory", 10)), n_blocks=C)
        info = {"n_iter": int(it), "grad_norm": gnorm,
                "n_iter_per_class": _per_block_iters(conv, it).tolist(),
                **_kernel_info(use_kernel, reason, MULTI_KERNEL)}
        if use_kernel:
            info["fused_multi"] = True
        return check_finite_result(beta.reshape(C, d), info, solver)
    if use_kernel_arg is not None:
        kwargs["use_kernel"] = use_kernel_arg
    if reduce is not None:
        kwargs.update(reduce=reduce, n_valid=n_valid)
    if fs is not None:
        kwargs["fs"] = fs
    path = kwargs.pop("checkpoint_path", None)
    betas, iters, info_c = [], [], {}
    for c in range(C):
        if path:
            # one checkpoint per class: a class killed mid-solve never
            # resumes into another class's solve
            kwargs["checkpoint_path"] = os.path.join(path, f"class{c}")
        beta_c, info_c = solve(
            solver, X=X, y=Y[c], mask=mask, n_rows=n_rows, beta0=B0[c],
            family=family, reg=reg, lam=lam, pmask=pmask, l1_ratio=l1_ratio,
            max_iter=max_iter, tol=tol, **kwargs)
        betas.append(beta_c)
        iters.append(int(info_c.get("n_iter") or 0))
    if path and os.path.isdir(path) and not os.listdir(path):
        os.rmdir(path)
    info = {"n_iter": max(iters), "n_iter_per_class": iters}
    info.update({k: info_c[k] for k in ("kernel", "kernel_reason")
                 if k in info_c})
    return np.stack(betas), info


# --------------------------------------------------------------------------
# The C grid: k candidates differing only in the l2 strength
# --------------------------------------------------------------------------

def _lam_grid_loss(X, targets, mask, n_rows, lams, pmask, family, reg,
                   n_blocks):
    """The JAX ``_lam_grid_body``/``_lam_grid_multi_body`` loss over the
    flat (n_blocks * d,) vector, plain torch as the JAX package leaves it
    to XLA: one (n, d) x (d, n_blocks) product serves every block's
    forward pass; ``targets`` (n, n_blocks) and ``lams`` (n_blocks,)
    per block."""
    fam = get_family(family)

    def loss(bflat):
        B = bflat.reshape(n_blocks, -1)
        if X.dtype == torch.bfloat16:
            eta = X.to(torch.float32) @ B.to(torch.bfloat16).to(
                torch.float32).T
        else:
            eta = X @ B.T
        base = (fam.pointwise(eta, targets) * mask[:, None]).sum() / n_rows
        if reg == "none":
            return base
        bp = B * pmask[None, :]
        return base + 0.5 * (lams * (bp * bp).sum(1)).sum()

    return loss


def _lam_grid_run(loss, k_blocks, d, device, max_iter, tol, memory):
    b0 = torch.zeros(k_blocks * d, dtype=torch.float32, device=device)
    beta, it, gnorm, conv = _lbfgs_loop(loss, b0, int(max_iter), float(tol),
                                        int(memory), n_blocks=k_blocks)
    return beta, it, gnorm, _per_block_iters(conv, it)


def solve_lam_grid(X, y, mask, n_rows, lams, pmask, family, reg,
                   max_iter=100, tol=1e-6, memory=10):
    """k GLM solves differing only in the l2 strength as ONE stacked
    L-BFGS solve over the shared design (the stacked semantics of
    ``_lbfgs_loop``: one iteration budget, each block frozen at its own
    convergence point). Returns ((k, d) betas as numpy, info) with
    ``info["n_iter"]`` the joint count and ``"n_iter_per_candidate"``
    each candidate's; non-finite results raise."""
    _check_smooth(reg, "lbfgs")
    lams_t = torch.as_tensor(np.asarray(lams, np.float32), device=X.device)
    k = int(lams_t.shape[0])
    d = X.shape[1]
    pmask_t = torch.as_tensor(pmask, dtype=torch.float32, device=X.device)
    targets = y[:, None].expand(-1, k)
    loss = _lam_grid_loss(X, targets, mask, n_rows, lams_t, pmask_t, family,
                          reg, k)
    beta, it, gnorm, per = _lam_grid_run(loss, k, d, X.device, max_iter, tol,
                                         memory)
    info = {"n_iter": int(it), "grad_norm": gnorm, "lam_grid": k,
            "n_iter_per_candidate": per.tolist()}
    return check_finite_result(beta.reshape(k, d), info, "lbfgs")


def solve_lam_grid_multi(X, Y, mask, n_rows, lams, pmask, family, reg,
                         max_iter=100, tol=1e-6, memory=10):
    """The multiclass C grid: k candidates x C one-vs-rest classes as one
    stacked (k * C * d,) solve, block j = i * C + c solving class c at
    lam_i over the shared (C, n) targets. Returns ((k, C, d) betas,
    info); a candidate's own n_iter is its slowest class."""
    _check_smooth(reg, "lbfgs")
    lams_t = torch.as_tensor(np.asarray(lams, np.float32), device=X.device)
    k = int(lams_t.shape[0])
    C = int(Y.shape[0])
    d = X.shape[1]
    pmask_t = torch.as_tensor(pmask, dtype=torch.float32, device=X.device)
    targets = Y.T.repeat(1, k)                         # (n, k * C)
    loss = _lam_grid_loss(X, targets, mask, n_rows,
                          lams_t.repeat_interleave(C), pmask_t, family, reg,
                          k * C)
    beta, it, gnorm, per = _lam_grid_run(loss, k * C, d, X.device, max_iter,
                                         tol, memory)
    conv_kc = per.reshape(k, C)
    info = {"n_iter": int(it), "grad_norm": gnorm, "lam_grid": k,
            "n_classes": C,
            "n_iter_per_candidate": conv_kc.max(axis=1).tolist(),
            "n_iter_per_block": conv_kc.tolist()}
    return check_finite_result(beta.reshape(k, C, d), info, "lbfgs")
