"""GLM solvers: lbfgs, gradient_descent, proximal_grad.

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
the mean scaling stay plain torch on the (d,) vector.

``lbfgs`` follows optax's algorithm step for step (optax is not a
dependency of the port): ``optax.lbfgs(memory_size=10,
scale_init_precond=True)`` with ``scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy="one")``, the value and
gradient of the accepted step reused as ``value_and_grad_from_state``
does, and the stopping rule of the JAX ``_lbfgs_loop``: iterate while
``it < max_iter and ‖g‖ > tol``, with g the gradient at the iterate the
step starts from. Scalars of the line search are Python floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.fused import fused_glm_value_grad
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


def _kernel_loss(X, y, n_rows, lam, pmask, l1_ratio, family, reg):
    """Smooth loss whose data term's value and gradient come from ONE
    read of X by the fused kernel (rows < n_rows are the valid prefix)."""

    def data_vg(beta):
        return fused_glm_value_grad(X, n_rows, y, beta.detach(), family)

    def loss(beta):
        return _KernelDataSum.apply(beta, data_vg) / n_rows + \
            regularizers.value(reg, beta, lam, pmask, l1_ratio)

    return loss


def resolve_kernel(use_kernel):
    """(use the fused kernel?, why not) — the counterpart of
    ``_resolve_pallas``. The kernel takes every design the solvers give
    it (any d, f32 or bf16, the three families), so only the caller's
    ``use_kernel=False`` keeps the plain loss; on the CPU the kernel's
    wrapper is its plain version."""
    if use_kernel is False:
        return False, "use_kernel=False"
    return True, None


def _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask, l1_ratio,
                 family, reg):
    """The ONE place a solver picks its smooth loss."""
    if use_kernel:
        return _kernel_loss(X, y, n_rows, lam, pmask, l1_ratio, family, reg)

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


def _lbfgs_loop(loss, beta0, max_iter, tol, memory):
    """optax L-BFGS iterations until ``it == max_iter`` or ‖g‖ <= tol."""
    def vg(b):
        return _value_and_grad(loss, b)

    search = _ZoomLinesearch(vg)
    d = beta0.shape[0]
    zeros = dict(dtype=beta0.dtype, device=beta0.device)
    dW = torch.zeros((memory, d), **zeros)
    dU = torch.zeros((memory, d), **zeros)
    rhos = torch.zeros(memory, **zeros)
    prev_params = torch.zeros(d, **zeros)
    prev_grad = torch.zeros(d, **zeros)
    beta = beta0
    state_value, state_grad = math.inf, None
    gnorm, it = math.inf, 0
    while it < max_iter and gnorm > tol:
        # value_and_grad_from_state: reuse the line search's evaluation
        if math.isfinite(state_value):
            value, grad = state_value, state_grad
        else:
            v, grad = vg(beta)
            value = float(v)
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
        gnorm = float(torch.linalg.vector_norm(grad))
        it += 1
    return beta, it, gnorm


def lbfgs(X, y, mask, n_rows, beta0, family, reg, lam, pmask, l1_ratio=0.5,
          max_iter=100, tol=1e-6, memory=10, use_kernel=None, **_):
    _check_smooth(reg, "lbfgs")
    use_kernel, reason = resolve_kernel(use_kernel)
    loss = _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask,
                        l1_ratio, family, reg)
    beta, it, gnorm = _lbfgs_loop(loss, beta0, int(max_iter), float(tol),
                                  int(memory))
    return beta, {"n_iter": int(it), "grad_norm": gnorm,
                  **_kernel_info(use_kernel, reason)}


def _kernel_info(use_kernel, reason):
    return {"kernel": KERNEL if use_kernel else None,
            "kernel_reason": reason}


# --------------------------------------------------------------------------
# Gradient descent with Armijo backtracking (dask_glm::gradient_descent)
# --------------------------------------------------------------------------

def gradient_descent(X, y, mask, n_rows, beta0, family, reg, lam, pmask,
                     l1_ratio=0.5, max_iter=100, tol=1e-6, init_step=1.0,
                     armijo=1e-4, backtrack=0.5, grow=2.0, use_kernel=None,
                     **_):
    _check_smooth(reg, "gradient_descent")
    use_kernel, reason = resolve_kernel(use_kernel)
    loss = _select_loss(use_kernel, X, y, mask, n_rows, lam, pmask,
                        l1_ratio, family, reg)
    beta, step = beta0, _f32(init_step)
    gnorm, it = math.inf, 0
    while it < max_iter and gnorm > tol:
        v, grad = _value_and_grad(loss, beta)
        val, g2 = _scalars(v, torch.dot(grad, grad))
        t = step
        # the Armijo test in float32, as the JAX loop makes it: near
        # convergence a decrease below float32 resolution must pass
        while t > 1e-20 and np.float32(_value(loss, beta - t * grad)) > \
                np.float32(val) - np.float32(armijo) * np.float32(t) \
                * np.float32(g2):
            t = _f32(t * backtrack)
        beta = beta - t * grad
        step = _f32(t * grow)
        gnorm = math.sqrt(g2)
        it += 1
    return beta, {"n_iter": it, "grad_norm": gnorm,
                  **_kernel_info(use_kernel, reason)}


# --------------------------------------------------------------------------
# Proximal gradient with backtracking (dask_glm::proximal_grad)
# --------------------------------------------------------------------------

def proximal_grad(X, y, mask, n_rows, beta0, family, reg, lam, pmask,
                  l1_ratio=0.5, max_iter=100, tol=1e-7, init_step=1.0,
                  backtrack=0.5, grow=1.2, use_kernel=None, **_):
    use_kernel, reason = resolve_kernel(use_kernel)
    # the penalty is the prox's: the selected loss is the smooth data term
    smooth = _select_loss(use_kernel, X, y, mask, n_rows, 0.0, pmask,
                          l1_ratio, family, "none")

    def candidate(beta, grad, t):
        return regularizers.prox(reg, beta - t * grad, lam, t, pmask,
                                 l1_ratio)

    beta, step = beta0, _f32(init_step)
    delta, it = math.inf, 0
    while it < max_iter and delta > tol:
        val_t, grad = _value_and_grad(smooth, beta)
        t = step
        while t > 1e-20:
            z = candidate(beta, grad, t)
            dz = z - beta
            quad = val_t + torch.dot(grad, dz) + (dz * dz).sum() / (2.0 * t)
            fz, q = _scalars(_value(smooth, z), quad)
            if not fz > q:
                break
            t = _f32(t * backtrack)
        z = candidate(beta, grad, t)
        delta = float(torch.linalg.vector_norm(z - beta)) / max(t, 1e-20)
        beta, step = z, _f32(t * grow)
        it += 1
    return beta, {"n_iter": it, "opt_residual": delta,
                  **_kernel_info(use_kernel, reason)}


def newton(*_, **__):
    raise NotImplementedError(
        "solver='newton' is not ported yet: ROADMAP queue 1 item 2 (its "
        "kernel fused_glm_value_grad_hess is queue 2 item 3)"
    )


def admm(*_, **__):
    raise NotImplementedError(
        "solver='admm' is not ported yet: ROADMAP queue 1 item 2"
    )


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
