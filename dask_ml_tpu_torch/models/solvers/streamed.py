"""Out-of-core GLM solvers: loss, gradient and Hessian summed over
streamed host blocks.

Counterpart of ``dask_ml_tpu/models/solvers/streamed.py``. The data stays
on the host (numpy or ``np.memmap``); ``parallel.streaming.BlockStream``
moves it through the device in fixed-height blocks, and one objective
evaluation is one pass over the blocks. A pass launches one kernel per
block, each adding its block's sums into device accumulators in block
order (``ops.fused.fused_glm_stream`` / ``fused_glm_multi_stream``, the
"fused" flavour), or runs the per-block functions below in plain torch
(the plain flavour, ``solver_kwargs={"use_kernel": False}``). The host
reads the pass's scalars and vectors once, at its end. The host solvers
keep the JAX package's float64 numpy state and its pass budget:

- ``lbfgs``: 1 + line-search trials (Armijo) per iteration
- ``gradient_descent``: 1 + trials
- ``proximal_grad``: 1 + trials
- ``newton``: 1 (value, gradient and Hessian in one pass) + halvings
- ``admm``: exactly 1 (block-local Newton solves in plain torch, as the
  JAX package leaves them to XLA)

Flavour policy (``StreamedObjective._flavor``): the kernels unless the
caller asks ``use_kernel=False``; the one-vs-rest Hessian stays plain
(``"multiclass-hessian-plain"``); under ``config.dtype="bfloat16"`` the
"vg" passes take bf16 operands while "val" and "vgh" stay f32, the JAX
``_sb_flavor`` rule.

Sparse X on the stream's nnz route (``BlockStream.nnz_route``, the
blocks ``SparseSlab``s): "val" and "vg" run the plain sparse products of
``ops/sparse_kernels.py`` at nnz cost (the JAX ``_sparse_reducer_sums``,
its gradient written out as ``Xᵀr``, one-vs-rest as ``XᵀR``); "vgh"
scatters the block dense on the device and launches the Newton kernel
(``fused_glm_stream("vgh")``) on it, the one-vs-rest Hessian staying
plain. ``solver_info_`` records ``sparse_stream`` and
``sparse_stream_reason`` with the JAX reasons; ADMM's block-local Newton
takes the densify route (``"admm-local-newton"``).

Every solver takes ``ckpt`` (``reliability/stream_ckpt.py``, None =
off): its host state (already float64 numpy, or ADMM's float32 block
state) is saved as it is after each outer iteration that
``ckpt.due``, restored at the start when a checkpoint of the same fit
exists (``stream_resumes`` counts), and cleared on completion, so a
resumed fit is bit-equal to an uninterrupted one and its ``data_passes``
add up to the same count.

Several processes: ``reduce`` (``distributed.psum_host``, as the JAX
solvers take it) merges each pass's sums across processes. Every process
streams only its own rows; the pass's device sums (the loss, the
gradient, the Hessian of kernels 6 and 7, or their plain versions) come
to the host once, merge in float64 in rank order and go back to the
device as float32 for the epilogue, so every process holds the
identical global objective (``n_rows`` is the global count) and the
host solvers, run alike on every process, never diverge. ADMM's
consensus spans every process's blocks: the z-update and the residuals
take global sums and the global block count. Without a reduce nothing
changes. The feature-sharded flavours wait for ROADMAP.md queue 1,
Multi-GPU (feature sharding).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import fit_dtype_info, mxu_dtype
from ...ops.fused import (
    fused_glm_multi_stream, fused_glm_stream, glm_multi_stream_acc,
    glm_stream_acc,
)
from ...ops.sparse_kernels import (sparse_eta, sparse_eta_multi,
                                   sparse_xt_R, sparse_xt_r)
from ...parallel.streaming import block_dense
from ...reliability.stream_ckpt import restore_counted
from . import regularizers
from .families import get_family
from .solvers import check_finite_result, merge_sums


# ---------------------------------------------------------------------------
# per-block functions of the plain flavour: the sums over a block's rows
# < n, beta (d[+1],) f32 with the intercept last
# ---------------------------------------------------------------------------

def _eta(X, b, intercept):
    return X @ b[:-1] + b[-1] if intercept else X @ b


def _block_val_grad(beta, X, y, n, family, intercept):
    """(Σ pointwise NLL, Σ ∂NLL/∂β) over one block's valid rows."""
    Xv, yv = X[:n], y[:n]
    with torch.enable_grad():
        b = beta.detach().requires_grad_(True)
        v = get_family(family).pointwise(_eta(Xv, b, intercept), yv).sum()
        (g,) = torch.autograd.grad(v, b)
    return v.detach(), g


def _block_val(beta, X, y, n, family, intercept):
    """Σ pointwise NLL: the trials that need only the value skip the
    gradient."""
    Xv, yv = X[:n], y[:n]
    return get_family(family).pointwise(_eta(Xv, beta, intercept), yv).sum()


def _bordered_hess(Xv, w, intercept):
    Xw = Xv * w[:, None]
    h = Xw.T @ Xv
    if intercept:
        col = Xw.sum(0)
        h = torch.cat([torch.cat([h, col[:, None]], 1),
                       torch.cat([col, w.sum()[None]])[None, :]], 0)
    return h


def _block_val_grad_hess(beta, X, y, n, family, intercept):
    """(Σ NLL, Σ grad, Σ Xᵀ W X) for Newton, bordered by Xᵀw and Σ w
    with an intercept."""
    val, grad = _block_val_grad(beta, X, y, n, family, intercept)
    Xv, yv = X[:n], y[:n]
    w = get_family(family).hess_weight(_eta(Xv, beta, intercept), yv)
    return val, grad, _bordered_hess(Xv, w, intercept)


def _finish_vg(val_sum, grad_sum, beta, n_rows, lam, pmask, l1_ratio, reg):
    """mean NLL + smooth penalty and its gradient from the block sums,
    in f32 on the device."""
    with torch.enable_grad():
        b = beta.detach().requires_grad_(True)
        pen = regularizers.value(reg, b, lam, pmask, l1_ratio)
        pen_g = (torch.autograd.grad(pen, b)[0] if pen.requires_grad
                 else torch.zeros_like(beta))
    return val_sum / n_rows + pen.detach(), grad_sum / n_rows + pen_g


# -- one-vs-rest: one pass of the data serves all C classes -----------------

def onehot_targets(y, classes):
    """(C, n) one-vs-rest targets: the one place the encoding lives."""
    return (y[None, :] == classes[:, None]).to(torch.float32)


def _codes_onehot(y, n_classes):
    return onehot_targets(y, torch.arange(n_classes, dtype=y.dtype,
                                          device=y.device))


def _eta_multi(X, B, intercept):
    return X @ B[:, :-1].T + B[:, -1] if intercept else X @ B.T


def _block_val_grad_multi(B, X, y, n, family, intercept, n_classes):
    """(Σ over rows and classes of NLL, ∂/∂B (C, d[+1])) for one block;
    ``y`` holds class codes 0..C-1."""
    Xv, Y = X[:n], _codes_onehot(y[:n], n_classes)
    with torch.enable_grad():
        Bg = B.detach().requires_grad_(True)
        v = get_family(family).pointwise(_eta_multi(Xv, Bg, intercept),
                                         Y.T).sum()
        (g,) = torch.autograd.grad(v, Bg)
    return v.detach(), g


def _block_val_multi(B, X, y, n, family, intercept, n_classes):
    Xv, Y = X[:n], _codes_onehot(y[:n], n_classes)
    return get_family(family).pointwise(_eta_multi(Xv, B, intercept),
                                        Y.T).sum()


def _block_val_grad_hess_multi(B, X, y, n, family, intercept, n_classes):
    """(Σ NLL, grad (C, d[+1]), per-class Hessians (C, D, D))."""
    val, grad = _block_val_grad_multi(B, X, y, n, family, intercept,
                                      n_classes)
    Xv, Y = X[:n], _codes_onehot(y[:n], n_classes)
    fam = get_family(family)
    eta = _eta_multi(Xv, B, intercept)
    hess = torch.stack([_bordered_hess(Xv, fam.hess_weight(eta[:, c], Y[c]),
                                       intercept)
                        for c in range(n_classes)])
    return val, grad, hess


def _admm_local_body(X, y, n, b, u, z, rho, n_rows, local_iter, family,
                     intercept):
    """ADMM block-local Newton steps toward the prox target v = z - u:
    the JAX ``_admm_local_body`` (the in-memory shard-local solve with the
    shard replaced by the block), in plain torch."""
    fam = get_family(family)
    Xv, yv = X[:n], y[:n]
    v = z - u
    eye = torch.eye(b.shape[0], dtype=b.dtype, device=b.device)
    for _ in range(local_iter):
        eta = _eta(Xv, b, intercept)
        resid = fam.mean(eta) - yv
        gx = Xv.T @ resid
        if intercept:
            gx = torch.cat([gx, resid.sum()[None]])
        g = gx / n_rows + rho * (b - v)
        h = _bordered_hess(Xv, fam.hess_weight(eta, yv), intercept) / n_rows
        b = b - torch.linalg.solve(h + rho * eye, g)
    return b


def _block_admm_local_multi(X, y, n, B, U, Z, rho, n_rows, local_iter,
                            family, intercept, n_classes):
    """Per-class block-local ADMM Newton: one block read serves all C
    consensus problems. B, U, Z are (C, d[+1]); y holds class codes."""
    Y = _codes_onehot(y[:n], n_classes)
    return torch.stack([
        _admm_local_body(X, Y[c], n, B[c], U[c], Z[c], rho, n_rows,
                         local_iter, family, intercept)
        for c in range(n_classes)])


# -- the sparse flavour: one SparseSlab's sums at nnz cost -----------------

def _sparse_block(kind, beta, x, y, n, family, intercept):
    """(Σ NLL,) or (Σ NLL, Σ grad) of one sparse block's rows < n: eta by
    ``sparse_eta``, the gradient ``Xᵀr`` over the residual zeroed past n,
    the intercept's entry Σ resid."""
    fam = get_family(family)
    w = beta[:-1] if intercept else beta
    eta = sparse_eta(x.data, x.cols, x.rows, w, x.n_rows, x.indptr)[:n]
    if intercept:
        eta = eta + beta[-1]
    yv = y[:n]
    val = fam.pointwise(eta, yv).sum()
    if kind == "val":
        return (val,)
    resid = torch.zeros(x.n_rows, dtype=torch.float32, device=y.device)
    resid[:n] = fam.mean(eta) - yv
    g = sparse_xt_r(x.data, x.cols, x.rows, resid, x.n_features,
                    x.by_col())
    if intercept:
        g = torch.cat([g, resid.sum()[None]])
    return val, g


def _sparse_block_multi(kind, B, x, y, n, family, intercept, n_classes):
    """The one-vs-rest twin of :func:`_sparse_block`: eta (S, C) by
    ``sparse_eta_multi``, the gradient (C, d[+1]) by ``XᵀR``."""
    fam = get_family(family)
    W = B[:, :-1] if intercept else B
    eta = sparse_eta_multi(x.data, x.cols, x.rows, W, x.n_rows,
                           x.indptr)[:n]
    if intercept:
        eta = eta + B[:, -1][None, :]
    Y = _codes_onehot(y[:n], n_classes).T            # (n, C)
    val = fam.pointwise(eta, Y).sum()
    if kind == "val":
        return (val,)
    R = torch.zeros((x.n_rows, n_classes), dtype=torch.float32,
                    device=y.device)
    R[:n] = fam.mean(eta) - Y
    g = sparse_xt_R(x.data, x.cols, x.rows, R, x.n_features,
                    x.by_col()).T
    if intercept:
        g = torch.cat([g, R.sum(0)[:, None]], 1)
    return val, g


# ---------------------------------------------------------------------------
# streamed objective: one call = one pass over the stream
# ---------------------------------------------------------------------------

class StreamedObjective:
    """The objective over a ``BlockStream``; counts data passes.

    A pass returns a host ``float`` value and ``float64`` numpy vectors,
    as in the JAX package."""

    n_classes = None  # the one-vs-rest subclass sets it

    def __init__(self, stream, n_rows, lam, pmask, l1_ratio, family, reg,
                 intercept, fit_dtype=None, use_kernel=True, reduce=None):
        self.stream = stream
        self.reduce = reduce
        self.n_rows = float(n_rows)
        dev = stream.device
        # lam as the JAX objective holds it (float32), for the device
        # epilogue and, as a Python float, for the host solvers
        self.lam_value = float(np.float32(lam))
        self.lam = torch.tensor(self.lam_value, dtype=torch.float32,
                                device=dev)
        self.pmask = torch.as_tensor(np.asarray(pmask, np.float32),
                                     device=dev)
        self.l1_ratio = l1_ratio
        self.family = family
        self.reg = reg
        self.intercept = intercept
        self.fit_dtype = fit_dtype
        self.use_kernel = use_kernel
        self.passes = 0

    def _smooth_clone(self):
        """The same objective without the penalty (the proximal solvers
        take the penalty in the prox)."""
        return type(self)(
            self.stream, self.n_rows, 0.0, self.pmask.cpu().numpy(),
            self.l1_ratio, self.family, "none", self.intercept,
            fit_dtype=self.fit_dtype, use_kernel=self.use_kernel,
            reduce=self.reduce, **self._clone_kwargs())

    def _clone_kwargs(self):
        return {}

    def _flavor(self, kind):
        """(mxu, fused, reason) of the ``kind`` pass: the kernels unless
        ``use_kernel=False``; the one-vs-rest Hessian plain; bf16
        operands only for "vg" (the JAX ``_sb_flavor`` rule: a bf16 value
        beside the f32 Hessian's would reject Newton steps near the
        optimum)."""
        if not self.use_kernel:
            return None, False, "use_kernel=False"
        if self.n_classes and kind == "vgh":
            return None, False, "multiclass-hessian-plain"
        if self.stream.nnz_route and kind != "vgh":
            # the sparse products run at nnz cost, in f32
            return None, False, "sparse-stream"
        if kind in ("vgh", "val"):
            return None, True, None
        return mxu_dtype(self.fit_dtype), True, None

    def _beta(self, beta):
        return torch.as_tensor(np.asarray(beta, np.float32),
                               device=self.stream.device)

    def _pass(self, kind, beta):
        """The ``kind`` sums of one pass: device tensors (loss,), (loss,
        grad) or (loss, grad, hess)."""
        mxu, fused, _ = self._flavor(kind)
        d = self.stream.arrays[0].shape[1]
        if fused:
            acc = glm_stream_acc(kind, d, self.intercept, self.stream.device)
            out = None
            for blk in self.stream:
                Xb, yb = blk.arrays
                # the nnz route's Newton pass: the block scattered dense
                # on the device, then the kernel
                out = fused_glm_stream(kind, block_dense(Xb), blk.n_rows,
                                       yb, beta, self.family, self.intercept,
                                       mxu=mxu, acc=acc)
            return out
        fn = {"val": _block_val, "vg": _block_val_grad,
              "vgh": _block_val_grad_hess}[kind]
        sums = None
        for blk in self.stream:
            Xb, yb = blk.arrays
            if self.stream.nnz_route and kind != "vgh":
                out = _sparse_block(kind, beta, Xb, yb, blk.n_rows,
                                    self.family, self.intercept)
            else:
                out = fn(beta, block_dense(Xb), yb, blk.n_rows, self.family,
                         self.intercept)
            out = out if isinstance(out, tuple) else (out,)
            sums = out if sums is None else tuple(a + o for a, o in
                                                  zip(sums, out))
        return sums

    def _host(self, val, *vecs):
        """The pass's value and vectors on the host in one transfer."""
        flat = torch.cat([val.reshape(1)] + [v.reshape(-1) for v in vecs])
        flat = flat.cpu().numpy()
        out, i = [float(flat[0])], 1
        for v in vecs:
            out.append(flat[i:i + v.numel()].astype(np.float64)
                       .reshape(v.shape))
            i += v.numel()
        return out

    def value_and_grad(self, beta):
        self.passes += 1
        b = self._beta(beta)
        vs, gs = merge_sums(self.reduce, self._pass("vg", b))
        val, grad = _finish_vg(vs, gs, b, self.n_rows, self.lam,
                               self.pmask, self.l1_ratio, self.reg)
        return tuple(self._host(val, grad))

    def value(self, beta):
        self.passes += 1
        b = self._beta(beta)
        (vs,) = merge_sums(self.reduce, self._pass("val", b))
        pen = regularizers.value(self.reg, b, self.lam, self.pmask,
                                 self.l1_ratio)
        return self._host(vs / self.n_rows + pen)[0]

    def value_and_grad_and_hess(self, beta):
        self.passes += 1
        b = self._beta(beta)
        vs, gs, hs = merge_sums(self.reduce, self._pass("vgh", b))
        val, grad = _finish_vg(vs, gs, b, self.n_rows, self.lam,
                               self.pmask, self.l1_ratio, self.reg)
        val, grad, hess = self._host(val, grad, hs)
        return val, grad, hess / self.n_rows


class MulticlassStreamedObjective(StreamedObjective):
    """Sum of C one-vs-rest objectives over ONE shared pass. The host
    solvers see a flat (C * d,) vector (the joint objective is separable
    across classes); ``pmask`` arrives tiled to (C * d,). Newton and ADMM
    read ``n_classes`` to keep the per-class structure."""

    def __init__(self, *args, n_classes=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_classes = n_classes

    def _clone_kwargs(self):
        return {"n_classes": self.n_classes}

    def _pass(self, kind, beta):
        mxu, fused, _ = self._flavor(kind)
        C = self.n_classes
        B = beta.reshape(C, -1)
        d = self.stream.arrays[0].shape[1]
        if fused:
            acc = glm_multi_stream_acc(kind, d, C, self.intercept,
                                       self.stream.device)
            out = None
            for blk in self.stream:
                Xb, yb = blk.arrays
                out = fused_glm_multi_stream(kind, Xb, blk.n_rows, yb, B,
                                             self.family, self.intercept,
                                             mxu=mxu, acc=acc)
            return out
        fn = {"val": _block_val_multi, "vg": _block_val_grad_multi,
              "vgh": _block_val_grad_hess_multi}[kind]
        sums = None
        for blk in self.stream:
            Xb, yb = blk.arrays
            if self.stream.nnz_route and kind != "vgh":
                out = _sparse_block_multi(kind, B, Xb, yb, blk.n_rows,
                                          self.family, self.intercept, C)
            else:
                out = fn(B, block_dense(Xb), yb, blk.n_rows, self.family,
                         self.intercept, C)
            out = out if isinstance(out, tuple) else (out,)
            sums = out if sums is None else tuple(a + o for a, o in
                                                  zip(sums, out))
        return sums

    def value_and_grad(self, beta):
        self.passes += 1
        b = self._beta(beta)
        vs, gs = merge_sums(self.reduce, self._pass("vg", b))
        val, grad = _finish_vg(vs, gs.reshape(-1), b, self.n_rows, self.lam,
                               self.pmask, self.l1_ratio, self.reg)
        return tuple(self._host(val, grad))

    def value_and_grad_and_hess(self, beta):
        self.passes += 1
        b = self._beta(beta)
        vs, gs, hs = merge_sums(self.reduce, self._pass("vgh", b))
        val, grad = _finish_vg(vs, gs.reshape(-1), b, self.n_rows, self.lam,
                               self.pmask, self.l1_ratio, self.reg)
        val, grad, hess = self._host(val, grad, hs)
        return val, grad, hess / self.n_rows


def _armijo(obj, beta, val, grad, direction, t0=1.0, c=1e-4, backtrack=0.5,
            max_trials=30):
    """Backtracking line search; each trial is one data pass. Returns
    (t, direction, new_val, new_grad) at the accepted point."""
    dg = float(grad @ direction)
    if dg >= 0:  # numerical non-descent: fall back to steepest descent
        direction = -grad
        dg = -float(grad @ grad)
    t = t0
    for _ in range(max_trials):
        nv, ng = obj.value_and_grad(beta + t * direction)
        if nv <= val + c * t * dg or t <= 1e-20:
            return t, direction, nv, ng
        t *= backtrack
    return t, direction, nv, ng


# ---------------------------------------------------------------------------
# solvers: host optimizer state (a few float64 d-vectors) over streamed
# device evaluation
# ---------------------------------------------------------------------------

def _finish(ckpt):
    if ckpt is not None:
        ckpt.clear()


def lbfgs(obj: StreamedObjective, beta0, max_iter=100, tol=1e-6, memory=10,
          ckpt=None, **_):
    if obj.reg not in regularizers.SMOOTH:
        raise ValueError(
            "streamed lbfgs handles smooth penalties only (l2/none); use "
            "solver='proximal_grad' or 'admm' for l1/elastic_net"
        )
    beta = np.asarray(beta0, np.float64)
    S, Y = [], []
    it0 = n_iter = 0
    st = restore_counted(ckpt)
    if st is not None:
        beta = np.asarray(st["beta"], np.float64)
        val = float(st["val"])
        grad = np.asarray(st["grad"], np.float64)
        if "S" in st:
            S = [np.asarray(r, np.float64) for r in st["S"]]
            Y = [np.asarray(r, np.float64) for r in st["Y"]]
        it0 = n_iter = int(st["it"])
        obj.passes = int(st["passes"])
    else:
        val, grad = obj.value_and_grad(beta)
    # each iteration's |g| at its start and its line search's passes
    gnorms, trials = [], []
    for it in range(it0, int(max_iter)):
        gnorms.append(float(np.linalg.norm(grad)))
        if gnorms[-1] <= tol:
            break
        # two-loop recursion on the host (d-vectors; no data touched)
        q = grad.copy()
        alphas = []
        for s, y_ in zip(reversed(S), reversed(Y)):
            rho = 1.0 / float(y_ @ s)
            a = rho * float(s @ q)
            q -= a * y_
            alphas.append((rho, a))
        if Y:
            q *= float(S[-1] @ Y[-1]) / float(Y[-1] @ Y[-1])
        for (rho, a), s, y_ in zip(reversed(alphas), S, Y):
            q += (a - rho * float(y_ @ q)) * s
        p0 = obj.passes
        t, direction, nv, ng = _armijo(obj, beta, val, grad, -q)
        trials.append(obj.passes - p0)
        s = t * direction
        y_ = ng - grad
        if float(s @ y_) > 1e-10 * np.linalg.norm(s) * np.linalg.norm(y_):
            S.append(s)
            Y.append(y_)
            if len(S) > memory:
                S.pop(0)
                Y.pop(0)
        beta = beta + s
        val, grad = nv, ng
        n_iter = it + 1
        if ckpt is not None and ckpt.due(n_iter):
            ckpt.save(beta=beta, val=np.float64(val), grad=grad, it=n_iter,
                      passes=obj.passes, S=np.stack(S) if S else None,
                      Y=np.stack(Y) if Y else None)
    _finish(ckpt)
    return beta, {"n_iter": n_iter, "grad_norm": float(np.linalg.norm(grad)),
                  "data_passes": obj.passes, "grad_norms": gnorms,
                  "armijo_trials": trials}


def gradient_descent(obj: StreamedObjective, beta0, max_iter=100, tol=1e-6,
                     init_step=1.0, ckpt=None, **_):
    if obj.reg not in regularizers.SMOOTH:
        raise ValueError(
            "streamed gradient_descent handles smooth penalties only"
        )
    beta = np.asarray(beta0, np.float64)
    it0 = n_iter = 0
    st = restore_counted(ckpt)
    if st is not None:
        beta = np.asarray(st["beta"], np.float64)
        val = float(st["val"])
        grad = np.asarray(st["grad"], np.float64)
        step = float(st["step"])
        it0 = n_iter = int(st["it"])
        obj.passes = int(st["passes"])
    else:
        val, grad = obj.value_and_grad(beta)
        step = init_step
    for it in range(it0, int(max_iter)):
        if float(np.linalg.norm(grad)) <= tol:
            break
        t, direction, nv, ng = _armijo(obj, beta, val, grad, -grad, t0=step)
        beta = beta + t * direction
        val, grad = nv, ng
        step = t * 2.0
        n_iter = it + 1
        if ckpt is not None and ckpt.due(n_iter):
            ckpt.save(beta=beta, val=np.float64(val), grad=grad,
                      step=np.float64(step), it=n_iter, passes=obj.passes)
    _finish(ckpt)
    return beta, {"n_iter": n_iter, "grad_norm": float(np.linalg.norm(grad)),
                  "data_passes": obj.passes}


def newton(obj: StreamedObjective, beta0, max_iter=50, tol=1e-6, ckpt=None,
           **_):
    if obj.reg not in regularizers.SMOOTH:
        raise ValueError("streamed newton handles smooth penalties only")
    beta = np.asarray(beta0, np.float64)
    d = beta.shape[0]
    pmask = obj.pmask.cpu().numpy().astype(np.float64)
    ridge = (obj.lam_value * pmask if obj.reg == "l2"
             else np.zeros(d)) + 1e-8
    it0 = n_iter = 0
    st = restore_counted(ckpt)
    if st is not None:
        # the value, gradient and Hessian are evaluated at the loop's top:
        # the iterate and the clocks are the whole state
        beta = np.asarray(st["beta"], np.float64)
        it0 = n_iter = int(st["it"])
        obj.passes = int(st["passes"])
    gnorm = np.inf
    for it in range(it0, int(max_iter)):
        val, grad, hess = obj.value_and_grad_and_hess(beta)
        gnorm = float(np.linalg.norm(grad))
        if gnorm <= tol:
            break
        if obj.n_classes:
            # per-class (d, d) solves against the block-diagonal Hessian
            C = obj.n_classes
            G = grad.reshape(C, -1)
            R = ridge.reshape(C, -1)
            delta = np.concatenate([
                np.linalg.lstsq(hess[c] + np.diag(R[c]), G[c], rcond=None)[0]
                for c in range(C)
            ])
        else:
            delta = np.linalg.lstsq(hess + np.diag(ridge), grad,
                                    rcond=None)[0]
        t = 1.0
        while t > 1e-6:
            if obj.value(beta - t * delta) <= val:
                break
            t *= 0.5
        beta = beta - t * delta
        n_iter = it + 1
        if ckpt is not None and ckpt.due(n_iter):
            ckpt.save(beta=beta, it=n_iter, passes=obj.passes)
    _finish(ckpt)
    return beta, {"n_iter": n_iter, "grad_norm": gnorm,
                  "data_passes": obj.passes}


def _prox_host(reg, v, lam, t, pmask, l1_ratio):
    """The penalty's prox of a host vector, in float32 as the JAX solver
    evaluates it, back as float64."""
    out = regularizers.prox(reg, torch.as_tensor(np.asarray(v, np.float32)),
                            lam, t, pmask, l1_ratio)
    return out.numpy().astype(np.float64)


def proximal_grad(obj: StreamedObjective, beta0, max_iter=100, tol=1e-7,
                  init_step=1.0, ckpt=None, **_):
    # the penalty is the prox's: the streamed objective evaluates the
    # smooth part only
    smooth = obj._smooth_clone()
    lam = obj.lam_value
    pmask = obj.pmask.cpu()
    beta = np.asarray(beta0, np.float64)
    it0 = n_iter = 0
    st = restore_counted(ckpt)
    if st is not None:
        beta = np.asarray(st["beta"], np.float64)
        val = float(st["val"])
        grad = np.asarray(st["grad"], np.float64)
        step = float(st["step"])
        it0 = n_iter = int(st["it"])
        smooth.passes = int(st["passes"])
    else:
        val, grad = smooth.value_and_grad(beta)
        step = init_step
    delta = np.inf
    for it in range(it0, int(max_iter)):
        t = step
        while True:
            z = _prox_host(obj.reg, beta - t * grad, lam, t, pmask,
                           obj.l1_ratio)
            dz = z - beta
            quad = val + float(grad @ dz) + float(dz @ dz) / (2.0 * t)
            # value AND gradient in the trial pass: the accepted
            # candidate's gradient is reused, so acceptance costs no
            # extra pass
            zv, zg = smooth.value_and_grad(z)
            if zv <= quad or t <= 1e-20:
                break
            t *= 0.5
        delta = float(np.linalg.norm(z - beta)) / max(t, 1e-20)
        beta = z
        val, grad = zv, zg
        step = t * 1.2
        n_iter = it + 1
        if ckpt is not None and ckpt.due(n_iter):
            ckpt.save(beta=beta, val=np.float64(val), grad=grad,
                      step=np.float64(step), it=n_iter,
                      passes=smooth.passes)
        if delta <= tol:
            break
    _finish(ckpt)
    obj.passes = smooth.passes
    return beta, {"n_iter": n_iter, "opt_residual": float(delta),
                  "data_passes": obj.passes}


def admm(obj: StreamedObjective, beta0, max_iter=250, tol=1e-4, rho=1.0,
         local_iter=8, ckpt=None, **_):
    """Block-consensus ADMM: each streamed block is a consensus member
    (the in-memory solver's mesh shard). Per-block (b, u) state is
    (n_blocks, d) on the host, tiny next to X."""
    reg = obj.reg
    lam = obj.lam_value
    if reg == "none":
        reg, lam = "l2", 0.0
    stream = obj.stream
    dev = stream.device
    n_blocks = stream.n_blocks
    # the consensus spans every process's blocks: global sums and counts
    reduce = obj.reduce or (lambda a: a)
    glob_blocks = int(reduce(np.asarray(float(n_blocks))))
    d = len(np.asarray(beta0))
    B = np.tile(np.asarray(beta0, np.float32)[None], (n_blocks, 1))
    U = np.zeros((n_blocks, d), np.float32)
    z = np.asarray(beta0, np.float32)
    pmask = obj.pmask.cpu()
    rho_f = float(rho)
    it0 = n_iter = 0
    st = restore_counted(ckpt)
    if st is not None and st["B"].shape == B.shape:
        B = np.asarray(st["B"], np.float32)
        U = np.asarray(st["U"], np.float32)
        z = np.asarray(st["z"], np.float32)
        rho_f = float(st["rho"])
        it0 = n_iter = int(st["it"])
        obj.passes = int(st["passes"])
    primal = dual = np.inf
    C = obj.n_classes

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    for it in range(it0, int(max_iter)):
        obj.passes += 1
        z_d = torch.as_tensor(z, device=dev)
        for bi, blk in enumerate(stream):
            Xb, yb = blk.arrays
            b_d = torch.as_tensor(B[bi], device=dev)
            u_d = torch.as_tensor(U[bi], device=dev)
            if C:
                # one block read serves all C consensus problems
                nb = _block_admm_local_multi(
                    Xb, yb, blk.n_rows, b_d.reshape(C, -1),
                    u_d.reshape(C, -1), z_d.reshape(C, -1), f32(rho_f),
                    f32(obj.n_rows), local_iter, obj.family, obj.intercept,
                    C).reshape(-1)
            else:
                nb = _admm_local_body(Xb, yb, blk.n_rows, b_d, u_d, z_d,
                                      f32(rho_f), f32(obj.n_rows),
                                      local_iter, obj.family, obj.intercept)
            B[bi] = nb.cpu().numpy()
        bu_sum = reduce(np.asarray((B + U).sum(axis=0), np.float64))
        bu_mean = np.asarray(bu_sum, np.float32) / glob_blocks
        z_new = regularizers.prox(reg, torch.as_tensor(bu_mean), lam,
                                  1.0 / (rho_f * glob_blocks), pmask,
                                  obj.l1_ratio)
        z_h = z_new.numpy().astype(np.float32)
        U = U + B - z_h[None, :]
        primal2 = float(reduce(np.asarray(((B - z_h[None, :]) ** 2).sum(),
                                          np.float64)))
        primal = float(np.sqrt(primal2))
        dual = float(rho_f * np.sqrt(glob_blocks) * np.linalg.norm(z_h - z))
        z = z_h
        n_iter = it + 1
        if primal <= tol and dual <= tol:
            break
        if primal > 10.0 * dual:
            rho_f *= 2.0
            U /= 2.0
        elif dual > 10.0 * primal:
            rho_f *= 0.5
            U *= 2.0
        if ckpt is not None and ckpt.due(n_iter):
            # after the rho adaptation: the state the next iteration reads
            ckpt.save(B=B, U=U, z=z, rho=np.float64(rho_f), it=n_iter,
                      passes=obj.passes)
    _finish(ckpt)
    return (np.asarray(z, np.float64),
            {"n_iter": n_iter, "primal_residual": primal,
             "dual_residual": dual, "data_passes": obj.passes})


STREAMED_SOLVERS = {
    "admm": admm,
    "lbfgs": lbfgs,
    "newton": newton,
    "gradient_descent": gradient_descent,
    "proximal_grad": proximal_grad,
}


def _resolve(solver, kwargs):
    if solver not in STREAMED_SOLVERS:
        raise ValueError(
            f"Unknown solver {solver!r}; options: {sorted(STREAMED_SOLVERS)}"
        )
    return kwargs.pop("use_kernel", None) is not False


def _fused_stream_info(obj, solver, fit_dtype):
    """The fit-info fields of the streamed pass flavour: whether the
    kernels carried the passes this solver runs, why not
    (``fused_stream_reason``, None when they did), one stream shard, and
    the resolved precision."""
    kind = {"newton": "vgh", "admm": None}.get(solver, "vg")
    if kind is None:
        mxu, fused, reason = None, False, "admm-local-newton"
    else:
        mxu, fused, reason = obj._flavor(kind)
    out = {"stream_shards": 1, "fused_stream": bool(fused),
           "fused_stream_reason": reason}
    if fused and kind == "vgh":
        out.update({"fit_dtype": "float32",
                    "fit_dtype_source": "hessian-f32"})
    elif fused:
        out.update(fit_dtype_info(fit_dtype))
    else:
        out.update({"fit_dtype": "float32",
                    "fit_dtype_source": "streamed-plain"})
    return out


def sparse_stream_info(stream, solver=None):
    """``sparse_stream`` (the nnz route carried the passes) and
    ``sparse_stream_reason`` (None when it did, else the stream's reason,
    or ``"dense-source"``): the JAX audit fields
    (``dask_ml_tpu/models/solvers/streamed.py:1784-1811``)."""
    on = bool(stream.nnz_route) and solver != "admm"
    if on:
        reason = None
    elif stream.sparse_route is None:
        reason = "dense-source"
    else:
        reason = stream.sparse_reason
    return {"sparse_stream": on, "sparse_stream_reason": reason}


def _finish_info(info, stream, obj, solver, fit_dtype):
    info["streamed"] = True
    info["n_blocks"] = stream.n_blocks
    info.update(_fused_stream_info(obj, solver, fit_dtype))
    info.update(sparse_stream_info(stream, solver))
    return info


def solve_streamed(solver, stream, n_rows, beta0, family, reg, lam, pmask,
                   l1_ratio=0.5, intercept=True, max_iter=100, tol=1e-6,
                   fit_dtype=None, reduce=None, **kwargs):
    """Fit one GLM over ``stream`` (a BlockStream of (X, y)); returns
    (beta as float64 numpy, info). ``reduce`` merges each pass's sums
    across processes (``n_rows`` is then the global count)."""
    use_kernel = _resolve(solver, kwargs)
    obj = StreamedObjective(stream, n_rows, lam, pmask, l1_ratio, family,
                            reg, intercept, fit_dtype=fit_dtype,
                            use_kernel=use_kernel, reduce=reduce)
    beta, info = STREAMED_SOLVERS[solver](obj, beta0, max_iter=max_iter,
                                          tol=tol, **kwargs)
    info = _finish_info(info, stream, obj, solver, fit_dtype)
    return check_finite_result(torch.as_tensor(beta), info, solver)


def solve_streamed_multi(solver, stream, n_rows, B0, family, reg, lam,
                         pmask, l1_ratio=0.5, intercept=True, max_iter=100,
                         tol=1e-6, fit_dtype=None, reduce=None, **kwargs):
    """One-vs-rest streamed fit: ``B0`` and the result are (C, d);
    ``pmask`` is the per-class (d,) mask, tiled here. Every pass reads
    the data ONCE for all classes; the host solvers run unchanged on the
    flat (C * d,) vector."""
    use_kernel = _resolve(solver, kwargs)
    B0 = np.asarray(B0, np.float32)
    C, d = B0.shape
    pmask_t = np.tile(np.asarray(pmask, np.float32), C)
    obj = MulticlassStreamedObjective(
        stream, n_rows, lam, pmask_t, l1_ratio, family, reg, intercept,
        fit_dtype=fit_dtype, use_kernel=use_kernel, n_classes=C,
        reduce=reduce)
    beta, info = STREAMED_SOLVERS[solver](obj, B0.ravel(),
                                          max_iter=max_iter, tol=tol,
                                          **kwargs)
    info = _finish_info(info, stream, obj, solver, fit_dtype)
    info["n_classes"] = C
    beta, info = check_finite_result(torch.as_tensor(beta), info, solver)
    return beta.reshape(C, d), info
