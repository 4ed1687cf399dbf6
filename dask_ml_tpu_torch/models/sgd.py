"""SGD estimators with ``partial_fit``: SGDClassifier, SGDRegressor.

Counterpart of ``dask_ml_tpu/models/sgd.py``: the same parameters,
fitted attributes and update. A block IS the minibatch: each step is one
full-block gradient step, l2 inside the objective, l1 as a proximal
soft-threshold after the step (elasticnet mixes them by ``l1_ratio``),
the intercept unpenalized, and the lr clock ``_t`` advancing once per
step through the constant / invscaling / optimal schedules.

A step on the card is ONE kernel launch (``ops/fused.py``:
``fused_sgd_block_grad`` for flat weights, ``fused_sgd_many_block_grad``
with ``codes=True`` for the (C, d + 1) one-vs-rest rows of a multiclass
model) returning the block's raw sums, then the O(d) epilogue
``_sgd_many_update`` in a few torch ops on the device: no host sync per
block, the last loss stays a device tensor (``_last_loss``).
``config.use_kernel=False`` runs the kernels' plain versions instead
(``solver_info_["fused_stream_reason"] == "use_kernel=False"``).

Data:
- host arrays and ``np.memmap`` stream through ``BlockStream`` in
  ``fit_block_rows`` blocks, ``max_iter`` epochs, the block order
  reshuffled each epoch by ``np.random.RandomState(random_state)``;
- a ``ShardedArray`` or tensor on the device is cut into the same
  ``grid_partition`` blocks, each a view ``X.data[lo:hi]`` with its count
  (the JAX package gathers them with ``take_rows``, or copies the whole
  set into a padded (B, S, d) grid in ``_fused_epoch``; views need
  neither copy).

The batched-trial protocol (``_batch_key``, ``_batch_prepare``,
``_batched_partial_fit``, ``_batched_fused_calls``, ``_batch_publish``,
``_batched_score_default``) advances N models with per-model lr, alpha,
penalty and intercept flag through ONE ``fused_sgd_many_block_grad``
launch (``codes=False``) per step. The streamed cohort protocol
(``_streamed_cohort_round``, ``_cohort_holdout``,
``_cohort_holdout_scores``) runs an adaptive search's round over one
``BlockStream`` pass, one such launch per block step for the models
active at it; the JAX package's superblock scans and slot-rung ladder
amortise XLA's dispatch and compiles, which the port does not pay.

Sparse X (scipy sparse or ``SparseBlocks``) streams: on the stream's
nnz route a step takes the block's ``SparseSlab`` through the plain
sparse products (``sgd_sparse_block_sums``: eta by ``sparse_eta_multi``,
the gradient by ``XᵀR``, the JAX ``_sgd_update_one_sparse``) and the
same epilogue, one step per block, single models and cohorts alike; a
sparse holdout is staged once as one slab and scored by one product.
``solver_info_`` records ``sparse_stream`` and ``sparse_stream_reason``
(the JAX reasons). A sparse ``partial_fit`` block is densified on
placement, as in the JAX package.

Checkpoints: a host-streamed ``fit`` saves the weights, the lr clock
``_t`` and the epoch after every ``config.stream_checkpoint_every``-th
epoch under ``config.stream_checkpoint_path`` (kind ``"sgd"``; never for
``warm_start``) and a killed fit resumes bit-equal: the stream's block
order is fast-forwarded by one ``rng.shuffle`` of a length-``n_blocks``
array per completed epoch, which replays the order exactly. A streamed
fit carries ``training_profile_``; the Incremental wrapper's passes
(``_stream_pass``) merge theirs into it.

Gradient accumulation (``config.stream_grad_accum`` = A >= 1,
``_fit_stream_grad_accum``): A blocks a group, their raw sums added in
float64 and merged across processes by ``psum_host``, one update a group
(the sparse micro step too, on the nnz route); the flavour a
multi-process SGD fit needs, so without it several processes raise, as
in the JAX package. It writes no pass checkpoint (a warning when
``stream_checkpoint_path`` is set) and refuses
``stream_nonfinite="quarantine"``. Its merges run over the "data"
collective (under a ``"DxM"`` mesh the M ranks of a row group stream the
same rows, model-replicated).

A process-local ``ShardedArray`` under several processes
(``_fit_device``) fits the global array as JAX does
(``dask_ml_tpu/models/sgd.py:2332-2333``): step b's block is the range of
global rows ``grid_partition`` gives it, each process sums the rows of
that range it holds (zero sums where it holds none), the sums merge by
``psum_host`` over the row groups, and every process applies the same
update.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, ClassifierMixin, RegressorMixin, to_host
from ..config import fit_dtype_info, get_config, mxu_dtype, resolve_device
from ..metrics import accuracy_score, r2_score
from ..ops.fused import (fused_sgd_block_grad, fused_sgd_many_block_grad,
                         sgd_block_grad_plain, sgd_many_block_grad_plain,
                         sgd_objective_terms)
from ..parallel.sharded import ShardedArray, as_sharded
from ..ops.sparse_kernels import block_matmul, sparse_eta_multi, sparse_xt_R
from ..parallel.sparse_stream import SparseSlab, to_slab
from ..parallel.streaming import (BlockStream, _is_sparse_source,
                                  fit_block_rows, grid_partition, stream_plan,
                                  streamed_map)
from .solvers.streamed import sparse_stream_info
from ..utils.validation import check_is_fitted

_LOSSES = ("log_loss", "hinge", "squared_error")
_PENALTIES = ("l2", "l1", "elasticnet", None, "none")


def _kernel_flavor():
    """(the step kernels run, why not): ``config.use_kernel`` is the one
    gate."""
    if get_config().use_kernel:
        return True, None
    return False, "use_kernel=False"


def _col(a):
    """A per-row operand of the epilogue: an (N,) tensor as an (N, 1)
    column; a host float32 scalar as it is (f32 scalar products stay f32,
    as the JAX epilogue's)."""
    return a.reshape(-1, 1) if isinstance(a, torch.Tensor) else np.float32(a)


def _sgd_many_update(W, loss_sums, grads, nv, lr, alpha, l2w, l1w, iflag):
    """The step's epilogue on RAW kernel sums for an (N, d + 1) weight
    stack, the one definition of ``dask_ml_tpu/models/sgd.py::
    _sgd_many_update`` shared by binary (N = 1), multiclass and cohort
    steps, so they cannot drift apart. ``nv`` is max(count, 1); lr, alpha,
    l2w, l1w and iflag are float32 host scalars or (N,) f32 tensors on
    W's device. Divides by the count, adds the l2 term, scales the
    intercept's gradient by iflag, steps, soft-thresholds by lr * alpha *
    l1w. Returns (W2, per-row losses); W is not modified."""
    lrc, ac, l2c, l1c, ifc = (_col(a) for a in (lr, alpha, l2w, l1w, iflag))
    nv = np.float32(nv)
    l2term = ac * l2c
    half_l2 = np.float32(0.5) * l2term
    if isinstance(half_l2, torch.Tensor):
        half_l2 = half_l2[:, 0]
    losses = loss_sums / nv + half_l2 * (W[:, :-1] ** 2).sum(1)
    g = grads / nv
    g[:, :-1] += l2term * W[:, :-1]
    g[:, -1] *= ifc[:, 0] if isinstance(ifc, torch.Tensor) else ifc
    W2 = W - lrc * g
    thr = lrc * ac * l1c
    coef = W2[:, :-1]
    W2[:, :-1] = torch.sign(coef) * (coef.abs() - thr).clamp_min(0.0)
    return W2, losses


def _stack_cohort_weights(models, n_slots, device):
    """The cohort's (n_slots, d + 1) weight stack on ``device``: model i
    in row i, the rows past the live models zero."""
    d1 = int(models[0]._w.shape[-1])
    W = torch.zeros((max(int(n_slots), len(models)), d1),
                    dtype=torch.float32, device=device)
    W[:len(models)] = torch.stack([m._w.to(device) for m in models])
    return W


def sgd_sparse_block_sums(x, n_valid, y, W_ext, iflags, loss, codes):
    """(Σ loss per row (N,), Σ ∂/∂W_ext (N, d + 1)) of one sparse block's
    rows < n_valid for N stacked weight rows: the contract of
    ``fused_sgd_many_block_grad`` on a ``SparseSlab``, in plain torch at
    nnz cost. eta by ``sparse_eta_multi``; the gradient ``XᵀR`` over the
    residuals zeroed past n_valid; ``codes`` as the kernel's."""
    n = int(n_valid)
    W = W_ext.to(torch.float32)
    N = W.shape[0]
    eta = sparse_eta_multi(x.data, x.cols, x.rows, W[:, :-1], x.n_rows,
                           x.indptr)[:n] + (W[:, -1] * iflags)[None, :]
    yv = y[:n].to(torch.float32)
    if codes:
        Y = (yv[:, None] == torch.arange(N, dtype=yv.dtype,
                                         device=yv.device)[None, :]
             ).to(yv.dtype)
    else:
        Y = yv[:, None].expand(-1, N)
    per, resid = sgd_objective_terms(eta, Y, loss)
    R = torch.zeros((x.n_rows, N), dtype=torch.float32, device=W.device)
    R[:n] = resid
    g = sparse_xt_R(x.data, x.cols, x.rows, R, x.n_features, x.by_col())
    return per.sum(0), torch.cat([g.T, resid.sum(0)[:, None]], 1)


def _batched_eta(X, W):
    """(n, N) decision values of N stacked models on one shared X (a
    tensor or a ``SparseSlab``)."""
    return block_matmul(X, W[:, :-1].T) + W[:, -1][None, :]


def _valid(X, n_valid):
    """A dense X cut to its valid rows before the product; a slab's
    product is cut after it."""
    return X if isinstance(X, SparseSlab) else X[:n_valid]


def _holdout_x(Xs):
    """A staged holdout's X: the slab of a sparse split, the device rows
    of a dense one."""
    return Xs if isinstance(Xs, SparseSlab) else Xs.data


def _batched_accuracy(X, y01, n_valid, W):
    eta = _batched_eta(_valid(X, n_valid), W)[:n_valid]
    correct = ((eta > 0).to(torch.float32) == y01[:n_valid, None])
    return correct.to(torch.float32).sum(0) / max(n_valid, 1)


def _batched_r2(X, y, n_valid, W):
    eta = _batched_eta(_valid(X, n_valid), W)[:n_valid]
    yv = y[:n_valid]
    y_mean = yv.sum() / max(n_valid, 1)
    ss_tot = ((yv - y_mean) ** 2).sum()
    ss_res = ((eta - yv[:, None]) ** 2).sum(0)
    return 1.0 - ss_res / ss_tot.clamp_min(1e-12)


class _SGDBase(BaseEstimator):
    loss_default = "squared_error"

    def __init__(self, loss=None, penalty="l2", alpha=1e-4, l1_ratio=0.15,
                 eta0=0.01, learning_rate="invscaling", power_t=0.25,
                 max_iter=5, tol=1e-3, shuffle=True, random_state=None,
                 warm_start=False, fit_intercept=True, fit_dtype=None):
        self.loss = loss
        # per-estimator precision override: None follows config.dtype
        self.fit_dtype = fit_dtype
        self.penalty = penalty
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.eta0 = eta0
        self.learning_rate = learning_rate
        self.power_t = power_t
        self.max_iter = max_iter
        self.tol = tol
        self.shuffle = shuffle
        self.random_state = random_state
        self.warm_start = warm_start
        self.fit_intercept = fit_intercept

    # -- parameters -------------------------------------------------------
    def _loss(self):
        loss = self.loss or self.loss_default
        if loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}, got {loss!r}")
        return loss

    def _penalty_weights(self):
        """(l2_weight, l1_weight) implementing sklearn SGD semantics."""
        p = self.penalty
        if p == "l2":
            return 1.0, 0.0
        if p == "l1":
            return 0.0, 1.0
        if p == "elasticnet":
            return 1.0 - self.l1_ratio, self.l1_ratio
        if p is None or p == "none":
            return 0.0, 0.0
        raise ValueError(f"penalty must be one of {_PENALTIES}, got {p!r}")

    def _lr(self):
        t = max(self._t, 1)
        if self.learning_rate == "constant":
            return self.eta0
        if self.learning_rate == "invscaling":
            return self.eta0 / (t ** self.power_t)
        if self.learning_rate == "optimal":
            return 1.0 / (self.alpha * (1e3 + t))
        raise ValueError(f"Unknown learning_rate {self.learning_rate!r}")

    def _n_out(self):
        """Number of one-vs-rest rows for a multiclass classifier, else
        None (binary / regression use a flat weight vector)."""
        classes = getattr(self, "classes_", None)
        return len(classes) if classes is not None and len(classes) > 2 \
            else None

    # -- the step clock ---------------------------------------------------
    def _ensure_state(self, d, device):
        if getattr(self, "_w", None) is None:
            C = self._n_out()
            shape = (C, d + 1) if C is not None else (d + 1,)
            self._w = torch.zeros(shape, dtype=torch.float32, device=device)
            self._t = 0
        elif self._w.device != device:
            self._w = self._w.to(device)
        self._penalty_weights()  # validate penalty eagerly
        info = fit_dtype_info(self.fit_dtype)
        self.fit_dtype_ = info["fit_dtype"]
        self.fit_dtype_source_ = info["fit_dtype_source"]

    def _step_args(self):
        """Per-model float32 scalars of one step (lr, alpha, l2w, l1w,
        iflag); the model's step clock advances here."""
        self._t += 1
        l2w, l1w = self._penalty_weights()
        return (np.float32(self._lr()), np.float32(self.alpha),
                np.float32(l2w), np.float32(l1w),
                np.float32(1.0 if self.fit_intercept else 0.0))

    def _restore_weights(self):
        """``_w`` rebuilt from the published coef_/intercept_ on
        ``config.device`` (a model carried across by ``convert``), so
        partial_fit continues from them."""
        coef = np.asarray(self.coef_, np.float32)
        b = np.asarray(self.intercept_, np.float32).reshape(-1)
        if self._n_out() is not None:
            w = np.concatenate([coef, b[:, None]], 1)
        else:
            w = np.concatenate([coef.reshape(-1), b[:1]])
        self._w = torch.from_numpy(w).to(resolve_device())

    def _lr_schedule(self, n_calls):
        """The next ``n_calls`` lr values this model's clock would
        produce: exactly ``_step_args``'s increment-then-``_lr``
        sequence, precomputed on the host."""
        out = []
        t0 = self._t
        for i in range(n_calls):
            self._t = t0 + i + 1
            out.append(self._lr())
        self._t = t0
        return np.asarray(out, np.float32)

    # -- one step ----------------------------------------------------------
    def _block_sums(self, Xb, yb, n_valid):
        """(Σ loss per weight row (N,), Σ ∂/∂W (N, d + 1)) of the block's
        rows < ``n_valid``, the raw sums of one launch of the step kernel
        (its plain version, or the sparse products of a ``SparseSlab``)."""
        iflag = np.float32(1.0 if self.fit_intercept else 0.0)
        mxu = mxu_dtype(self.fit_dtype)
        use_kernel, _ = _kernel_flavor()
        loss = self._loss()
        if isinstance(Xb, SparseSlab):
            W = self._w if self._n_out() is not None else self._w[None]
            return sgd_sparse_block_sums(
                Xb, n_valid, yb, W, iflag, loss, self._n_out() is not None)
        if self._n_out() is not None:
            fn = fused_sgd_many_block_grad if use_kernel \
                else sgd_many_block_grad_plain
            return fn(Xb, n_valid, yb, self._w, iflag, loss, True, mxu)
        fn = fused_sgd_block_grad if use_kernel else sgd_block_grad_plain
        s, g = fn(Xb, n_valid, yb, self._w, iflag, loss, mxu)
        return s[None], g[None]

    def _apply(self, sums, grads, nv, lr):
        """The step's epilogue on raw sums over ``nv`` rows."""
        l2w, l1w = self._penalty_weights()
        iflag = np.float32(1.0 if self.fit_intercept else 0.0)
        W = self._w if self._n_out() is not None else self._w[None]
        W2, losses = _sgd_many_update(W, sums, grads, nv, lr,
                                      np.float32(self.alpha), l2w, l1w, iflag)
        if self._n_out() is not None:
            self._w, self._last_loss = W2, losses.sum()
        else:
            self._w, self._last_loss = W2[0], losses[0]

    def _step(self, Xb, yb, n_valid, lr):
        """One minibatch step on the block's rows < ``n_valid`` at the
        host lr: one kernel launch and the epilogue, all on the device.
        A block with no rows leaves the weights as they are."""
        n_valid = int(n_valid)
        if n_valid == 0:
            return
        sums, grads = self._block_sums(Xb, yb, n_valid)
        self._apply(sums, grads, max(n_valid, 1), lr)

    def _one_step(self, Xb, yb, n_valid):
        lr = self._step_args()[0]
        self._step(Xb, yb, n_valid, lr)

    def _record(self, streamed, n_blocks, stream=None):
        use_kernel, reason = _kernel_flavor()
        sparse = {"sparse_stream": False,
                  "sparse_stream_reason": "dense-source"}
        if stream is not None:
            sparse = sparse_stream_info(stream)
            if stream.nnz_route and use_kernel:
                use_kernel, reason = False, "sparse-stream"
        self.solver_info_ = {"streamed": streamed, "n_blocks": int(n_blocks),
                             "fused_stream": use_kernel,
                             "fused_stream_reason": reason, **sparse}

    # -- data -------------------------------------------------------------
    def _block(self, X, y):
        X = as_sharded(X, dtype=np.float32)
        y = self._targets(y, X.device)
        if y.n_rows != X.n_rows:
            raise ValueError(f"X and y have inconsistent lengths: "
                             f"{X.n_rows} vs {y.n_rows}")
        return X, y

    def _targets(self, y, device):
        """y encoded (``_encode_y``) as an f32 ShardedArray on ``device``:
        device targets are encoded there, host targets on the host."""
        if isinstance(y, torch.Tensor):
            y = ShardedArray.from_array(y, device=device)
        return as_sharded(self._encode_y(y), dtype=np.float32, device=device)

    def _classes_from(self, y, kwargs):
        """Set ``classes_`` (classifiers) from ``classes=`` or the labels
        of y; the regressors have none."""
        if not isinstance(self, ClassifierMixin):
            return
        classes = kwargs.get("classes")
        if classes is not None:
            self._set_classes(np.asarray(classes))
        elif getattr(self, "classes_", None) is None:
            if isinstance(y, ShardedArray):
                labels = torch.unique(y.data[:y.n_rows]).cpu().numpy()
            else:
                labels = np.unique(y)
            self._set_classes(labels)

    def _require_classes(self):
        if isinstance(self, ClassifierMixin) and \
                getattr(self, "classes_", None) is None:
            raise ValueError(
                "classes must be passed on the first call to partial_fit."
            )

    # -- the sklearn entry points -------------------------------------------
    def partial_fit(self, X, y, classes=None, **kwargs):
        if classes is not None:
            self._set_classes(np.asarray(classes))
        X, y = self._block(X, y)
        self._ensure_state(X.shape[1], X.device)
        self._one_step(X.data, y.data, X.n_rows)
        self._publish(X.shape[1])
        return self

    def fit(self, X, y, **kwargs):
        if not self.warm_start:
            self._w = None
            if getattr(self, "classes_", None) is not None:
                self.classes_ = None  # a fresh fit re-derives classes
        from ..parallel import distributed as dist

        multi = dist.process_count() > 1
        if isinstance(X, (ShardedArray, torch.Tensor)):
            return self._fit_device(as_sharded(X, dtype=np.float32), y,
                                    kwargs)
        if multi and int(get_config().stream_grad_accum) <= 0:
            # sequential per-block updates depend on their order: unlike
            # the additive GLM, KMeans and PCA sums they cannot merge
            # across processes' streams into one fit
            raise NotImplementedError(
                "a host-streamed SGD fit is single-process by default "
                "(sequential updates cannot merge across process-local "
                "streams); set config.stream_grad_accum=A (>= 1) for the "
                "gradient-accumulation flavour, one psum_host per A blocks "
                "(the sequential multi-process fit: ROADMAP.md queue 1, "
                "Multi-GPU)")
        # an np.memmap stays one, a sparse source streams as it is
        Xh = X if _is_sparse_source(X) else np.asanyarray(X)
        yh = to_host(y)
        if len(yh) != Xh.shape[0]:
            raise ValueError(f"X and y have inconsistent lengths: "
                             f"{Xh.shape[0]} vs {len(yh)}")
        self._classes_from(yh, kwargs)
        y_enc = np.asarray(self._encode_y(yh), np.float32)
        stream = BlockStream((Xh, y_enc), block_rows=fit_block_rows(Xh),
                             shuffle=self.shuffle, seed=self.random_state)
        self._ensure_state(Xh.shape[1], stream.device)
        self._lr()  # validate the schedule before the first block
        accum = int(get_config().stream_grad_accum)
        ckpt = None if accum >= 1 else \
            self._stream_fit_checkpoint(Xh, y_enc, stream)
        if accum >= 1:
            self._fit_stream_grad_accum(stream, accum)
        elif ckpt is not None:
            self._fit_stream_checkpointed(stream, ckpt)
        else:
            for blk in stream.epochs(self.max_iter):
                Xb, yb = blk.arrays
                self._one_step(Xb, yb, blk.n_rows)
        self.training_profile_ = stream.profile_snapshot()
        self.stream_stats_ = stream.totals
        self._record(True, stream.n_blocks, stream)
        if accum >= 1:
            self.solver_info_["grad_accum"] = accum
        self._publish(Xh.shape[1])
        self.n_iter_ = self.max_iter
        return self

    def _fit_stream_grad_accum(self, stream, A):
        """The gradient-accumulation streamed fit
        (``config.stream_grad_accum`` = A >= 1; JAX
        ``_fit_stream_grad_accum``): A of this process's blocks make a
        group; their raw kernel sums (kernel 5, kernel 8 for one-vs-rest,
        the sparse products on the nnz route) add on the device in
        float64, in block order, merge across processes by ``psum_host``
        (float64, rank order) and, back as float32, take ONE epilogue
        over the group's global row count, so every process holds the
        identical weights after every update. The lr clock ticks once
        per update. At A = 1 in one process the sums' float64 round trip
        is exact and the fit is bit-equal to the sequential one; at A > 1
        or across P processes an update averages A x P blocks. Every
        process joins the same number of merges a pass (a process past
        its own blocks adds zero sums), all inside the pass, before its
        barrier. No pass checkpoint: the update schedule is a
        collective."""
        import warnings

        from ..parallel import distributed as dist

        cfg = get_config()
        if cfg.stream_nonfinite == "quarantine":
            raise ValueError(
                "stream_grad_accum does not compose with "
                "stream_nonfinite='quarantine' (group counts are exchanged "
                "before blocks are read); use stream_nonfinite='raise' or "
                "the sequential flavour")
        if cfg.stream_checkpoint_path:
            warnings.warn(
                "stream_checkpoint_path is set but the grad-accum streamed "
                "SGD flavour does not checkpoint (its update schedule is a "
                "collective); the fit runs uncheckpointed", RuntimeWarning)
        A = int(A)
        multi = dist.process_count() > 1
        n_blocks = stream.n_blocks
        starts = np.arange(n_blocks, dtype=np.int64) * stream.block_rows
        counts = np.minimum(starts + stream.block_rows, stream.n_rows) \
            - starts
        n_groups_local = max(-(-n_blocks // A), 1)
        n_groups = int(max(dist.allgather_object(n_groups_local))) \
            if multi else n_groups_local
        dev = stream.device

        def update(acc, nv):
            """One group's merge and update; ``acc`` None adds zeros."""
            N = 1 if self._n_out() is None else self._n_out()
            d1 = int(self._w.shape[-1])
            if acc is None:
                host = np.zeros(N + N * d1, np.float64)
            else:
                host = torch.cat([acc[0].reshape(-1), acc[1].reshape(-1)]
                                 ).cpu().numpy()
            if multi:
                host = np.asarray(dist.psum_host(host, group="data"),
                                  np.float64)
            flat = torch.as_tensor(host.astype(np.float32), device=dev)
            lr = self._step_args()[0]
            self._apply(flat[:N], flat[N:].reshape(N, d1), max(nv, 1.0), lr)

        for _ in range(int(self.max_iter)):
            order = np.arange(n_blocks)
            if self.shuffle:
                stream.rng.shuffle(order)
            local_nv = np.zeros(n_groups, np.float64)
            for g in range(n_groups_local):
                local_nv[g] = float(counts[order[g * A:(g + 1) * A]].sum())
            group_nv = np.asarray(dist.psum_host(local_nv, group="data")) \
                if multi else local_nv
            acc, g = None, 0
            for j, blk in enumerate(stream.blocks(order)):
                Xb, yb = blk.arrays
                if blk.n_rows:
                    sums, grads = self._block_sums(Xb, yb, blk.n_rows)
                    sums, grads = sums.double(), grads.double()
                    acc = (sums, grads) if acc is None else \
                        (acc[0] + sums, acc[1] + grads)
                if (j + 1) % A == 0 or j == n_blocks - 1:
                    update(acc, float(group_nv[g]))
                    acc, g = None, g + 1
                    if j == n_blocks - 1:
                        # past this process's blocks: zero sums, so every
                        # process joins each merge of the pass
                        while g < n_groups:
                            update(None, float(group_nv[g]))
                            g += 1

    def _stream_fit_checkpoint(self, Xh, y_enc, stream):
        """The fit's pass checkpoint slot, or None (checkpoints off, or a
        ``warm_start`` fit, whose starting weights the token cannot
        cover)."""
        if self.warm_start:
            return None
        from ..reliability.stream_ckpt import stream_checkpoint

        classes = getattr(self, "classes_", None)
        parts = (type(self).__name__, self._loss(), self.penalty,
                 self.alpha, self.l1_ratio, self.eta0, self.learning_rate,
                 self.power_t, self.max_iter, self.tol, self.shuffle,
                 self.random_state, self.fit_intercept, self.fit_dtype,
                 None if classes is None
                 else tuple(np.asarray(classes).tolist()),
                 tuple(Xh.shape), int(stream.block_rows))
        return stream_checkpoint("sgd", parts, arrays=(Xh, y_enc))

    def _fit_stream_checkpointed(self, stream, ckpt):
        """The streamed epoch loop with a save of (weights, ``_t``,
        epoch) after each due epoch and a clear on completion; a resumed
        fit fast-forwards the shuffle by one permutation draw per
        completed epoch (``RandomState.shuffle`` consumes draws by the
        array's length only), so it trains the same minibatches in the
        same order as an uninterrupted fit. Autotune never applies: a
        resized partition would break the token."""
        from ..reliability.stream_ckpt import restore_counted

        start = 0
        st = restore_counted(ckpt)
        if st is not None and st["w"].shape == tuple(self._w.shape):
            self._w = torch.as_tensor(st["w"], dtype=torch.float32,
                                      device=stream.device)
            self._t = int(st["t"])
            start = int(st["epoch"])
        if self.shuffle:
            burn = np.arange(stream.n_blocks)
            for _ in range(min(start, int(self.max_iter))):
                stream.rng.shuffle(burn)
        for e in range(start, int(self.max_iter)):
            for blk in stream.blocks():
                Xb, yb = blk.arrays
                self._one_step(Xb, yb, blk.n_rows)
            if ckpt.due(e + 1):
                ckpt.save(w=to_host(self._w), t=self._t, epoch=e + 1)
        ckpt.clear()

    def _fit_device(self, X: ShardedArray, y, kwargs):
        """Epochs over device-resident blocks: the ``grid_partition`` row
        ranges of the global array, in an order reshuffled each epoch by
        ``np.random.RandomState(random_state)``. Alone, each step runs
        on the views ``X.data[lo:hi]`` (no gather, no copy). Over a
        process-local array merged across row groups (JAX fits the
        global array), each step's raw sums over this process's rows of
        the range (zero where it holds none) merge over "data", then one
        update on every process."""
        from ..parallel import distributed as dist

        if X.model_sharded:
            raise NotImplementedError(
                "an SGD fit over a feature-sharded array is not ported "
                "(ROADMAP.md queue 1, Multi-GPU, part 3)")
        ys = as_sharded(y, device=X.device)
        if ys.n_rows != X.n_rows:
            raise ValueError(f"X and y have inconsistent lengths: "
                             f"{X.n_rows} vs {ys.n_rows}")
        if X.process_local and dist.process_count() > 1 and isinstance(
                self, ClassifierMixin) and kwargs.get("classes") is None \
                and getattr(self, "classes_", None) is None:
            # the class set is the union of every process's labels
            local = torch.unique(ys.data[:ys.n_rows]).cpu().numpy()
            kwargs = dict(kwargs, classes=np.unique(np.concatenate(
                dist.allgather_object(local))))
        self._classes_from(ys, kwargs)
        y_enc = self._targets(ys, X.device)
        reduce = dist.host_reduce("data") if X.process_local else None
        n, off, here = X.global_rows, X.row_offset, X.n_rows
        _, S = grid_partition(n)
        ranges = [(s, min(s + S, n)) for s in range(0, n, S)]
        self._ensure_state(X.shape[1], X.device)
        self._lr()
        rng = np.random.RandomState(self.random_state)
        order = np.arange(len(ranges))
        N = 1 if self._n_out() is None else self._n_out()
        d1 = int(self._w.shape[-1])
        for _ in range(self.max_iter):
            if self.shuffle:
                rng.shuffle(order)
            for b in order:
                lo, hi = ranges[b]
                if reduce is None:
                    self._one_step(X.data[lo:hi], y_enc.data[lo:hi], hi - lo)
                    continue
                a, z = max(lo - off, 0), min(hi - off, here)
                lr = self._step_args()[0]
                host = np.zeros(N + N * d1, np.float64)
                if z > a:
                    sums, grads = self._block_sums(
                        X.data[a:z], y_enc.data[a:z], z - a)
                    host = torch.cat([sums.reshape(-1), grads.reshape(-1)]
                                     ).double().cpu().numpy()
                flat = torch.as_tensor(np.asarray(reduce(host), np.float32),
                                       device=X.device)
                self._apply(flat[:N], flat[N:].reshape(N, d1),
                            float(hi - lo), lr)
        self._record(False, len(ranges))
        self._publish(X.shape[1])
        self.n_iter_ = self.max_iter
        return self

    def _fused_epoch(self, X, y, order, n_blocks=None, classes=None):
        """One epoch of device data in ``order`` (the Incremental
        wrapper's pass): block b is the view of rows [b S, (b + 1) S) of
        the ``grid_partition`` blocks, the steps' lr values precomputed by
        ``_lr_schedule``. The same updates as ``order`` partial_fit calls
        over those blocks."""
        if classes is not None:
            self._set_classes(np.asarray(classes))
        self._require_classes()
        X = as_sharded(X, dtype=np.float32)
        y_enc = self._targets(y, X.device)
        n = X.n_rows
        B, S = grid_partition(n)
        if n_blocks is not None and n_blocks != B:
            raise ValueError(
                f"_fused_epoch has {B} blocks of {S} rows; the caller "
                f"partitioned into {n_blocks}")
        order = np.asarray(order, np.int64)
        if order.size and (order.min() < 0 or order.max() >= B):
            raise ValueError(f"order indexes blocks 0..{B - 1}; got "
                             f"[{order.min()}, {order.max()}]")
        self._ensure_state(X.shape[1], X.device)
        self._lr()
        lrs = self._lr_schedule(len(order))
        for lr, b in zip(lrs, order):
            lo, hi = int(b) * S, min((int(b) + 1) * S, n)
            self._step(X.data[lo:hi], y_enc.data[lo:hi], hi - lo, lr)
        self._t += int(len(order))
        self._publish(X.shape[1])
        return self

    def _stream_pass(self, Xh, yh, block_rows, order=None, classes=None):
        """One partial_fit pass over host data (the Incremental wrapper's
        pass): block ``order[j]`` of a ``BlockStream`` of ``block_rows``
        rows is the j-th minibatch. Returns True (the port has no
        condition under which the caller's per-block loop must run)."""
        if classes is not None:
            self._set_classes(np.asarray(classes))
        self._require_classes()
        if not _is_sparse_source(Xh):
            Xh = np.asanyarray(Xh)
        y_enc = np.asarray(self._encode_y(to_host(yh)), np.float32)
        stream = BlockStream((Xh, y_enc), block_rows=block_rows)
        self._ensure_state(Xh.shape[1], stream.device)
        for blk in stream.blocks(order):
            Xb, yb = blk.arrays
            self._one_step(Xb, yb, blk.n_rows)
        prof = stream.profile_snapshot()
        if prof is not None:
            # one training profile covers every pass the model trained on
            from ..observability.sketch import merge_profiles

            self.training_profile_ = merge_profiles(
                getattr(self, "training_profile_", None), prof)
        self.stream_stats_ = stream.totals
        self._publish(Xh.shape[1])
        return True

    # -- the batched-trial protocol ----------------------------------------
    def _batch_prepare(self, fit_params):
        """Apply first-call side effects (classes) before grouping."""
        classes = (fit_params or {}).get("classes")
        if classes is not None:
            self._set_classes(np.asarray(classes))

    def _batch_key(self):
        """Models sharing a key advance together in one launch per step;
        None disables batching. lr schedule, alpha, penalty and intercept
        are per-model operands, so only structure is in the key."""
        try:
            loss = self._loss()
            self._penalty_weights()
            # one launch serves the cohort: one compute dtype
            dtype = fit_dtype_info(self.fit_dtype)["fit_dtype"]
        except ValueError:
            return None  # invalid params: the solo path raises
        classes = getattr(self, "classes_", None)
        return (type(self).__name__, loss, dtype,
                tuple(np.asarray(classes).tolist()) if classes is not None
                else None)

    @classmethod
    def _cohort_step(cls, models, W, Xb, yb, n_valid, lrs, ops):
        """One step of N stacked models on a shared block: one
        ``fused_sgd_many_block_grad`` launch (``codes=False``) and the
        per-model epilogue. ``lrs`` (N,) and ``ops`` (N, 4) = alpha, l2w,
        l1w, iflag per model are f32 tensors on the device."""
        enc = models[0]
        use_kernel, _ = _kernel_flavor()
        iflags = ops[:, 3]
        if isinstance(Xb, SparseSlab):
            sums, grads = sgd_sparse_block_sums(Xb, n_valid, yb, W, iflags,
                                                enc._loss(), False)
        else:
            fn = fused_sgd_many_block_grad if use_kernel \
                else sgd_many_block_grad_plain
            sums, grads = fn(Xb, n_valid, yb, W, iflags, enc._loss(), False,
                             mxu_dtype(enc.fit_dtype))
        return _sgd_many_update(W, sums, grads, max(int(n_valid), 1), lrs,
                                ops[:, 0], ops[:, 1], ops[:, 2], iflags)

    @staticmethod
    def _cohort_ops(models, device):
        ops = np.asarray(
            [(m.alpha,) + m._penalty_weights()
             + (1.0 if m.fit_intercept else 0.0,) for m in models],
            np.float32)
        return torch.from_numpy(ops).to(device)

    @classmethod
    def _batched_partial_fit(cls, models, X, y):
        """One shared block, one launch, N models advanced by one step
        each (their own lr clocks)."""
        Xs, ys = models[0]._block(X, y)
        d = Xs.shape[1]
        for m in models:
            m._ensure_state(d, Xs.device)
        lrs = torch.from_numpy(np.asarray(
            [m._step_args()[0] for m in models], np.float32)).to(Xs.device)
        if Xs.n_rows == 0:
            return models
        W, losses = cls._cohort_step(
            models, torch.stack([m._w for m in models]), Xs.data, ys.data,
            Xs.n_rows, lrs, cls._cohort_ops(models, Xs.device))
        for i, m in enumerate(models):
            m._w = W[i]
            m._last_loss = losses[i]
        return models

    @classmethod
    def _batch_publish(cls, models, d):
        """Materialize coef_/intercept_ once per round."""
        for m in models:
            m._publish(d)

    @classmethod
    def _batched_fused_calls(cls, models, blocks, order=None):
        """Advance the cohort through a sequence of block steps, one
        launch each: the same updates as that many
        ``_batched_partial_fit`` calls (same per-model lr clocks).
        ``blocks`` are the distinct (X, y) blocks and ``order`` (default:
        each once, in sequence) indexes the steps into them; blocks may
        be ragged."""
        if order is None:
            order = list(range(len(blocks)))
        S = len(order)
        enc = models[0]
        placed = [enc._block(Xb, yb) for Xb, yb in blocks]
        d = placed[0][0].shape[1]
        dev = placed[0][0].device
        for m in models:
            m._ensure_state(d, dev)
        LRS = torch.from_numpy(np.stack(
            [m._lr_schedule(S) for m in models], axis=1)).to(dev)  # (S, N)
        ops = cls._cohort_ops(models, dev)
        W = torch.stack([m._w for m in models])
        losses = None
        for j, b in enumerate(order):
            Xs, ys = placed[int(b)]
            if Xs.n_rows == 0:
                continue
            W, losses = cls._cohort_step(models, W, Xs.data, ys.data,
                                         Xs.n_rows, LRS[j], ops)
        for i, m in enumerate(models):
            m._w = W[i]
            if losses is not None:
                m._last_loss = losses[i]
            m._t += S
        return models

    # -- the streamed cohort protocol (model_selection/_incremental.py's
    # _StreamCohortPlane) ------------------------------------------------
    @classmethod
    def _streamed_cohort_round(cls, models, stream, order, act, n_slots,
                               warm=False):
        """Advance an adaptive-search cohort, heterogeneous windows
        included, through ONE pass of ``stream``: step s trains on block
        ``order[s]``, and model i advances exactly at the steps where
        ``act[s, i] > 0``, with the updates and lr clock of its own
        ``partial_fit`` loop over those blocks.

        Each step gathers the rows of the models active at it from the
        (n_slots, d + 1) stack, makes one ``fused_sgd_many_block_grad``
        launch (``codes=False``) with their lr, alpha, penalty weights
        and intercept flags, runs the ``_sgd_many_update`` epilogue and
        scatters the rows back: a model not active at a step keeps its
        row bit for bit. Losses stay on the device until the round ends.
        ``config.use_kernel`` is the one gate of the kernel (the JAX
        package's ``_cohort_sb_flavor`` also gates on its tile and mode,
        limits of the TPU). There is no compile to warm, so ``warm`` is
        accepted and does nothing. Returns the round's record
        (``dispatches`` counts the launches)."""
        N = len(models)
        n_slots = max(int(n_slots), N)
        d = int(stream.arrays[0].shape[1])
        dev = stream.device
        for m in models:
            m._ensure_state(d, dev)
        order = np.asarray(order, np.int64)
        act = np.asarray(act, np.float32) > 0
        n_steps = len(order)
        LRS = np.ones((n_steps, N), np.float32)
        for i, m in enumerate(models):
            steps = np.flatnonzero(act[:, i])
            LRS[steps, i] = m._lr_schedule(len(steps))
        LRS_d = torch.from_numpy(LRS).to(dev)
        ops = cls._cohort_ops(models, dev)
        W = _stack_cohort_weights(models, n_slots, dev)
        L = torch.zeros((n_steps, N), dtype=torch.float32, device=dev)
        use_kernel, reason = _kernel_flavor()
        if stream.nnz_route:
            use_kernel, reason = False, "sparse-stream"
        info = {"streamed": True, "n_steps": int(n_steps), "shards": 1,
                "sparse": bool(stream.nnz_route), "fused": use_kernel,
                "fused_reason": reason, "dispatches": 0,
                "warm_dispatches": 0}
        rows = {}     # active set -> its row indices on the device
        for s, blk in enumerate(stream.blocks(order)):
            live = np.flatnonzero(act[s])
            if not live.size:
                continue
            key = live.tobytes()
            idx = rows.get(key)
            if idx is None:
                idx = rows[key] = torch.from_numpy(live).to(dev)
            Xb, yb = blk.arrays
            W2, losses = cls._cohort_step(
                models, W.index_select(0, idx), Xb, yb, blk.n_rows,
                LRS_d[s].index_select(0, idx), ops.index_select(0, idx))
            W.index_copy_(0, idx, W2)
            L[s].index_copy_(0, idx, losses)
            info["dispatches"] += 1
        Lh = L.cpu().numpy()
        Wh = W[:N].cpu().numpy()
        for i, m in enumerate(models):
            steps = np.flatnonzero(act[:, i])
            m._w = W[i].clone()
            m._t += len(steps)
            if len(steps):
                m._last_loss = float(Lh[steps[-1], i])
            m._publish_host(Wh[i])
        return info

    @classmethod
    def _cohort_holdout(cls, X_test, y_test, model):
        """Stage the search's validation split once on the device; every
        round scores the surviving cohort against it with one product. A
        sparse split stages as one ``SparseSlab``, never densified."""
        y_enc = np.asarray(model._encode_y(to_host(y_test)), np.float32)
        if _is_sparse_source(X_test):
            Xs = to_slab(X_test, resolve_device())
            return {"kind": "sparse", "X": Xs,
                    "y": as_sharded(y_enc, dtype=np.float32,
                                    device=Xs.device)}
        Xs = as_sharded(np.asarray(X_test), dtype=np.float32,
                        device=resolve_device())
        return {"kind": "dense", "X": Xs,
                "y": as_sharded(y_enc, dtype=np.float32, device=Xs.device)}

    # -- inference ----------------------------------------------------------
    def _decision(self, X):
        """(rows, device decision values (n,) or (n, C)) of a resident X."""
        Xs = as_sharded(X, dtype=np.float32)
        W = self._w.to(Xs.device)
        if self._n_out() is not None:
            return Xs.n_rows, _batched_eta(Xs.data, W)
        return Xs.n_rows, Xs.data @ W[:-1] + W[-1]

    def _eta_stream(self, X, block_rows):
        """Decision values of a streamed X (a memmap): blocks stream
        through the fitted weights, an (n,) or (n, C) host result."""
        W = self._w.to(resolve_device())
        if self._n_out() is not None:
            return streamed_map(X, block_rows,
                                lambda blk: _batched_eta(blk.arrays[0], W))
        return streamed_map(X, block_rows, lambda blk: block_matmul(
            blk.arrays[0], W[:-1]) + W[-1])

    def _eta(self, X):
        block_rows = stream_plan(X)
        if block_rows is not None:
            return self._eta_stream(X, block_rows)
        n, eta = self._decision(X)
        return to_host(eta)[:n]

    def _encode_y(self, y):
        if isinstance(y, ShardedArray):
            return y
        return np.asarray(y)

    def _publish(self, d):
        self._publish_host(to_host(self._w))

    def _publish_host(self, w):
        pass


class SGDClassifier(ClassifierMixin, _SGDBase):
    """Linear classifier trained by minibatch SGD: binary on a flat
    weight vector, more than two classes one-vs-rest on (C, d + 1)
    weights."""

    loss_default = "log_loss"

    def _batch_key(self):
        if getattr(self, "classes_", None) is None:
            # the solo path enforces the first-call classes contract
            return None
        if self._n_out() is not None:
            return None  # multiclass weights are (C, d + 1): solo path
        return super()._batch_key()

    def _set_classes(self, classes):
        if len(classes) < 2:
            raise ValueError("SGDClassifier needs at least 2 classes")
        have = getattr(self, "classes_", None)
        if have is not None and not np.array_equal(classes, have):
            raise ValueError(
                f"classes={classes} is not the same as on last call "
                f"to partial_fit, was: {have}"
            )
        self.classes_ = classes

    def partial_fit(self, X, y, classes=None, **kwargs):
        if classes is None and getattr(self, "classes_", None) is None:
            raise ValueError(
                "classes must be passed on the first call to partial_fit."
            )
        return super().partial_fit(X, y, classes=classes, **kwargs)

    def _encode_y(self, y):
        """Binary: 1.0 for the second class, 0.0 for the first.
        Multiclass: the class codes 0..C-1 (searchsorted over the sorted
        classes_, in the labels' own dtype), as float32. A label outside
        classes_ raises (one host sync for device labels)."""
        classes = getattr(self, "classes_", None)
        if classes is None:
            return y if isinstance(y, ShardedArray) else np.asarray(y)
        unknown = ("y contains classes not passed via `classes` on the "
                   "first partial_fit call")
        if isinstance(y, ShardedArray):
            yd = y.data
            cd = torch.as_tensor(np.asarray(classes), device=yd.device
                                 ).to(yd.dtype)
            valid = y.row_mask(torch.bool)
            if self._n_out() is not None:
                idx = torch.searchsorted(cd, yd).clamp(0, len(classes) - 1)
                ok = cd[idx] == yd
                if bool((valid & ~ok).any()):
                    raise ValueError(unknown)
                return ShardedArray(idx.to(torch.float32), y.n_rows)
            is_pos = yd == cd[1]
            if bool((valid & ~(is_pos | (yd == cd[0]))).any()):
                raise ValueError(unknown)
            return ShardedArray(is_pos.to(torch.float32), y.n_rows)
        yh = np.asarray(y)
        if self._n_out() is not None:
            idx = np.clip(np.searchsorted(classes, yh), 0, len(classes) - 1)
            if not np.array_equal(np.take(classes, idx), yh):
                raise ValueError(unknown)
            return idx.astype(np.float32)
        if not np.isin(yh, classes).all():
            raise ValueError(unknown)
        return (yh == classes[1]).astype(np.float32)

    def _publish_host(self, w):
        w = np.asarray(w, np.float64)
        if self._n_out() is not None:
            self.coef_ = w[:, :-1]
            self.intercept_ = w[:, -1]
        else:
            self.coef_ = w[:-1].reshape(1, -1)
            self.intercept_ = np.atleast_1d(w[-1])

    @classmethod
    def _batched_score_default(cls, models, X, y):
        """Accuracy of N models on a shared test split: one product."""
        Xs, ys = models[0]._block(X, y)
        W = torch.stack([m._w for m in models]).to(Xs.device)
        acc = _batched_accuracy(Xs.data, ys.data, Xs.n_rows, W)
        return to_host(acc).astype(np.float64)

    @classmethod
    def _cohort_holdout_scores(cls, models, holdout, n_slots):
        """Accuracy of the round's cohort on the staged holdout: one
        product of the holdout with the stacked weights."""
        Xs, ys = holdout["X"], holdout["y"]
        W = _stack_cohort_weights(models, n_slots, Xs.device)
        acc = _batched_accuracy(_holdout_x(Xs), ys.data, Xs.n_rows, W)
        return to_host(acc).astype(np.float64)[:len(models)]

    def decision_function(self, X):
        check_is_fitted(self, "coef_")
        return self._eta(X)

    def predict(self, X):
        scores = self.decision_function(X)
        if self._n_out() is not None:
            return self.classes_[np.argmax(scores, axis=1)]
        return self.classes_[(scores > 0).astype(int)]

    def predict_proba(self, X):
        if self._loss() != "log_loss":
            raise AttributeError("predict_proba requires loss='log_loss'")
        check_is_fitted(self, "coef_")
        from scipy.special import expit

        if self._n_out() is not None:
            p = expit(self.decision_function(X))   # one-vs-rest sigmoids
            return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
        p1 = expit(self.decision_function(X))
        return np.stack([1 - p1, p1], axis=1)

    def score(self, X, y):
        return accuracy_score(to_host(y), self.predict(X))


class SGDRegressor(RegressorMixin, _SGDBase):
    loss_default = "squared_error"

    def _set_classes(self, classes):
        raise AttributeError("SGDRegressor has no classes")

    def _batch_prepare(self, fit_params):
        pass

    def _publish_host(self, w):
        w = np.asarray(w, np.float64)
        self.coef_ = w[:-1]
        self.intercept_ = float(w[-1])

    @classmethod
    def _batched_score_default(cls, models, X, y):
        """R² of N models on a shared test split: one product."""
        Xs, ys = models[0]._block(X, y)
        W = torch.stack([m._w for m in models]).to(Xs.device)
        return to_host(_batched_r2(Xs.data, ys.data, Xs.n_rows, W)
                       ).astype(np.float64)

    @classmethod
    def _cohort_holdout_scores(cls, models, holdout, n_slots):
        """R² twin of the classifier's round scoring."""
        Xs, ys = holdout["X"], holdout["y"]
        W = _stack_cohort_weights(models, n_slots, Xs.device)
        r2 = _batched_r2(_holdout_x(Xs), ys.data, Xs.n_rows, W)
        return to_host(r2).astype(np.float64)[:len(models)]

    def predict(self, X):
        check_is_fitted(self, "coef_")
        return self._eta(X)

    def score(self, X, y):
        return r2_score(to_host(y), self.predict(X))
