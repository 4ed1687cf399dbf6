"""Generalized linear models: LinearRegression, LogisticRegression,
PoissonRegression — in memory, binary and one-vs-rest multiclass.

Counterpart of ``dask_ml_tpu/models/glm.py``: the same parameters,
fitted attributes and objective (``mean-NLL + lam * r(coef)`` with
``lam = 1 / (C * n_samples)`` and the intercept unpenalized, sklearn's
scaling). The solvers are ``solvers/solvers.py``: lbfgs,
gradient_descent, proximal_grad, newton and admm (the default). On the
card each function evaluation of the first four reads X once through a
fused kernel; LogisticRegression on more than two classes fits one-vs-rest
(``solvers.solve_multi``).

Out of core: a host ``np.memmap``, or a numpy array taller than a
positive ``config.stream_block_rows``, is fitted by streaming it through
the device in blocks (``_fit_streamed``, ``solvers/streamed.py``); the
binary and one-vs-rest fits run every solver, and ``decision_function``,
``predict`` and ``predict_proba`` stream such inputs the same way.

GridSearchCV's C-grid fast path (``_fit_C_grid``) fits every candidate
of a pure-``C`` lbfgs grid in one stacked solve per fold
(``solvers.solve_lam_grid``, ``solve_lam_grid_multi`` for one-vs-rest).

A sparse X (scipy sparse or ``SparseBlocks``) always streams: on the
stream's nnz route the passes cost time in proportion to its nonzeros
(``solver_info_["sparse_stream"]``), ADMM and a corpus over the density
limit densify each block on the host (``sparse_stream_reason``). The
C-grid fast path densifies a sparse fold once, within
``config.to_dense_byte_budget`` (``"search-dense-solve"``), and leaves an
over-budget fold to the per-candidate streamed fits.

Several processes (``parallel/distributed.py``): a streamed fit streams
each process's own rows, its row count and class set are global (a
``psum_host`` and an ``allgather_object``) and every pass's sums merge
across processes (``solvers/streamed.py``); a resident fit over a
process-local ``ShardedArray`` (``array_from_process_local``) merges each
evaluation's sums (``solvers.merge_sums``) and fits on the global row
count and classes. Every process ends with the same coefficients.

Checkpoints: ``solver_kwargs={"checkpoint_path": p, "checkpoint_every":
k}`` runs the resident lbfgs in k-iteration chunks, its whole loop state
saved after each (``solver_info_["resumed_from"]``); the other resident
solvers ignore the two keys, and a one-vs-rest lbfgs given them fits per
class, as in the JAX package. A streamed fit saves its solver's host
state after each iteration under ``config.stream_checkpoint_path``
(``reliability/stream_ckpt.py``, kind ``"glm"``; never for
``warm_start``, whose start the token cannot cover) and resumes a killed
fit bit-equal. A streamed fit carries ``training_profile_``, the
per-feature sketch of its first pass (``BlockStream.profile_snapshot``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, log_proba
from ..config import mxu_dtype
from ..parallel.sharded import ShardedArray
from ..ops.sparse_kernels import block_matmul
from ..parallel.streaming import (BlockStream, _is_sparse_source,
                                  _slice_dense, stream_plan, streamed_map)
from ..utils.validation import check_array, check_is_fitted, check_X_y
from .solvers import regularizers
from .solvers.solvers import (solve, solve_lam_grid, solve_lam_grid_multi,
                              solve_multi)
from .solvers.streamed import solve_streamed, solve_streamed_multi


def _check_poisson_targets(ymin):
    if ymin < 0:
        raise ValueError(
            "PoissonRegression requires non-negative targets; "
            f"got min(y) = {ymin}"
        )


def add_intercept(X):
    """X with a ones column appended (ref:
    dask_ml/linear_model/utils.py::add_intercept). A ShardedArray's ones
    are its row mask, so padding rows stay zero; any other input is taken
    as a 2-D host array."""
    if isinstance(X, ShardedArray):
        ones = X.row_mask(dtype=X.data.dtype)[:, None]
        return ShardedArray(torch.cat([X.data, ones], dim=1), X.n_rows)
    arr = np.asarray(X)
    return np.concatenate([arr, np.ones((arr.shape[0], 1), arr.dtype)],
                          axis=1)


def _onehot_targets(y, mask, classes):
    """(C, n) one-vs-rest targets, padding rows zeroed: the encoding of
    ``dask_ml_tpu/models/solvers/streamed.py::onehot_targets``."""
    return (y[None, :] == classes[:, None]).to(torch.float32) \
        * mask[None, :]


def _prepare_fit(Xd, yd, mask, fit_intercept, to_bf16, encode):
    """All fit prep: intercept column (equal to the row mask, so padding
    rows stay zero), bf16 cast, binary label scan and encoding. Returns
    (design, targets, (min label, max label, binary?))."""
    if fit_intercept:
        Xd = torch.cat([Xd, mask[:, None].to(Xd.dtype)], dim=1)
    if to_bf16:
        Xd = Xd.to(torch.bfloat16)
    if encode:
        valid = mask > 0
        mn = torch.where(valid, yd, torch.inf).min()
        mx = torch.where(valid, yd, -torch.inf).max()
        binary = (~valid | (yd == mn) | (yd == mx)).all()
        y_enc = (yd == mx).to(torch.float32) * mask
        packed = torch.stack([mn, mx, binary.to(yd.dtype)])
    else:
        y_enc = yd
        packed = torch.zeros(3, dtype=yd.dtype, device=yd.device)
    return Xd, y_enc, packed


class _GLMBase(BaseEstimator):
    family: str = None  # overridden per subclass

    def __init__(self, penalty="l2", dual=False, tol=1e-4, C=1.0,
                 fit_intercept=True, intercept_scaling=1.0, class_weight=None,
                 random_state=None, solver="admm", max_iter=100,
                 multi_class="ovr", verbose=0, warm_start=False, n_jobs=1,
                 solver_kwargs=None, fit_dtype=None):
        self.penalty = penalty
        self.dual = dual
        self.tol = tol
        self.C = C
        self.fit_intercept = fit_intercept
        self.intercept_scaling = intercept_scaling
        self.class_weight = class_weight
        self.random_state = random_state
        self.solver = solver
        self.max_iter = max_iter
        self.multi_class = multi_class
        self.verbose = verbose
        self.warm_start = warm_start
        self.n_jobs = n_jobs
        self.solver_kwargs = solver_kwargs
        # per-estimator precision override: None follows config.dtype
        self.fit_dtype = fit_dtype

    # hooks a family must provide for more than two classes (logistic
    # only): other families fail with a clear contract
    def _warm_B0(self, C, d):
        raise NotImplementedError(
            f"{type(self).__name__} does not support multiclass targets"
        )

    def _finish_fit_multi(self, beta, classes, info, n_features):
        raise NotImplementedError(
            f"{type(self).__name__} does not support multiclass targets"
        )

    def _check_unsupported(self):
        if self.class_weight is not None:
            raise ValueError(
                "class_weight is not supported; reweight via "
                "sample-level resampling, or leave class_weight=None"
            )

    def _penalty_setup(self, d, n_rows):
        """(pmask, lam): intercept unpenalized, sklearn's 1/(C*n)."""
        pmask = np.ones(d, np.float32)
        if self.fit_intercept:
            pmask[-1] = 0.0
        lam = 1.0 / (self.C * n_rows) if self.penalty != "none" else 0.0
        return pmask, lam

    def _warm_beta0(self, d):
        """Shape-guarded warm start: a coef_ of another problem shape
        is not reused."""
        if self.warm_start and getattr(self, "coef_", None) is not None:
            single = np.ndim(self.coef_) == 1 or np.shape(self.coef_)[0] == 1
            flat = self._coef_flat()
            if single and flat.shape[0] == d - int(self.fit_intercept):
                b = (np.r_[flat, np.ravel(self.intercept_)[:1]]
                     if self.fit_intercept else flat)
                return np.asarray(b, np.float32)
        return np.zeros(d, np.float32)

    def _finish_fit(self, beta, classes, info, n_features):
        beta = np.asarray(beta, np.float64)
        if self.fit_intercept:
            self.intercept_ = beta[-1]
            coef = beta[:-1]
        else:
            self.intercept_ = 0.0
            coef = beta
        self._set_coef(coef, classes)
        self.n_iter_ = info.get("n_iter")
        self.solver_info_ = info
        self.n_features_in_ = n_features
        return self

    def _encode_y_host(self, y):
        """Host f32 targets of a streamed fit, and the classes (None for
        the regressions)."""
        return np.asarray(y, np.float32), None

    def _fit_streamed(self, X, y, block_rows):
        """Out-of-core fit: X stays on the host (np.memmap or a large
        ndarray) and streams through the device in blocks into the
        streamed solvers (``solvers/streamed.py``); y is encoded to a
        host float32 vector (class codes for one-vs-rest), 1/d the size
        of X, and streams beside it."""
        if self.penalty not in regularizers.KNOWN:
            raise ValueError(f"Unknown penalty {self.penalty!r}")
        if len(y) != X.shape[0]:
            raise ValueError(f"X and y have inconsistent lengths: "
                             f"{X.shape[0]} vs {len(y)}")
        from ..parallel import distributed as dist

        reduce = dist.host_reduce()
        y_host, classes = self._encode_y_host(y)
        n, d_feat = X.shape[0], X.shape[1]
        if reduce is not None:
            # several processes: X, y are this process's rows; the row
            # count (and the class set, in _encode_y_host) is global
            n = int(dist.psum_host(np.asarray(float(n))))
        d = d_feat + (1 if self.fit_intercept else 0)
        pmask, lam = self._penalty_setup(d, n)
        # ADMM's block-local Newton solves take dense blocks
        stream = BlockStream(
            (X, y_host), block_rows=block_rows,
            densify_reason="admm-local-newton" if self.solver == "admm"
            else None)
        kwargs = dict(self.solver_kwargs or {})
        l1_ratio = kwargs.pop("l1_ratio", 0.5)
        ckpt = None
        if not self.warm_start:
            from ..reliability.stream_ckpt import stream_checkpoint

            ckpt = stream_checkpoint(
                "glm",
                (type(self).__name__, self.solver, self.penalty, self.C,
                 float(lam), l1_ratio, self.fit_intercept, self.max_iter,
                 self.tol, self.family, repr(sorted(kwargs.items())), n, d,
                 int(stream.block_rows),
                 None if classes is None
                 else tuple(np.asarray(classes).tolist())),
                arrays=(X, y_host))
        common = dict(l1_ratio=l1_ratio, intercept=self.fit_intercept,
                      max_iter=self.max_iter, tol=self.tol,
                      fit_dtype=self.fit_dtype, ckpt=ckpt, reduce=reduce,
                      **kwargs)
        if classes is not None and len(classes) > 2:
            # one-vs-rest: y_host holds class codes, and every pass reads
            # X once for all C classes
            C = len(classes)
            B, info = solve_streamed_multi(
                self.solver, stream, n, self._warm_B0(C, d), self.family,
                self.penalty, lam, pmask, **common)
            self._finish_fit_multi(B, classes, info, d_feat)
        else:
            beta, info = solve_streamed(
                self.solver, stream, n, self._warm_beta0(d), self.family,
                self.penalty, lam, pmask, **common)
            self._finish_fit(beta, classes, info, d_feat)
        self.fit_dtype_ = info["fit_dtype"]
        self.stream_stats_ = stream.totals
        self.training_profile_ = stream.profile_snapshot()
        return self

    def fit(self, X, y):
        self._check_unsupported()
        block_rows = stream_plan(X)
        if block_rows is not None:
            return self._fit_streamed(X, y, block_rows)
        X, y = check_X_y(X, y, dtype=np.float32)
        if self.penalty not in regularizers.KNOWN:
            raise ValueError(f"Unknown penalty {self.penalty!r}")
        use_bf16 = mxu_dtype(self.fit_dtype) is not None and self.solver in (
            "lbfgs", "gradient_descent", "proximal_grad"
        )
        self.fit_dtype_ = "bfloat16" if use_bf16 else "float32"
        mask = X.row_mask(dtype=torch.float32)
        data, y_data, packed = _prepare_fit(
            X.data, y.data, mask, fit_intercept=self.fit_intercept,
            to_bf16=use_bf16, encode=self.family == "logistic",
        )
        if self.family == "poisson":
            _check_poisson_targets(
                float(torch.where(mask > 0, y_data, torch.inf).min())
            )
        merged = self._merged_fit_args(X)
        classes = None
        if self.family == "logistic":
            if merged:
                # the global class set; the 0/1 targets against its larger
                # class (a process holding one class still encodes alike)
                classes = self._global_classes(y)
                if len(classes) != 2:
                    return self._fit_multiclass(X, y, data, mask,
                                                classes=classes)
                y_data = (y.data == float(classes[1])).to(torch.float32) \
                    * mask
            else:
                pk = packed.cpu().numpy()
                if not bool(pk[2]) or pk[0] == pk[1]:
                    # >2 (or 1) classes: the one-vs-rest path
                    return self._fit_multiclass(X, y, data, mask)
                classes = np.asarray(pk[:2])
            self.classes_ = classes
        d = data.shape[1]
        n_rows = X.global_rows if merged else X.n_rows
        pmask, lam = self._penalty_setup(d, n_rows)
        dev = data.device
        kwargs = dict(self.solver_kwargs or {})
        l1_ratio = kwargs.pop("l1_ratio", 0.5)
        kwargs.update(merged)
        beta, info = solve(
            self.solver,
            X=data, y=y_data, mask=mask, n_rows=n_rows,
            beta0=torch.as_tensor(self._warm_beta0(d), device=dev),
            family=self.family, reg=self.penalty, lam=float(lam),
            pmask=torch.as_tensor(pmask, device=dev), l1_ratio=l1_ratio,
            max_iter=self.max_iter, tol=self.tol, **kwargs,
        )
        return self._finish_fit(beta, classes, info, X.shape[1])

    def _fit_C_grid_multiclass(self, X, y, data, mask, Cs):
        """Multiclass arm of the C-grid fast path; only the logistic
        family overrides it."""
        return None

    @staticmethod
    def _merged_fit_args(X):
        """The solver keywords of a resident fit over a process-local
        array under several processes (``reduce``, this process's valid
        rows), else none: its sums then merge across processes at each
        evaluation (``solvers.merge_sums``)."""
        from ..parallel import distributed as dist

        reduce = dist.host_reduce() if X.process_local else None
        if reduce is None:
            return {}
        return {"reduce": reduce, "n_valid": X.n_rows}

    @staticmethod
    def _global_classes(y):
        """The union of every process's labels."""
        from ..parallel import distributed as dist

        local = np.unique(y.to_numpy())
        return np.unique(np.concatenate(dist.allgather_object(local)))

    def _run_C_grid(self, X, Cs, d, solve_fn, finish):
        """Shared tail of both C-grid arms: per-C (pmask, lam) through
        ``_penalty_setup``, one stacked solve, then fitted clones in
        ``Cs`` order, each with its own convergence point as ``n_iter_``.
        ``solve_fn(lams, pmask) -> (B, info)``; ``finish(est, B_i,
        info)`` publishes one candidate."""
        from ..base import clone

        per_c = [clone(self).set_params(C=c)._penalty_setup(d, X.n_rows)
                 for c in Cs]
        reason = getattr(self, "_c_grid_sparse_reason", None)
        pmask = per_c[0][0]
        B, info = solve_fn([lam for _, lam in per_c], pmask)
        B = np.asarray(B, np.float64)
        per_cand = info.get("n_iter_per_candidate")
        dt_label = "bfloat16" if mxu_dtype(self.fit_dtype) is not None \
            else "float32"
        fitted = []
        for i, c in enumerate(Cs):
            est = clone(self).set_params(C=c)
            est.fit_dtype_ = dt_label
            info_i = dict(info)
            if per_cand is not None:
                info_i["n_iter"] = int(per_cand[i])
            if reason is not None:
                # a sparse fold densified for the stacked solve is on
                # record in every clone
                info_i.setdefault("sparse_stream", False)
                info_i.setdefault("sparse_stream_reason", reason)
            finish(est, B[i], info_i)
            fitted.append(est)
        return fitted

    def _fit_C_grid(self, X, y, Cs):
        """Fit ``len(Cs)`` clones differing only in ``C`` as ONE stacked
        L-BFGS solve over the shared design (GridSearchCV's fast path).
        Returns the fitted clones in ``Cs`` order, or None when the fit
        is not eligible (the caller fits per candidate). A sparse X is
        densified once within ``config.to_dense_byte_budget`` (over it,
        not eligible); an out-of-core X is not eligible."""
        if (self.solver != "lbfgs" or self.penalty not in ("l2", "none")
                or self.solver_kwargs or self.warm_start
                or self.class_weight is not None):
            return None
        self._c_grid_sparse_reason = None
        if _is_sparse_source(X):
            from ..feature_extraction.text import DenseBudgetExceeded

            try:
                X = self._dense_search_solve(X)
            except DenseBudgetExceeded:
                return None
            self._c_grid_sparse_reason = "search-dense-solve"
        elif stream_plan(X) is not None:
            return None
        X, y = check_X_y(X, y, dtype=np.float32)
        mask = X.row_mask(dtype=torch.float32)
        data, y_data, packed = _prepare_fit(
            X.data, y.data, mask, fit_intercept=self.fit_intercept,
            to_bf16=mxu_dtype(self.fit_dtype) is not None,
            encode=self.family == "logistic",
        )
        if self.family == "poisson":
            _check_poisson_targets(
                float(torch.where(mask > 0, y_data, torch.inf).min()))
        classes = None
        if self.family == "logistic":
            pk = packed.cpu().numpy()
            if not bool(pk[2]) or pk[0] == pk[1]:
                # more than two classes: k x C one-vs-rest blocks in one
                # solve (a single class keeps None: the general path
                # raises the clean error)
                return self._fit_C_grid_multiclass(X, y, data, mask, Cs)
            classes = np.asarray(pk[:2])
        d = data.shape[1]

        def finish(est, Bi, info):
            if classes is not None:
                est.classes_ = classes
            est._finish_fit(Bi, classes, info, d - int(self.fit_intercept))

        return self._run_C_grid(
            X, Cs, d,
            lambda lams, pmask: solve_lam_grid(
                data, y_data, mask, X.n_rows, lams, pmask, self.family,
                self.penalty, max_iter=self.max_iter, tol=self.tol),
            finish)

    def _dense_search_solve(self, X):
        """A sparse fold dense for the stacked C-grid solve, once, within
        ``config.to_dense_byte_budget``; over it, the typed
        ``DenseBudgetExceeded`` (the search keeps its per-candidate
        streamed fits)."""
        from ..config import get_config
        from ..feature_extraction.text import DenseBudgetExceeded

        n, d = int(X.shape[0]), int(X.shape[1])
        nbytes = 4 * n * d
        budget = int(get_config().to_dense_byte_budget)
        if budget > 0 and nbytes > budget:
            raise DenseBudgetExceeded(
                f"the stacked C-grid/OvR search solve would densify a "
                f"{n} x {d} sparse fold ({nbytes >> 20} MiB > "
                f"config.to_dense_byte_budget {budget >> 20} MiB); "
                "falling back to streamed per-candidate fits")
        return _slice_dense(X, 0, n, np.float32)

    def _coef_flat(self):
        return np.ravel(self.coef_)

    def _intercept_scalar(self) -> np.float32:
        """intercept_ as one scalar: binary LogisticRegression stores
        shape (1,), the regressions a plain float."""
        return np.float32(np.ravel(self.intercept_)[0]
                          if np.ndim(self.intercept_) else self.intercept_)

    def _set_coef(self, coef, classes):
        self.coef_ = coef

    def _eta_host(self, X):
        """Decision values as a host (n,) array; an out-of-core input
        streams block by block instead of landing on the device whole."""
        coef = np.asarray(self._coef_flat(), np.float32)
        b0 = float(self._intercept_scalar())
        block_rows = stream_plan(X)
        if block_rows is not None:
            return streamed_map(X, block_rows, lambda blk: block_matmul(
                blk.arrays[0], torch.as_tensor(
                    coef, device=blk.arrays[0].device)) + b0)
        X = check_array(X, dtype=np.float32)
        eta = X.data @ torch.as_tensor(coef, device=X.device) + b0
        return eta[: X.n_rows].cpu().numpy()


class LinearRegression(_GLMBase):
    """Ref: dask_ml/linear_model/glm.py::LinearRegression."""

    family = "normal"

    def predict(self, X):
        check_is_fitted(self, "coef_")
        return self._eta_host(X)

    def score(self, X, y):
        from ..metrics import r2_score

        return r2_score(y, self.predict(X))


class PoissonRegression(_GLMBase):
    """Ref: dask_ml/linear_model/glm.py::PoissonRegression."""

    family = "poisson"

    def _encode_y_host(self, y):
        y = np.asarray(y, np.float32)
        if y.size:
            _check_poisson_targets(float(y.min()))
        return y, None

    def predict(self, X):
        check_is_fitted(self, "coef_")
        return np.exp(self._eta_host(X))

    def score(self, X, y):
        from ..metrics import r2_score

        return r2_score(y, self.predict(X))


class LogisticRegression(_GLMBase):
    """Ref: dask_ml/linear_model/glm.py::LogisticRegression. More than
    two classes fit one-vs-rest: C binary problems on one design matrix,
    jointly for lbfgs (one read of X per evaluation for every class on
    the card), per class for the other solvers."""

    family = "logistic"

    def _fit_multiclass(self, X, y, data, mask, classes=None):
        self._check_multi_class()
        if classes is None:
            classes = np.unique(y.to_numpy())
        if len(classes) < 2:
            raise ValueError(
                f"LogisticRegression needs at least 2 classes; got "
                f"{len(classes)}"
            )
        dev = data.device
        Y = _onehot_targets(y.data, mask, torch.as_tensor(
            classes, dtype=y.data.dtype, device=dev))
        d = data.shape[1]
        merged = self._merged_fit_args(X)
        n_rows = X.global_rows if merged else X.n_rows
        pmask, lam = self._penalty_setup(d, n_rows)
        C = len(classes)
        kwargs = dict(self.solver_kwargs or {})
        l1_ratio = kwargs.pop("l1_ratio", 0.5)
        kwargs.update(merged)
        beta, info = solve_multi(
            self.solver, X=data, Y=Y, mask=mask, n_rows=n_rows,
            B0=torch.as_tensor(self._warm_B0(C, d), device=dev),
            family=self.family, reg=self.penalty, lam=float(lam),
            pmask=torch.as_tensor(pmask, device=dev), l1_ratio=l1_ratio,
            max_iter=self.max_iter, tol=self.tol, **kwargs,
        )
        return self._finish_fit_multi(beta, classes, info, X.shape[1])

    def _fit_C_grid_multiclass(self, X, y, data, mask, Cs):
        """k candidates x C one-vs-rest classes as one stacked solve per
        fold; None for a single class (the general path raises)."""
        if self.multi_class not in ("auto", "ovr"):
            return None
        classes = np.unique(y.to_numpy())
        if len(classes) < 2:
            return None
        Y = _onehot_targets(y.data, mask, torch.as_tensor(
            classes, dtype=y.data.dtype, device=data.device))
        d = data.shape[1]
        return self._run_C_grid(
            X, Cs, d,
            lambda lams, pmask: solve_lam_grid_multi(
                data, Y, mask, X.n_rows, lams, pmask, self.family,
                self.penalty, max_iter=self.max_iter, tol=self.tol),
            lambda est, Bi, info: est._finish_fit_multi(
                Bi, classes, info, d - int(self.fit_intercept)))

    def _encode_y_host(self, y):
        """Host targets of a streamed fit: 0/1 against the larger of two
        classes, or the class codes 0..C-1 as float32 for more."""
        from ..parallel import distributed as dist

        y = np.asarray(y)
        classes = np.unique(y)
        if dist.process_count() > 1:
            # the class set is the union over every process's rows (a
            # process missing a class must not shift the others' codes)
            classes = np.unique(np.concatenate(
                dist.allgather_object(classes)))
        if len(classes) < 2:
            raise ValueError(
                f"LogisticRegression needs at least 2 classes; got "
                f"{len(classes)}"
            )
        self.classes_ = classes
        if len(classes) > 2:
            self._check_multi_class()
            return np.searchsorted(classes, y).astype(np.float32), classes
        return (y == classes[1]).astype(np.float32), classes

    def _check_multi_class(self):
        if self.multi_class not in ("auto", "ovr"):
            raise ValueError(
                f"multi_class={self.multi_class!r} is not supported; "
                "use 'ovr' (or 'auto')"
            )

    def _warm_B0(self, C, d):
        """(C, d) start: the prior one-vs-rest coefficients when
        warm_start and the shape matches this problem, else zeros."""
        if (self.warm_start and getattr(self, "coef_", None) is not None
                and np.shape(self.coef_)
                == (C, d - (1 if self.fit_intercept else 0))):
            return np.asarray(
                np.c_[self.coef_, np.ravel(self.intercept_)]
                if self.fit_intercept else self.coef_, np.float32,
            )
        return np.zeros((C, d), np.float32)

    def _finish_fit_multi(self, beta, classes, info, n_features):
        beta = np.asarray(beta, np.float64)
        if self.fit_intercept:
            self.intercept_ = beta[:, -1]
            self.coef_ = beta[:, :-1]
        else:
            self.intercept_ = np.zeros(len(classes))
            self.coef_ = beta
        self.classes_ = classes
        self.n_iter_ = info.get("n_iter")
        self.solver_info_ = info
        self.n_features_in_ = n_features
        return self

    def _is_multiclass(self):
        return getattr(self, "coef_", None) is not None \
            and np.ndim(self.coef_) == 2 and self.coef_.shape[0] > 1

    def _set_coef(self, coef, classes):
        self.coef_ = coef.reshape(1, -1)
        self.intercept_ = np.atleast_1d(self.intercept_)

    def _eta_multi_host(self, X):
        """(n, C) decision values against the stacked one-vs-rest
        coefficients; an out-of-core input streams block by block."""
        coef = np.asarray(self.coef_, np.float32)
        b = np.asarray(self.intercept_, np.float32)

        def eta(data):
            dev = data.device
            return block_matmul(data, torch.as_tensor(coef, device=dev).T) \
                + torch.as_tensor(b, device=dev)

        block_rows = stream_plan(X)
        if block_rows is not None:
            return streamed_map(X, block_rows, lambda blk: eta(blk.arrays[0]))
        X = check_array(X, dtype=np.float32)
        return eta(X.data)[: X.n_rows].cpu().numpy()

    def decision_function(self, X):
        check_is_fitted(self, "coef_")
        if self._is_multiclass():
            return self._eta_multi_host(X)
        return self._eta_host(X)

    def predict_proba(self, X):
        from scipy.special import expit

        check_is_fitted(self, "coef_")
        if self._is_multiclass():
            # per-class sigmoids normalized to sum 1 (sklearn's OvR rule)
            p = expit(self._eta_multi_host(X))
            return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
        p1 = expit(self._eta_host(X))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict_log_proba(self, X):
        return log_proba(self.predict_proba(X))

    def predict(self, X):
        if self._is_multiclass():
            return self.classes_[np.argmax(self._eta_multi_host(X), axis=1)]
        proba = self.predict_proba(X)
        return self.classes_[(proba[:, 1] > 0.5).astype(int)]

    def score(self, X, y):
        from ..metrics import accuracy_score

        return accuracy_score(y, self.predict(X))

