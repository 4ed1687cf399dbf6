"""Generalized linear models: LinearRegression, LogisticRegression,
PoissonRegression — in memory, binary.

Counterpart of ``dask_ml_tpu/models/glm.py``: the same parameters,
fitted attributes and objective (``mean-NLL + lam * r(coef)`` with
``lam = 1 / (C * n_samples)`` and the intercept unpenalized, sklearn's
scaling). The solvers are ``solvers/solvers.py``; on the card each of
their function evaluations is one read of X by the fused kernel.

Not ported yet, and raising ``NotImplementedError`` that names its
ROADMAP item: multiclass one-vs-rest, the streamed (out-of-core) fit,
the C-grid search fast path and ``checkpoint_path``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, log_proba
from ..config import mxu_dtype
from ..utils.validation import check_array, check_is_fitted, check_X_y
from .solvers import regularizers
from .solvers.solvers import solve


def _check_poisson_targets(ymin):
    if ymin < 0:
        raise ValueError(
            "PoissonRegression requires non-negative targets; "
            f"got min(y) = {ymin}"
        )


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

    def _check_unsupported(self):
        if self.class_weight is not None:
            raise ValueError(
                "class_weight is not supported; reweight via "
                "sample-level resampling, or leave class_weight=None"
            )
        kwargs = self.solver_kwargs or {}
        if kwargs.get("checkpoint_path"):
            raise NotImplementedError(
                "checkpoint_path is not ported yet: ROADMAP queue 1 "
                "item 13 (utils/checkpoint.py)"
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

    def fit(self, X, y):
        self._check_unsupported()
        if isinstance(X, np.memmap):
            raise NotImplementedError(
                "the streamed (out-of-core) fit is not ported yet: "
                "ROADMAP queue 1 item 6"
            )
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
        classes = None
        if self.family == "logistic":
            pk = packed.cpu().numpy()
            if not bool(pk[2]) or pk[0] == pk[1]:
                return self._fit_multiclass(X, y)
            classes = np.asarray(pk[:2])
            self.classes_ = classes
        d = data.shape[1]
        pmask, lam = self._penalty_setup(d, X.n_rows)
        dev = data.device
        kwargs = dict(self.solver_kwargs or {})
        l1_ratio = kwargs.pop("l1_ratio", 0.5)
        beta, info = solve(
            self.solver,
            X=data, y=y_data, mask=mask, n_rows=X.n_rows,
            beta0=torch.as_tensor(self._warm_beta0(d), device=dev),
            family=self.family, reg=self.penalty, lam=float(lam),
            pmask=torch.as_tensor(pmask, device=dev), l1_ratio=l1_ratio,
            max_iter=self.max_iter, tol=self.tol, **kwargs,
        )
        return self._finish_fit(beta, classes, info, X.shape[1])

    def _fit_multiclass(self, X, y):
        n_classes = len(np.unique(y.to_numpy()))
        if n_classes < 2:
            raise ValueError(
                f"LogisticRegression needs at least 2 classes; got "
                f"{n_classes}"
            )
        raise NotImplementedError(
            "multiclass (one-vs-rest) LogisticRegression is not ported "
            "yet: ROADMAP queue 1 item 3 (its kernel "
            "fused_glm_multi_value_grad is queue 2 item 4)"
        )

    def _fit_C_grid(self, *args, **kwargs):
        raise NotImplementedError(
            "the stacked C-grid search fit is not ported yet: ROADMAP "
            "queue 1 item 2 (the lambda-grid solvers)"
        )

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
        """Decision values as a host (n,) array."""
        X = check_array(X, dtype=np.float32)
        coef = torch.as_tensor(np.asarray(self._coef_flat(), np.float32),
                               device=X.device)
        eta = X.data @ coef + float(self._intercept_scalar())
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

    def predict(self, X):
        check_is_fitted(self, "coef_")
        return np.exp(self._eta_host(X))

    def score(self, X, y):
        from ..metrics import r2_score

        return r2_score(y, self.predict(X))


class LogisticRegression(_GLMBase):
    """Ref: dask_ml/linear_model/glm.py::LogisticRegression, binary."""

    family = "logistic"

    def _set_coef(self, coef, classes):
        self.coef_ = coef.reshape(1, -1)
        self.intercept_ = np.atleast_1d(self.intercept_)

    def decision_function(self, X):
        check_is_fitted(self, "coef_")
        return self._eta_host(X)

    def predict_proba(self, X):
        from scipy.special import expit

        check_is_fitted(self, "coef_")
        p1 = expit(self._eta_host(X))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict_log_proba(self, X):
        return log_proba(self.predict_proba(X))

    def predict(self, X):
        proba = self.predict_proba(X)
        return self.classes_[(proba[:, 1] > 0.5).astype(int)]

    def score(self, X, y):
        from ..metrics import accuracy_score

        return accuracy_score(y, self.predict(X))

