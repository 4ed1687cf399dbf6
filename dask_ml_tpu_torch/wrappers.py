"""Meta-estimator wrappers: ParallelPostFit and Incremental.

Counterpart of ``dask_ml_tpu/wrappers.py`` (dask-ml's
``dask_ml/wrappers.py`` and ``_partial.py``):

- ``ParallelPostFit``: fit on host data; predict, transform and score
  through the wrapped estimator, a port estimator directly on the card,
  any other estimator block by block on the host.
- ``Incremental``: a pass of ``partial_fit`` steps over the blocks of X,
  optionally in a shuffled order. A port SGD estimator on device data
  steps on views of X's ``grid_partition`` blocks (``_fused_epoch``); on
  host data, through a ``BlockStream`` of ``fit_block_rows`` blocks
  (``_stream_pass``). Both train the same minibatches in the same order
  as the JAX package's wrapper.

``scoring=`` names a scorer of ``metrics.SCORERS`` (or is a callable)
that ``score`` uses in place of accuracy or R².

Sparse X (scipy sparse or ``SparseBlocks``): a port estimator takes it
as it is (its fits stream it); any other estimator gets CSR
(``_host_matrix``, the one sparse/dense coercion point), fits on it and
predicts block by block on CSR row blocks, and a sparse output stays
sparse. Incremental's pass over a sparse host X streams it through a
port SGD estimator's ``_stream_pass``, or slices CSR blocks for
``partial_fit``.

Not ported, each raising ``NotImplementedError`` that names its item of
ROADMAP.md queue 1: the pass checkpoints (``resume_from_checkpoint``,
Checkpoints and reliability) and the compiled serving entry point
(``compiled_batch_fn``, Execution and serving).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .base import BaseEstimator, clone, to_host
from .metrics import accuracy_score, r2_score
from .parallel.sharded import ShardedArray, as_sharded
from .parallel.streaming import (_is_sparse_source, as_row_indexable,
                                 fit_block_rows, grid_partition)

__all__ = ["ParallelPostFit", "Incremental"]

_PACKAGE = __name__.split(".")[0]


def _is_device_estimator(est):
    """An estimator of this package (and no other whose name merely
    begins the same way)."""
    return type(est).__module__.split(".")[0] == _PACKAGE


def _host(a):
    return None if a is None else to_host(a)


def _on_device(X):
    return isinstance(X, (ShardedArray, torch.Tensor))


def _host_matrix(X):
    """X on the host in a form that slices rows: CSR for any sparse
    source, numpy otherwise."""
    if _is_sparse_source(X):
        return as_row_indexable(X)
    return to_host(X)


def _host_blocks(X, block_size=100_000):
    """Host row blocks of X, for estimators of other packages; a sparse X
    stays sparse (CSR blocks)."""
    host = _host_matrix(X)
    for i in range(0, host.shape[0], block_size):
        yield host[i:i + block_size]


def _is_classifier(est):
    return getattr(est, "_estimator_type", None) == "classifier"


class ParallelPostFit(BaseEstimator):
    """Ref: dask_ml/wrappers.py::ParallelPostFit. The ``*_meta``
    parameters pin the output dtype when given."""

    def __init__(self, estimator=None, scoring=None, predict_meta=None,
                 predict_proba_meta=None, transform_meta=None):
        self.estimator = estimator
        self.scoring = scoring
        self.predict_meta = predict_meta
        self.predict_proba_meta = predict_proba_meta
        self.transform_meta = transform_meta

    def fit(self, X, y=None, **kwargs):
        est = clone(self.estimator)
        # an in-memory fit on host data, as in the JAX package: device data
        # is copied to the host (an np.memmap stays one)
        if _on_device(X):
            X = to_host(X)
        elif _is_sparse_source(X) and not _is_device_estimator(est):
            X = as_row_indexable(X)
        if _on_device(y):
            y = to_host(y)
        if y is None:
            est.fit(X, **kwargs)
        else:
            est.fit(X, y, **kwargs)
        self.estimator_ = est
        return self

    @property
    def _est(self):
        # a wrapped estimator fitted elsewhere serves without fit()
        return getattr(self, "estimator_", self.estimator)

    @property
    def classes_(self):
        return self._est.classes_

    def _pin_meta(self, out, method):
        meta = {"predict": self.predict_meta,
                "predict_proba": self.predict_proba_meta,
                "transform": self.transform_meta}.get(method)
        if meta is not None and hasattr(meta, "dtype") \
                and (isinstance(out, np.ndarray) or sp.issparse(out)):
            out = out.astype(meta.dtype, copy=False)
        return out

    def _apply(self, X, method):
        est = self._est
        if _is_device_estimator(est):
            return self._pin_meta(getattr(est, method)(X), method)
        fn = getattr(est, method)
        parts = [fn(b) for b in _host_blocks(X)]
        if any(sp.issparse(p) for p in parts):
            # a sparse output of a host estimator (a transformer) stays
            # sparse
            return self._pin_meta(sp.vstack(parts).tocsr(), method)
        return self._pin_meta(np.concatenate(parts, axis=0), method)

    def predict(self, X):
        return self._apply(X, "predict")

    def predict_proba(self, X):
        return self._apply(X, "predict_proba")

    def predict_log_proba(self, X):
        return self._apply(X, "predict_log_proba")

    def decision_function(self, X):
        return self._apply(X, "decision_function")

    def transform(self, X):
        return self._apply(X, "transform")

    def score(self, X, y, compute=True):
        if self.scoring:
            from .metrics.scorer import get_scorer

            return get_scorer(self.scoring)(self, X, y)
        pred = self.predict(X)
        if hasattr(self._est, "classes_") or \
                hasattr(self._est, "predict_proba"):
            return accuracy_score(_host(y), pred)
        return r2_score(_host(y), pred)


class Incremental(ParallelPostFit):
    """Ref: dask_ml/wrappers.py::Incremental + dask_ml/_partial.py::fit."""

    def __init__(self, estimator=None, scoring=None, shuffle_blocks=True,
                 random_state=None, assume_equal_chunks=True,
                 predict_meta=None, predict_proba_meta=None,
                 transform_meta=None):
        self.estimator = estimator
        self.scoring = scoring
        self.shuffle_blocks = shuffle_blocks
        self.random_state = random_state
        self.assume_equal_chunks = assume_equal_chunks
        self.predict_meta = predict_meta
        self.predict_proba_meta = predict_proba_meta
        self.transform_meta = transform_meta

    def _partial_fit_pass(self, est, X, y, block_size, rng, **fit_kwargs):
        fused = _is_device_estimator(est) and y is not None \
            and set(fit_kwargs) <= {"classes"}
        if fused and _on_device(X) and hasattr(est, "_fused_epoch"):
            # device data: the grid_partition blocks, views of X
            Xs = as_sharded(X, dtype=np.float32)
            B, _ = grid_partition(Xs.n_rows)
            order = list(range(B))
            if self.shuffle_blocks:
                rng.shuffle(order)
            return est._fused_epoch(Xs, y, order, n_blocks=B,
                                    classes=fit_kwargs.get("classes"))
        if _on_device(X):
            Xh = to_host(X)
        elif _is_sparse_source(X):
            # a port SGD estimator streams it; partial_fit takes CSR rows
            Xh = X if fused and hasattr(est, "_stream_pass") \
                else as_row_indexable(X)
        else:
            Xh = np.asanyarray(X)
        yh = _host(y)
        starts = list(range(0, Xh.shape[0], block_size))
        order = np.arange(len(starts))
        if self.shuffle_blocks:
            rng.shuffle(order)
        if fused and hasattr(est, "_stream_pass"):
            est._stream_pass(Xh, yh, block_size, order=order,
                             classes=fit_kwargs.get("classes"))
            return est
        for oi in order:
            s = starts[int(oi)]
            if yh is None:
                est.partial_fit(Xh[s:s + block_size], **fit_kwargs)
            else:
                est.partial_fit(Xh[s:s + block_size], yh[s:s + block_size],
                                **fit_kwargs)
        return est

    def fit(self, X, y=None, **fit_kwargs):
        est = clone(self.estimator)
        if not hasattr(est, "partial_fit"):
            raise ValueError(
                f"{type(est).__name__} has no partial_fit; Incremental "
                "requires a partial_fit-capable estimator"
            )
        # y is concrete here: infer the classes when they are not given
        if y is not None and "classes" not in fit_kwargs \
                and _is_classifier(est):
            if isinstance(y, ShardedArray):
                fit_kwargs["classes"] = torch.unique(
                    y.data[:y.n_rows]).cpu().numpy()
            elif isinstance(y, torch.Tensor):
                fit_kwargs["classes"] = torch.unique(y).cpu().numpy()
            else:
                fit_kwargs["classes"] = np.unique(np.asarray(y))
        rng = np.random.RandomState(self.random_state)
        self.estimator_ = self._partial_fit_pass(
            est, X, y, self._block_size(X), rng, **fit_kwargs)
        return self

    def partial_fit(self, X, y=None, **fit_kwargs):
        est = getattr(self, "estimator_", None)
        if est is None:
            est = clone(self.estimator)
        rng = np.random.RandomState(self.random_state)
        self.estimator_ = self._partial_fit_pass(
            est, X, y, self._block_size(X), rng, **fit_kwargs)
        return self

    def resume_from_checkpoint(self, X, y=None, **fit_kwargs):
        raise NotImplementedError(
            "Incremental pass checkpoints are not ported yet: ROADMAP.md "
            "queue 1, Checkpoints and reliability "
            "(reliability/stream_ckpt.py)")

    @staticmethod
    def _block_size(X):
        """The grid_partition height, capped for a memmap: the blocks of
        both branches of the pass."""
        return fit_block_rows(X if _on_device(X) or _is_sparse_source(X)
                              else np.asanyarray(X))


def compiled_batch_fn(*args, **kwargs):
    raise NotImplementedError(
        "compiled_batch_fn is not ported yet: ROADMAP.md queue 1, "
        "Execution and serving (plans/ and serving/)")
