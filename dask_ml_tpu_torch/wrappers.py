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

Pass checkpoints (``config.stream_checkpoint_path``): every
``partial_fit`` pass of a port SGD estimator over host data saves the
inner model's weights, lr clock ``_t``, classes and the completed pass
count under a fingerprint token (kind ``"incremental"``); a fresh
wrapper's first ``partial_fit`` (or ``resume_from_checkpoint``) restores
a matching checkpoint and exposes ``completed_passes_``, so a killed
pass loop skips the passes done. Device-resident X and other packages'
estimators take no checkpoint; ``fit`` (one fresh pass) clears a
matching one. ``training_profile_`` is the wrapped estimator's.

Not ported: the compiled serving entry point (``compiled_batch_fn``,
raising ``NotImplementedError`` that names ROADMAP.md queue 1, Execution
and serving).
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

    @property
    def training_profile_(self):
        """The wrapped estimator's per-feature training profile;
        AttributeError when its fit recorded none."""
        prof = getattr(self._est, "training_profile_", None)
        if prof is None:
            raise AttributeError("training_profile_")
        return prof

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
        # a fresh fit() never resumes a stale pass sequence
        ckpt = self._pass_checkpoint(est, X, y, fit_kwargs)
        if ckpt is not None:
            ckpt.clear()
        rng = np.random.RandomState(self.random_state)
        self.estimator_ = self._partial_fit_pass(
            est, X, y, self._block_size(X), rng, **fit_kwargs)
        return self

    def partial_fit(self, X, y=None, **fit_kwargs):
        if getattr(self, "estimator_", None) is None:
            # a fresh wrapper: a matching checkpoint restores the killed
            # loop's inner model before this pass
            self.resume_from_checkpoint(X, y, **fit_kwargs)
        est = getattr(self, "estimator_", None)
        if est is None:
            est = clone(self.estimator)
        ckpt = self._pass_checkpoint(est, X, y, fit_kwargs)
        rng = np.random.RandomState(self.random_state)
        self.estimator_ = self._partial_fit_pass(
            est, X, y, self._block_size(X), rng, **fit_kwargs)
        if ckpt is not None:
            self.completed_passes_ = getattr(self, "completed_passes_", 0) + 1
            if ckpt.due(self.completed_passes_):
                inner = self.estimator_
                classes = getattr(inner, "classes_", None)
                w = to_host(inner._w)
                ckpt.save(w=w, t=int(inner._t), d=int(w.shape[-1]) - 1,
                          passes=self.completed_passes_,
                          classes=None if classes is None
                          else np.asarray(classes))
        return self

    # -- pass checkpoints ----------------------------------------------------
    def _pass_checkpoint(self, est, X, y, fit_kwargs):
        """The pass checkpoint slot of this wrapper's pass sequence, or
        None: checkpoints off, device-resident X, no y, an estimator
        without the SGD weights and clock, or classes that are not
        numbers (the checkpoint holds numeric arrays only)."""
        from .config import get_config
        from .reliability.stream_ckpt import stream_checkpoint

        if not get_config().stream_checkpoint_path:
            return None
        if not (_is_device_estimator(est) and hasattr(est, "_stream_pass")
                and hasattr(est, "_loss")):
            return None
        if _on_device(X) or y is None:
            return None
        classes = fit_kwargs.get("classes", getattr(est, "classes_", None))
        if classes is not None:
            classes = np.asarray(classes)
            if classes.dtype.kind not in "fiub":
                return None
        Xh, yh = _host_matrix(X), np.asarray(to_host(y))
        parts = ("incremental", type(est).__name__,
                 repr(sorted(est.get_params().items())),
                 self.shuffle_blocks, self.random_state,
                 None if classes is None else tuple(classes.tolist()),
                 tuple(Xh.shape))
        ckpt = stream_checkpoint("incremental", parts, arrays=(Xh, yh))
        self._pass_ckpt_ = ckpt
        return ckpt

    def _clear_pass_checkpoint(self):
        """Completion hook of a pass loop: the sequence is done, its
        checkpoint must not resume into a later one."""
        ckpt = getattr(self, "_pass_ckpt_", None)
        if ckpt is not None:
            ckpt.clear()

    def resume_from_checkpoint(self, X, y=None, **fit_kwargs):
        """Restore a matching pass checkpoint into this fresh wrapper
        without training, so a pass loop killed after its last pass
        resumes to no remaining work. Returns the completed pass count
        (0 when nothing was restored or checkpoints are off)."""
        from .config import get_config, resolve_device
        from .reliability.stream_ckpt import restore_counted

        if not get_config().stream_checkpoint_path:
            return 0
        if getattr(self, "estimator_", None) is not None:
            return int(getattr(self, "completed_passes_", 0))
        est = clone(self.estimator)
        st = restore_counted(self._pass_checkpoint(est, X, y, fit_kwargs))
        if st is None:
            return 0
        if "classes" in st:
            est._set_classes(np.asarray(st["classes"]))
        est._ensure_state(int(st["d"]), resolve_device())
        est._w = torch.as_tensor(st["w"], dtype=torch.float32,
                                 device=resolve_device())
        est._t = int(st["t"])
        est._publish(int(st["d"]))
        self.estimator_ = est
        self.completed_passes_ = int(st["passes"])
        return self.completed_passes_

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
