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

The serving entry points: :func:`compiled_batch_fn` turns a fitted
estimator's method into a :class:`CompiledBatchFn`, one program over a
swappable parameter set that captures a CUDA graph per batch height
(``plans/plan.py``), and :func:`sparse_batch_fn` its CSR-in twin
(:class:`SparseBatchFn`) for linear models, bucketed by (rows, nnz).
"""

from __future__ import annotations

import threading

import numpy as np
import scipy.sparse as sp
import torch

from .base import BaseEstimator, clone, to_host
from .metrics import accuracy_score, r2_score
from .parallel.sharded import ShardedArray, as_sharded
from .parallel.streaming import (_is_sparse_source, as_row_indexable,
                                 fit_block_rows, grid_partition)

__all__ = ["ParallelPostFit", "Incremental", "CompiledBatchFn",
           "compiled_batch_fn", "ParamSwapError", "SparseBatchFn",
           "sparse_batch_fn"]

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
        from .parallel.frames import PartitionedFrame, is_partitioned

        if is_partitioned(X):
            # the reference's dd path: the method on every partition
            # through the frame's thread pool; frames stay frames
            parts = X.map_partitions(getattr(est, method))
            if isinstance(parts, PartitionedFrame):
                return parts
            return self._pin_meta(np.concatenate(
                [to_host(p) if not sp.issparse(p) else p.toarray()
                 for p in parts], axis=0), method)
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




# --------------------------------------------------------------------------
# Serving entry points: one program per (estimator family, method, flavour)
# over a swappable parameter set, a CUDA graph per batch height
# --------------------------------------------------------------------------

class ParamSwapError(ValueError):
    """A hot-swap was structurally impossible: the new estimator's
    fitted parameters do not match the entry point's shapes, family or
    method semantics. The caller must rebuild the entry point (capturing
    fresh graphs) instead of swapping."""


class CompiledBatchFn:
    """A fitted estimator's ``method`` as ONE static-shape batch
    function: ``fn(X)`` takes a float32 (B, d) block (an array, or the
    server's pinned staging tensor) and returns a host ndarray with one
    output row per input row.

    For this package's estimators the core is one plan-built program of
    ``(params, X)`` (``plans/plan.py``) whose parameters sit in the static
    buffers of the entry point's :class:`~dask_ml_tpu_torch.plans.GraphSet`
    on ``device``: on the card each batch height B captures one CUDA
    graph, replayed for every later batch of that height. That is the
    hot-swap contract the serving fleet rides: :meth:`swap_params` writes
    new parameters of the same shapes into those buffers between two
    batches, so a swap captures nothing new, and callers drawing B from a
    fixed bucket ladder capture a fixed, pre-warmable set of graphs and
    nothing after. ``jitted=False`` marks the host fallback (estimators
    of other packages): still batchable and swappable, nothing captured.
    """

    __slots__ = ("method", "jitted", "n_features", "donates", "version",
                 "quantize", "_fn", "_graphs", "_state", "_extract",
                 "_sig", "_inner", "_lock")

    def __init__(self, fn, method, jitted, n_features, params=None,
                 post=None, extract=None, sig=None, device=None,
                 prefix=None, inner=None, quantize=None):
        self._fn = fn
        # leaf flavour: the parameters and ``post`` live in the graph
        # set, swapped together under its lock
        self._graphs = fn.graphs(params, device, state=post) \
            if params is not None else None
        # pipeline flavour: the live (prefix, inner) pair, read and
        # swapped under ``_lock``, so old transforms never feed new
        # weights
        self._state = (tuple(prefix), inner) if inner is not None \
            else None
        self._lock = threading.Lock()
        self._extract = extract
        self._sig = sig
        self._inner = inner
        self.method = method
        self.jitted = jitted
        self.n_features = n_features
        # a graph reads its batch from a static buffer: nothing is donated
        self.donates = False
        self.version = 0
        # the precision flavour this entry point was built as ("int8" or
        # None = float32); swaps re-extract through the same flavour
        self.quantize = quantize

    @property
    def graphs(self):
        """The entry point's graph set (None for a pipeline or the host
        fallback)."""
        return self._graphs

    def __call__(self, X, copied=None):
        """The method on the batch ``X``; ``copied`` (a CUDA event) is
        recorded once the batch's copy to the card is issued."""
        if self._inner is not None:
            # pipeline: host prefix transforms feed the final step
            with self._lock:
                prefix, inner = self._state
                X = _host_batch(X)
                for t in prefix:
                    X = _host_out(t.transform(X))
                return inner(np.asarray(X, np.float32))
        if self._graphs is None:
            return _host_out(self._fn(_host_batch(X)))
        out, post = self._graphs.run((X,), copied=copied)
        return post(out) if post is not None else out

    def swap_params(self, estimator):
        """Replace the fitted parameters under the entry point with
        ``estimator``'s: :meth:`prepare_swap` then :meth:`commit_swap`.
        Raises :class:`ParamSwapError` on any structural mismatch. In-flight
        batches finish on the old parameters; batches run after the swap
        see the new ones."""
        return self.commit_swap(self.prepare_swap(estimator))

    def prepare_swap(self, estimator):
        """Validate ``estimator`` against this entry point WITHOUT
        touching any live state; returns an opaque token for
        :meth:`commit_swap`. Raises :class:`ParamSwapError` on any
        structural mismatch, leaving the entry point exactly as it was."""
        if self._inner is not None:
            if not (hasattr(estimator, "steps")
                    and hasattr(estimator, "named_steps")):
                raise ParamSwapError(
                    "entry point serves a pipeline; the swapped-in "
                    f"estimator {type(estimator).__name__} is not one")
            prefix, inner = self._state
            if len(estimator.steps) != len(prefix) + 1:
                raise ParamSwapError(
                    f"pipeline step count changed: "
                    f"{len(prefix) + 1} -> {len(estimator.steps)}")
            # the inner leaf sees only the prefix's output width; the
            # pipeline's own input width must match too
            want = getattr(estimator, "n_features_in_", None)
            if want is None:
                want = getattr(estimator.steps[0][1], "n_features_in_",
                               None)
            if (self.n_features is not None and want is not None
                    and int(want) != self.n_features):
                raise ParamSwapError(
                    f"n_features changed: {self.n_features} -> {want}")
            inner_tok = inner.prepare_swap(estimator.steps[-1][1])
            return ("pipe", tuple(t for _, t in estimator.steps[:-1]),
                    inner_tok)
        if self._extract is None:
            # host fallback: rebind the bound method, keep the width
            target = getattr(estimator, self.method, None)
            if target is None:
                raise ParamSwapError(
                    f"{type(estimator).__name__} has no method "
                    f"{self.method!r}")
            want = getattr(estimator, "n_features_in_", None)
            if (self.n_features is not None and want is not None
                    and want != self.n_features):
                raise ParamSwapError(
                    f"n_features changed: {self.n_features} -> {want}")
            return ("host", target)
        try:
            built = self._extract(estimator)
        except AttributeError as exc:
            # build-time guards (predict_proba on a hinge loss) refuse
            # the swap typed
            raise ParamSwapError(str(exc)) from exc
        if built is None:
            raise ParamSwapError(
                f"{type(estimator).__name__} does not support "
                f"{self.method!r} on the compiled path")
        params, post, sig = built
        if sig != self._sig:
            raise ParamSwapError(
                "compiled structure mismatch (shapes/family/method "
                f"semantics): built with {self._sig}, swap offers {sig}")
        return ("leaf", params, post)

    def commit_swap(self, token):
        """Apply a :meth:`prepare_swap` token between two batches: a
        leaf's parameters and ``post`` are written under its graph set's
        lock, a pipeline's (prefix, inner) pair under its own, so a call
        sees either the complete old state or the complete new one."""
        kind = token[0]
        if kind == "pipe":
            _, prefix, inner_tok = token
            with self._lock:
                _, inner = self._state
                inner.commit_swap(inner_tok)
                self._state = (prefix, inner)
        elif kind == "host":
            target = token[1]
            self._fn = lambda X: target(X)
        else:
            _, params, post = token
            self._graphs.swap(params, post)
        self.version += 1
        return self


def _host_batch(X):
    """A batch as a host array for host-side code (a pinned staging
    tensor shares its memory)."""
    return X.numpy() if isinstance(X, torch.Tensor) else X


def _host_out(out):
    if isinstance(out, ShardedArray):
        return to_host(out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if sp.issparse(out):
        return out.toarray()
    return np.asarray(out)


def _serving_program(est, method, core, flavor=None, sig=None):
    """The plan-built program of a serving core, named
    ``serving.<Estimator>.<method>[.<flavor>]``; ``sig`` (the swap
    signature) is the plan cache key, so two builds over same-shaped
    parameters share one program."""
    from .plans import ProgramPlan

    name = f"serving.{type(est).__name__}.{method}"
    if flavor:
        name += f".{flavor}"
    return ProgramPlan(
        name=name, body=core,
        key=("serving", sig) if sig is not None else None,
        ladder="serving-rows", group="serving",
    ).build()


def _shapes(params):
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in params.items()))


def _linear_wb(est):
    """(C, d) weight matrix and (C,) bias of a fitted linear model (C = 1
    encodes the binary or regression row)."""
    coef = np.asarray(est.coef_, np.float32)
    if coef.ndim == 1:
        coef = coef[None, :]
    b = np.ravel(np.asarray(getattr(est, "intercept_", 0.0), np.float32))
    if b.shape[0] != coef.shape[0]:
        b = np.full(coef.shape[0], b[0] if b.size else 0.0, np.float32)
    return coef, b


def _class_post(classes):
    cls = np.asarray(classes)
    return lambda idx: cls[np.asarray(idx)]


def _linear_extract(est, method):
    """(host params, post, signature) of a linear-family estimator: what
    the program's structure depends on (method semantics,
    multiclass-ness, link family, parameter shapes) lands in the
    signature; what may change per version (weights, bias, class labels)
    in params and post."""
    W, b = _linear_wb(est)
    multi = W.shape[0] > 1
    classes = getattr(est, "classes_", None)
    family = getattr(est, "family", None)
    if method == "decision_function":
        kind = "margin"
    elif method == "predict_proba":
        if classes is None:
            return None
        # sigmoid(margins) of a non-log loss is not a probability
        loss = getattr(est, "_loss", None)
        if callable(loss) and loss() != "log_loss":
            raise AttributeError("predict_proba requires loss='log_loss'")
        kind = "proba"
    elif method == "predict":
        if classes is not None:
            kind = "classify"
        elif family == "poisson":
            kind = "poisson"
        else:
            kind = "regress"
    else:
        return None
    post = _class_post(classes) if kind == "classify" else None
    params = {"W": W, "b": b}
    return params, post, ("linear", kind, multi, _shapes(params))


def _quantize_w(W):
    """Per-output-channel symmetric int8 quantization of a (C, d) weight
    matrix: ``scale[c] = max|W[c]| / 127`` (1.0 for an all-zero row)."""
    amax = np.max(np.abs(W), axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    Wq = np.clip(np.rint(W / scale[:, None]), -127, 127).astype(np.int8)
    return Wq, scale


def _linear_extract_int8(est, method):
    """The int8 twin of ``_linear_extract``: weights quantized per output
    channel at extract (publish) time, scales and bias f32. ``proba``
    and ``poisson`` pass eta through a nonlinearity and stay on the f32
    flavour (None). The signature leads with "linear-int8", so an f32
    entry point never accepts quantized params, nor the reverse."""
    built = _linear_extract(est, method)
    if built is None:
        return None
    params, post, sig = built
    if sig[1] in ("proba", "poisson"):
        return None
    Wq, scale = _quantize_w(params["W"])
    qparams = {"Wq": Wq, "scale": scale, "b": params["b"]}
    return qparams, post, ("linear-int8", sig[1], sig[2],
                           _shapes(qparams))


def _linear_core(kind, multi, eta=None):
    if eta is None:
        def eta(p, X):
            return X @ p["W"].T + p["b"][None, :]            # (B, C)

    if kind == "margin":
        return (lambda p, X: eta(p, X)) if multi \
            else (lambda p, X: eta(p, X)[:, 0])
    if kind == "proba":
        if multi:
            def core(p, X):
                pr = torch.sigmoid(eta(p, X))   # OvR sigmoids, normed
                return pr / torch.clamp_min(pr.sum(1, keepdim=True),
                                            1e-12)
        else:
            def core(p, X):
                p1 = torch.sigmoid(eta(p, X)[:, 0])
                return torch.stack([1.0 - p1, p1], dim=1)
        return core
    if kind == "classify":
        if multi:
            return lambda p, X: torch.argmax(eta(p, X), dim=1)
        return lambda p, X: (eta(p, X)[:, 0] > 0).to(torch.int32)
    if kind == "poisson":
        return lambda p, X: torch.exp(eta(p, X)[:, 0])
    return lambda p, X: eta(p, X)[:, 0]                       # regression


def _linear_core_int8(kind, multi):
    """Serving core over int8 weights: X rounded to bf16 times the int8
    W, accumulated in f32, the per-channel scales and the bias applied
    to the (B, C) result. W stays int8 on the card (4x smaller); each
    product of a bf16 and an int8 value is exact in f32, so the product
    is the JAX core's mixed bf16 x int8 dot with f32 accumulation."""

    def eta(p, X):
        acc = X.to(torch.bfloat16).float() @ p["Wq"].float().T
        return acc * p["scale"][None, :] + p["b"][None, :]

    return _linear_core(kind, multi, eta=eta)


def _jit_linear(est, method, device, quantize=None):
    """The linear family (GLM and SGD): one product and a pointwise
    tail over the swappable parameters. ``quantize="int8"`` builds the
    weight-quantized flavour for the methods that take it; the others
    fall back to the f32 build."""
    if quantize == "int8":
        built = _linear_extract_int8(est, method)
        if built is not None:
            params, post, sig = built
            return CompiledBatchFn(
                _serving_program(est, method,
                                 _linear_core_int8(sig[1], sig[2]),
                                 flavor="int8", sig=sig),
                method, True, params["Wq"].shape[1], params=params,
                post=post, extract=lambda e: _linear_extract_int8(e, method),
                sig=sig, device=device, quantize="int8")
    elif quantize:
        raise ValueError(
            f"unknown quantize flavor {quantize!r}; supported: 'int8'")
    built = _linear_extract(est, method)
    if built is None:
        return None
    params, post, sig = built
    return CompiledBatchFn(
        _serving_program(est, method, _linear_core(sig[1], sig[2]),
                         sig=sig),
        method, True, params["W"].shape[1], params=params, post=post,
        extract=lambda e: _linear_extract(e, method), sig=sig,
        device=device)


def _sparse_linear_extract(est, method):
    """The sparse twin of ``_linear_extract`` (predict and
    decision_function), under a "linear-sparse" signature."""
    if method not in ("predict", "decision_function"):
        return None
    built = _linear_extract(est, method)
    if built is None:
        return None
    params, post, sig = built
    return params, post, ("linear-sparse",) + tuple(sig[1:])


def _sparse_linear_core(kind, multi):
    """Serving core over a packed CSR batch: eta from one gather of the C
    weights of each nonzero's column and an ordered segment sum over the
    rows (``ops/sparse_kernels.py``), nnz * C work instead of B * d * C.
    ``n_rows`` (the row bucket) is static: one graph per (rows, nnz)."""
    from .ops.sparse_kernels import sparse_eta_multi

    def eta(p, data, cols, rows, n_rows):
        return sparse_eta_multi(data, cols, rows, p["W"], n_rows) \
            + p["b"][None, :]

    if kind == "margin":
        if multi:
            return eta
        return lambda p, d_, c_, r_, n: eta(p, d_, c_, r_, n)[:, 0]
    if kind == "classify":
        if multi:
            return lambda p, d_, c_, r_, n: torch.argmax(
                eta(p, d_, c_, r_, n), dim=1)
        return lambda p, d_, c_, r_, n: (
            eta(p, d_, c_, r_, n)[:, 0] > 0).to(torch.int32)
    if kind == "poisson":
        return lambda p, d_, c_, r_, n: torch.exp(
            eta(p, d_, c_, r_, n)[:, 0])
    return lambda p, d_, c_, r_, n: eta(p, d_, c_, r_, n)[:, 0]


class SparseBatchFn(CompiledBatchFn):
    """A fitted linear estimator's ``method`` as a static-shape SPARSE
    batch function: ``fn(csr)`` packs a scipy CSR block to the
    (row-bucket, nnz-bucket) grid, rows padded up the serving ladder and
    the nonzeros up the geometric nnz ladder
    (``config.serving_sparse_nnz_per_row`` times the batch ladder's
    min and max, same growth), and runs one graph per grid cell. The
    packed CSR capacity is the nnz rung; padding entries carry zero
    values on the bucket's last row, so the rows stay ascending for the
    ordered segment sums. Hot-swap is inherited."""

    __slots__ = ("nnz_ladder",)

    def __init__(self, fn, method, n_features, params=None, post=None,
                 extract=None, sig=None, device=None, nnz_ladder=None):
        super().__init__(fn, method, True, n_features, params=params,
                         post=post, extract=extract, sig=sig,
                         device=device)
        self.nnz_ladder = nnz_ladder

    def nnz_bucket(self, nnz: int) -> int:
        return self.nnz_ladder.bucket_for(max(int(nnz), 1))

    def _pack(self, X, n_rows):
        X = X.tocsr() if not sp.isspmatrix_csr(X) else X
        n = int(X.shape[0])
        nnz = int(X.nnz)
        nb = self.nnz_bucket(nnz)
        data = np.zeros(nb, np.float32)
        cols = np.zeros(nb, np.int32)
        rows = np.full(nb, max(int(n_rows), 1) - 1, np.int32)
        data[:nnz] = X.data
        cols[:nnz] = X.indices
        rows[:nnz] = np.repeat(np.arange(n, dtype=np.int32),
                               np.diff(X.indptr))
        return data, cols, rows, n

    def __call__(self, X, n_rows=None):
        """Run the packed batch; ``n_rows`` pins the row bucket (the
        server picks it from the ladder), default the batch's own rows.
        Returns the real rows only."""
        n_rows = int(n_rows if n_rows is not None else X.shape[0])
        data, cols, rows, n = self._pack(X, n_rows)
        out, post = self._graphs.run((data, cols, rows), static=(n_rows,))
        out = out[:n]
        return post(out) if post is not None else out

    def warm(self, row_bucket: int, nnz_bucket: int):
        """Capture one (rows, nnz) grid cell now."""
        self._graphs.run((np.zeros(nnz_bucket, np.float32),
                          np.zeros(nnz_bucket, np.int32),
                          np.zeros(nnz_bucket, np.int32)),
                         static=(int(row_bucket),))
        return self


def sparse_batch_fn(estimator, method="predict", device=None):
    """The sparse (CSR-in) serving entry point of a fitted LINEAR
    estimator's predict or decision_function, bucketed by (rows, nnz).
    None for estimators and methods without a sparse path (pipelines,
    KMeans, PCA, predict_proba)."""
    est = estimator
    if not (_is_device_estimator(est) and hasattr(est, "coef_")):
        return None
    built = _sparse_linear_extract(est, method)
    if built is None:
        return None
    params, post, sig = built
    from .config import get_config, resolve_device
    from .plans import ProgramPlan
    from .serving._buckets import BucketLadder

    cfg = get_config()
    npr = max(int(cfg.serving_sparse_nnz_per_row), 1)
    nnz_ladder = BucketLadder(
        min_rows=max(cfg.serving_min_batch * npr, 1),
        max_rows=max(cfg.serving_max_batch * npr,
                     cfg.serving_min_batch * npr, 1),
        growth=cfg.serving_bucket_growth)
    fn = ProgramPlan(
        name=f"serving.{type(est).__name__}.{method}.sparse",
        body=_sparse_linear_core(sig[1], sig[2]), static_argnums=(4,),
        key=("serving-sparse", sig), ladder="serving-nnz",
        group="serving").build()
    return SparseBatchFn(
        fn, method, params["W"].shape[1], params=params, post=post,
        extract=lambda e: _sparse_linear_extract(e, method), sig=sig,
        device=resolve_device(device), nnz_ladder=nnz_ladder)


def _kmeans_extract(est, method):
    if method not in ("predict", "transform"):
        return None
    params = {"centers": np.asarray(est.cluster_centers_, np.float32)}
    return params, None, ("kmeans", method, _shapes(params))


def _kmeans_core(method):
    def dist2(p, X):
        # ||x - c||^2 expanded: one (B, d) x (d, k) product, clamped at 0
        c = p["centers"]
        xx = (X * X).sum(1, keepdim=True)
        cc = (c * c).sum(1)[None, :]
        return torch.clamp_min(xx + cc - 2.0 * (X @ c.T), 0.0)

    if method == "predict":
        # argmin takes the first of equal minima
        return lambda p, X: torch.argmin(dist2(p, X), dim=1).to(
            torch.int32)
    return lambda p, X: torch.sqrt(dist2(p, X))


def _pca_extract(est, method):
    if method != "transform":
        return None
    params = {"components": np.asarray(est.components_, np.float32)}
    mean = getattr(est, "mean_", None)
    if mean is not None:
        params["mean"] = np.asarray(mean, np.float32)
    if getattr(est, "whiten", False):
        params["scale"] = np.sqrt(np.asarray(est.explained_variance_,
                                             np.float32))
    # which optional terms exist is structural: it rides the signature
    return params, None, ("pca", _shapes(params))


def _pca_core(has_mean, has_scale):
    def core(p, X):
        xc = X - p["mean"][None, :] if has_mean else X
        sc = xc @ p["components"].T
        return sc / p["scale"][None, :] if has_scale else sc

    return core


def _nb_extract(est, method):
    """(host params, post, signature) of a fitted GaussianNB: the joint
    log-likelihood over a swappable {theta, var, log_prior}."""
    if method not in ("predict", "predict_proba"):
        return None
    params = {"theta": np.asarray(est.theta_, np.float32),
              "var": np.asarray(est.var_, np.float32),
              "log_prior": np.log(np.asarray(est.class_prior_, np.float64))
              .astype(np.float32)}
    kind = "classify" if method == "predict" else "proba"
    post = _class_post(est.classes_) if kind == "classify" else None
    return params, post, ("nb", kind, _shapes(params))


def _nb_core(kind):
    from .naive_bayes import _jll_math

    def jll(p, X):
        # the one jll definition, so served and direct predictions agree
        return _jll_math(X, p["theta"], p["var"], p["log_prior"])

    if kind == "classify":
        return lambda p, X: torch.argmax(jll(p, X), dim=1).to(torch.int32)
    return lambda p, X: torch.softmax(jll(p, X), dim=1)


def _jit_family(est, method, device, extract, core_of, width_key):
    built = extract(est, method)
    if built is None:
        return None
    params, post, sig = built
    return CompiledBatchFn(
        _serving_program(est, method, core_of(params, sig), sig=sig), method,
        True, int(params[width_key].shape[1]), params=params, post=post,
        extract=lambda e: extract(e, method), sig=sig, device=device)


def compiled_batch_fn(estimator, method="predict", device=None,
                      quantize=None):
    """Build the static-shape batch entry point of a fitted estimator
    (or a pipeline ending in one): the serving subsystem's unit of
    capture.

    This package's estimators (GLM, SGD, KMeans, PCA/TruncatedSVD,
    GaussianNB) become one program of ``(params, X)`` whose parameters
    are swappable (:meth:`CompiledBatchFn.swap_params`), placed on
    ``device`` (default ``config.device``; a fleet passes each replica's).
    A pipeline applies its prefix transforms per batch and feeds the
    final step's entry point. Anything else gets the host fallback,
    ``getattr(est, method)`` over the padded batch.

    ``quantize="int8"`` builds the weight-quantized flavour of linear
    predict and decision_function; methods and families without an int8
    path build their f32 flavour (``.quantize`` on the result says which
    one you got).
    """
    est = estimator
    if hasattr(est, "steps") and hasattr(est, "named_steps"):
        inner = compiled_batch_fn(est.steps[-1][1], method, device=device)
        first = est.steps[0][1]
        return CompiledBatchFn(
            None, method, inner.jitted,
            getattr(first, "n_features_in_", None),
            prefix=tuple(t for _, t in est.steps[:-1]), inner=inner)
    if _is_device_estimator(est):
        from .config import resolve_device

        built = None
        if hasattr(est, "coef_"):
            built = _jit_linear(est, method, resolve_device(device),
                                quantize=quantize)
        elif hasattr(est, "cluster_centers_"):
            built = _jit_family(
                est, method, resolve_device(device), _kmeans_extract,
                lambda p, sig: _kmeans_core(method), "centers")
        elif hasattr(est, "components_"):
            built = _jit_family(
                est, method, resolve_device(device), _pca_extract,
                lambda p, sig: _pca_core("mean" in p, "scale" in p),
                "components")
        elif hasattr(est, "theta_"):
            built = _jit_family(
                est, method, resolve_device(device), _nb_extract,
                lambda p, sig: _nb_core(sig[1]), "theta")
        if built is not None:
            return built
    target = getattr(est, method, None)
    if target is None:
        raise AttributeError(
            f"{type(est).__name__} has no method {method!r}")
    return CompiledBatchFn(lambda X: target(X), method, False,
                           getattr(est, "n_features_in_", None))
