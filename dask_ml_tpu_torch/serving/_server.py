"""ModelServer: online inference over a fitted estimator.

Counterpart of ``dask_ml_tpu/serving/_server.py``: many small,
concurrently arriving requests of ragged sizes are admitted into a
bounded queue, coalesced by a micro-batcher into padded batches drawn
from a geometric ladder of shape buckets (``_buckets``), run through one
entry point per method (``wrappers.compiled_batch_fn``: parameters on
the card, a CUDA graph replayed per bucket, the batch copied in from
pinned ping-pong staging and the output read back through a pinned
buffer), and demultiplexed back to the callers with padding rows masked
out.

Around the hot loop:

- admission control: ``submit`` never blocks; a full queue sheds with
  :class:`ServerOverloaded`, and requests whose deadline lapses while
  queued resolve with :class:`RequestTimeout`;
- ``warmup()`` captures every (method, bucket) graph up front, so a
  warmed server answers ragged ladder traffic with ZERO new captures
  (the ``graph_captures`` counter);
- graceful drain: ``stop()`` stops admissions, finishes every queued
  request and joins the worker;
- telemetry: per-batch ``serving.batch`` spans and the serving counters
  (``serving/metrics.py``).

The JAX server's quality capture (the served-row sketch fold, the shadow
rows and the hot-swap canary's drift record) and its request traces wait
for ROADMAP.md queue 1, Observability, part 2: this server folds no
served rows, whatever ``config.obs_drift`` says.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..wrappers import ParamSwapError, compiled_batch_fn, sparse_batch_fn
from . import metrics as smetrics
from ._batching import (
    BoundedQueue,
    PingPongStaging,
    Request,
    demux_outputs,
    fail_requests,
    pack_batch,
    release_deadline,
)
from ._buckets import BucketLadder
from .policy import ExecStats

__all__ = ["ModelServer", "ServingError", "ServerOverloaded",
           "RequestTimeout", "ServerClosed", "SloShed"]


class ServingError(RuntimeError):
    """Base class for typed serving failures."""


class ServerOverloaded(ServingError):
    """Admission control shed this request: the bounded queue is full.
    Retry with backoff, widen ``max_queue``, or add replicas."""


class SloShed(ServerOverloaded):
    """SLO-aware admission shed this request: every candidate replica's
    predicted completion would miss ``config.serving_slo_ms``."""


class RequestTimeout(ServingError, TimeoutError):
    """The request's deadline passed while it waited in the queue."""


class ServerClosed(ServingError):
    """submit() after stop() or while draining."""


def _sparse_fns(estimator, methods, device):
    """The sparse (CSR-in) entry points of the served methods that have
    one."""
    out = {}
    for m in methods:
        try:
            sfn = sparse_batch_fn(estimator, m, device=device)
        except Exception:
            sfn = None
        if sfn is not None:
            out[m] = sfn
    return out


def _innermost(fn):
    while getattr(fn, "_inner", None) is not None:
        fn = fn._inner
    return fn


class ModelServer:
    """Serve ``estimator``'s post-fit methods over micro-batched
    concurrent requests.

    Parameters
    ----------
    estimator : fitted estimator or pipeline ending in one
    methods : tuple of method names to serve (entry points are built
        eagerly: a typo fails at construction, not at the first request)
    ladder : BucketLadder, default from config
        (``serving_min_batch`` / ``serving_max_batch`` /
        ``serving_bucket_growth``)
    max_queue : int, queued-request bound for admission control
    batch_window_ms : float, coalescing wait after the first request
    timeout_ms : float, per-request queue deadline (0 = none)
    device : the card (or ``"cpu"``) of this server's parameters, graphs
        and stream; default ``config.device``

    Use as a context manager::

        with ModelServer(clf).warmup() as srv:
            fut = srv.submit(x)           # -> Future
            y = srv.predict(x)            # blocking convenience
    """

    def __init__(self, estimator, methods=("predict",), ladder=None,
                 max_queue=None, batch_window_ms=None, timeout_ms=None,
                 device=None, replica_id=None, name=None):
        from ..config import get_config, resolve_device

        cfg = get_config()
        # the config is thread-local: the worker re-enters the creator's
        self._cfg = cfg
        self.estimator = estimator
        self.ladder = ladder if ladder is not None \
            else BucketLadder.from_config()
        self.max_queue = int(cfg.serving_max_queue
                             if max_queue is None else max_queue)
        self.batch_window_s = float(
            cfg.serving_batch_window_ms
            if batch_window_ms is None else batch_window_ms) / 1e3
        self.timeout_s = float(
            cfg.serving_timeout_ms if timeout_ms is None else timeout_ms
        ) / 1e3
        # deadline-aware batch release, armed by an SLO
        self._slo_s = float(cfg.serving_slo_ms) / 1e3
        self.device = resolve_device(device)
        self.replica_id = replica_id
        self.model_version = 0          # stamped by swap/rebuild/fleet
        self.model_name = str(name) if name else type(estimator).__name__
        self._fns = {m: compiled_batch_fn(estimator, m, device=self.device)
                     for m in methods}
        self._sparse_fns = _sparse_fns(estimator, methods, self.device)
        # precision-flavour table: "" (float32) plus every flavour named
        # in config.serving_warm_flavors gets its own entry points, built
        # now and warmed by warmup(), so a publish flagged
        # quantize="int8" (and the rollback to f32) swaps with no capture
        self._flavor_fns = {"": self._fns}
        for fl in str(cfg.serving_warm_flavors).replace(",", " ").split():
            if fl in self._flavor_fns:
                continue
            self._flavor_fns[fl] = {
                m: compiled_batch_fn(estimator, m, device=self.device,
                                     quantize=fl)
                for m in methods}
        self._active_flavor = ""
        self._queue = BoundedQueue(self.max_queue)
        self._staging = PingPongStaging(pinned=self.device.type == "cuda")
        self._latency = smetrics.LatencyWindow()
        self._stats_cursor = None       # windowed-quantile cursor
        self._exec = ExecStats()        # per-(method, bucket) exec times
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self._accepting = False
        self._paused = threading.Event()
        self._paused.set()              # set = running, cleared = paused
        self._parked = threading.Event()  # the worker acknowledged a pause
        self._batches = 0
        self._warmed = False

    # -- lifecycle --------------------------------------------------------
    def start(self):
        from ..observability.live import ensure_telemetry, register_server

        register_server(self)
        # the long-running work the exporter exists for (one config read
        # when obs_http_port is 0)
        ensure_telemetry()
        with self._lock:
            if self._thread is not None:
                return self
            if self._queue.closed:   # restart after stop(): fresh queue
                self._queue = BoundedQueue(self.max_queue)
            self._stop.clear()
            self._accepting = True
            self._thread = threading.Thread(
                target=self._run, name="dask-ml-tpu-torch-serving",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop admissions; with ``drain`` (default) finish every queued
        request before joining the worker, else shed them with
        ServerClosed."""
        from ..observability.live import unregister_server

        unregister_server(self)
        with self._lock:
            self._accepting = False
            thread = self._thread
        # close under the queue's lock: every put that succeeded
        # happens-before this, so the worker's tail drain serves it
        self._queue.close()
        if thread is None:
            self._shed_queue(drain)
            return
        if not drain:
            fail_requests(self._queue.drain_all(), ServerClosed(
                "server stopped without drain"))
        self._paused.set()              # a paused server must still drain
        self._stop.set()
        self._queue.wake()
        thread.join(timeout)
        with self._lock:
            self._thread = None

    def _shed_queue(self, drain):
        reqs = self._queue.drain_all()
        if not reqs:
            return
        if drain:
            from .. import config

            with config.use(self._cfg):
                for r in reqs:
                    self._execute([r])
        else:
            fail_requests(reqs, ServerClosed("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    def pause(self):
        """Hold the worker between batches (requests keep queueing up to
        the admission bound). Blocks briefly until the worker
        acknowledges, so requests submitted after pause() stay queued."""
        self._parked.clear()
        self._paused.clear()
        if self._thread is not None:
            self._parked.wait(5.0)
        return self

    def resume(self):
        self._paused.set()
        return self

    @property
    def healthy(self) -> bool:
        """Accepting requests with a live (or not-yet-started) worker:
        the fleet's routing predicate."""
        if not self._accepting:
            return False
        thread = self._thread
        return thread is None or thread.is_alive()

    # -- hot-swap ----------------------------------------------------------
    def swap_model(self, estimator, version=None, quantize=None):
        """Hot-swap: write ``estimator``'s parameters into the SAME entry
        points (``CompiledBatchFn.prepare_swap``/``commit_swap``; a graph
        reads its parameters from static buffers, so a same-shape swap
        captures nothing). Raises
        :class:`~dask_ml_tpu_torch.wrappers.ParamSwapError` when the new
        version is structurally incompatible (use :meth:`rebuild_model`).
        In-flight batches finish on the old version; batches run after
        the return serve the new one.

        ``quantize`` selects the precision flavour of the new version
        ("int8" or None = float32); a flavour not named in
        ``config.serving_warm_flavors`` refuses with ParamSwapError."""
        flavor = quantize or ""
        fns = self._flavor_fns.get(flavor)
        if fns is None:
            raise ParamSwapError(
                f"serving flavor {flavor!r} was not pre-built on this "
                "server; add it to config.serving_warm_flavors (and "
                "re-warm) or install via rebuild_model")
        # validate every method before mutating any: a multi-method
        # server is never left half-swapped
        tokens = {}
        for m, fn in fns.items():
            try:
                tokens[m] = fn.prepare_swap(estimator)
            except ParamSwapError as exc:
                raise ParamSwapError(f"method {m!r}: {exc}") from exc
        sparse_tokens = {}
        for m, fn in self._sparse_fns.items():
            try:
                sparse_tokens[m] = fn.prepare_swap(estimator)
            except ParamSwapError as exc:
                raise ParamSwapError(f"sparse method {m!r}: {exc}") \
                    from exc
        for m, fn in fns.items():
            fn.commit_swap(tokens[m])
        for m, fn in self._sparse_fns.items():
            fn.commit_swap(sparse_tokens[m])
        # the flavour flip is one assignment: the worker reads
        # self._fns[method] per batch
        self._fns = fns
        self._active_flavor = flavor
        self.estimator = estimator
        self.model_version = int(version) if version is not None \
            else self.model_version + 1
        smetrics.record_swap()
        if self.replica_id is not None:
            smetrics.set_replica_gauges(self.replica_id,
                                        version=self.model_version)
        return self

    _KEEP_FLAVOR = object()  # "caller didn't say": keep current flavour

    def rebuild_model(self, estimator, version=None, warm=None,
                      quantize=_KEEP_FLAVOR):
        """The slow path a shape-incompatible publish needs: build fresh
        entry points for ``estimator``, capture their graphs off the
        serving path (``warm`` defaults to whether this server was
        warmed), then install them in one assignment. Every pre-built
        flavour rebuilds; ``quantize`` picks the one that serves after
        (None = float32; omitted keeps the current flavour)."""
        flavor = self._active_flavor \
            if quantize is ModelServer._KEEP_FLAVOR else (quantize or "")
        flavors = set(self._flavor_fns) | {flavor}
        table = {
            fl: {m: compiled_batch_fn(estimator, m, device=self.device,
                                      quantize=(fl or None))
                 for m in self._fns}
            for fl in flavors}
        if warm or (warm is None and self._warmed):
            for fns in table.values():
                self._warm_fns(fns)
        self._sparse_fns = _sparse_fns(estimator, self._fns, self.device)
        self._flavor_fns = table
        self._fns = table[flavor]
        self._active_flavor = flavor
        self.estimator = estimator
        self.model_version = int(version) if version is not None \
            else self.model_version + 1
        smetrics.record_swap(rebuilt=True)
        if self.replica_id is not None:
            smetrics.set_replica_gauges(self.replica_id,
                                        version=self.model_version)
        return self

    # -- warmup -----------------------------------------------------------
    def warmup(self):
        """Capture every (method, bucket) graph now, before traffic: one
        call per rung per method through the real entry point, for every
        pre-built flavour. After this, a workload whose batches stay on
        the ladder captures no new graph. Warming routes through the
        process-wide plans WarmupRegistry, keyed by each entry point's
        own graph set (a graph holds that entry point's buffers)."""
        for fns in self._flavor_fns.values():
            self._warm_fns(fns)
        self._warmed = True
        return self

    @staticmethod
    def _plan_token(fn):
        """The warm-dedup identity of an entry point: its (innermost,
        for pipelines) graph set's token; a host fallback gets a
        per-object token."""
        gs = _innermost(fn).graphs
        return gs.token if gs is not None else ("obj", id(fn))

    @staticmethod
    def _plan_prog(fn):
        """The program name warmups attribute to: the innermost entry
        point's."""
        return getattr(_innermost(fn)._fn, "program_name", None)

    def _warm_fns(self, fns):
        from ..plans import warmups

        for method, fn in fns.items():
            if not fn.jitted:
                continue   # host fallback: nothing to capture
            d = fn.n_features or self._probe_width()
            if d is None:
                raise ValueError(
                    "cannot infer n_features for warmup; estimator "
                    "exposes neither fitted params nor n_features_in_")
            token = self._plan_token(fn)
            prog = self._plan_prog(fn)
            for bucket in self.ladder:
                warmups.warm(
                    ("serving", token, str(self.device), int(bucket),
                     int(d)),
                    lambda b=bucket: fn(np.zeros((b, d), np.float32)),
                    program=prog, ladder="serving-rows", rung=int(bucket))

    def _probe_width(self):
        est = self.estimator
        if hasattr(est, "steps"):
            est = est.steps[0][1]
        return getattr(est, "n_features_in_", None)

    def warmup_sparse(self, max_nnz=None):
        """Capture the sparse entry points' (rows, nnz-bucket) grid: every
        row rung times every nnz rung (up to ``max_nnz``'s rung when
        given). The row bucket times its nnz rung fixes the packed CSR
        capacity of each graph. After this, sparse traffic on the grid
        captures nothing new; batches over the top nnz rung spill to the
        (dense-warmed) densify path."""
        from ..plans import warmups

        for fn in self._sparse_fns.values():
            top = fn.nnz_ladder.max_rows if max_nnz is None \
                else fn.nnz_bucket(min(max_nnz, fn.nnz_ladder.max_rows))
            token = self._plan_token(fn)
            prog = self._plan_prog(fn)
            for rb in self.ladder:
                for nb in fn.nnz_ladder:
                    if nb > top:
                        break
                    warmups.warm(
                        ("serving-sparse", token, str(self.device),
                         int(rb), int(nb)),
                        lambda rb=rb, nb=nb: fn.warm(rb, nb),
                        program=prog, ladder="serving-nnz", rung=int(nb))
        return self

    # -- request plane ----------------------------------------------------
    def submit(self, X, method="predict"):
        """Admit one request; returns a ``concurrent.futures.Future``
        resolving to the method's output rows for ``X``. Sheds with
        ServerOverloaded when the queue is at bound, ServerClosed after
        stop. Requests taller than the top bucket are chunked and
        reassembled: one Future either way."""
        if method not in self._fns:
            raise ValueError(
                f"method {method!r} not served; constructed with "
                f"methods={tuple(self._fns)}")
        if not self._accepting:
            raise ServerClosed("server is not accepting requests")
        import scipy.sparse as sp_

        if sp_.issparse(X):
            return self._submit_sparse(X, method)
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"expected a non-empty (n, d) request, got {X.shape}")
        want = self._fns[method].n_features
        if want is not None and X.shape[1] != want:
            raise ValueError(
                f"request has {X.shape[1]} features; the served model "
                f"expects {want}")
        return self._admit_chunked(X, method)

    def _admit_chunked(self, X, lane):
        top = self.ladder.max_rows
        if X.shape[0] <= top:
            return self._admit([Request(X, lane, self.timeout_s)])
        # oversize: top-bucket tiles admitted all-or-nothing, reassembled
        parts = [X[i:i + top] for i in range(0, X.shape[0], top)]
        if len(parts) > self.max_queue:
            # can never succeed, even against an idle server
            raise ValueError(
                f"request of {X.shape[0]} rows needs {len(parts)} "
                f"chunks but max_queue={self.max_queue}; raise "
                "max_queue or split the request")
        reqs = [Request(p, lane, self.timeout_s) for p in parts]
        self._admit(reqs)
        return _gather_futures([r.future for r in reqs])

    def _submit_sparse(self, X, method):
        """Admit a scipy-sparse request onto the sparse lane: CSR blocks
        coalesce with other sparse requests of the same method, bucket by
        (rows, nnz) and run the sparse entry point; over-nnz batches
        spill to the densified dense rung."""
        if method not in self._sparse_fns:
            raise ValueError(
                f"method {method!r} has no sparse entry point on this "
                "server (sparse serving covers linear predict / "
                "decision_function); densify the request or serve a "
                "linear model")
        import scipy.sparse as sp_

        X = X.tocsr() if not sp_.isspmatrix_csr(X) else X
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"expected a non-empty sparse (n, d) request, got "
                f"{X.shape}")
        want = self._sparse_fns[method].n_features
        if want is not None and X.shape[1] != want:
            raise ValueError(
                f"request has {X.shape[1]} features; the served model "
                f"expects {want}")
        return self._admit_chunked(X, method + "#sparse")

    def _admit(self, reqs):
        verdict = self._queue.put_many(reqs)
        if verdict == "closed":
            raise ServerClosed("server is not accepting requests")
        if verdict != "ok":
            smetrics.record_drop("shed")
            raise ServerOverloaded(
                f"queue at bound ({self.max_queue} requests); request "
                "shed")
        for r in reqs:
            smetrics.record_request(r.n_rows)
        return reqs[0].future

    # blocking conveniences ------------------------------------------------
    def _call(self, X, method):
        import concurrent.futures as cf

        fut = self.submit(X, method=method)
        extra = self.timeout_s if self.timeout_s > 0 else None
        try:
            return fut.result(None if extra is None else 30.0 + extra)
        except cf.TimeoutError:
            raise RequestTimeout(
                f"served {method} did not complete within the "
                f"{self.timeout_s * 1e3:.0f}ms deadline + 30s execution "
                "allowance") from None

    def predict(self, X):
        return self._call(X, "predict")

    def predict_proba(self, X):
        return self._call(X, "predict_proba")

    def decision_function(self, X):
        return self._call(X, "decision_function")

    def transform(self, X):
        return self._call(X, "transform")

    def score(self, X, y):
        """Served-path score: predictions through the batcher, the
        metric through the package's accuracy or r2."""
        from ..metrics import accuracy_score, r2_score

        pred = self.predict(X)
        y = np.asarray(y)
        if hasattr(self.estimator, "classes_") or hasattr(
                self.estimator, "predict_proba"):
            return float(accuracy_score(y, pred))
        return float(r2_score(y, pred))

    # -- stats -------------------------------------------------------------
    @property
    def queue_rows(self) -> int:
        """Rows queued now: the fleet's least-loaded routing signal."""
        return self._queue.rows

    def predict_exec_s(self, method: str, n_rows: int):
        """Predicted execution seconds of an ``n_rows`` batch of
        ``method`` (None before any history)."""
        try:
            bucket = self.ladder.bucket_for(min(n_rows,
                                                self.ladder.max_rows))
        except ValueError:
            bucket = self.ladder.max_rows
        return self._exec.predict_s(method, bucket)

    def stats(self):
        """Live snapshot: queue depth/rows/peak, batch and request counts,
        latency quantiles lifetime (``latency_s``) and over the window
        since the previous stats() call (``latency_window_s``), and the
        per-(method, bucket) execution summary (``exec_s``)."""
        q = self._queue
        cursor = self._stats_cursor
        cur = self._latency.snapshot()
        self._stats_cursor = cur
        out = {
            "queue_depth": q.depth,
            "queue_rows": q.rows,
            "queue_peak_depth": q.peak_depth,
            "batches": self._batches,
            "requests": self._latency.count,
            "warmed": self._warmed,
            "healthy": self.healthy,
            "version": self.model_version,
            "latency_s": self._latency.percentiles((50, 99)),
            "latency_window_s": self._latency.percentiles_between(
                cursor, (50, 99), cur=cur),
            "exec_s": self._exec.snapshot(),
        }
        if self.replica_id is not None:
            out["replica"] = self.replica_id
        return out

    # -- worker ------------------------------------------------------------
    def _run(self):
        from .. import config
        from ..observability import watchdog

        # the creator's (thread-local) config, so spans, counters, fault
        # plans and the device follow where the server was built; the
        # worker runs under the slow-span watchdog (a no-op unless
        # config.watchdog_timeout_s is set), so a wedged batch dumps the
        # threads' stacks instead of freezing the queue silently
        with config.use(self._cfg), watchdog():
            self._run_loop()

    def _run_loop(self):
        from ..reliability.faults import fault_point

        while True:
            # the replica-worker fault site, before any request is
            # popped: a crash here kills this worker with no request in
            # hand, and the queued backlog stays recoverable for the
            # fleet supervisor's drain-and-requeue
            fault_point("replica_worker")
            if not self._paused.is_set():
                if self._stop.is_set():
                    break
                self._parked.set()
                self._paused.wait(0.05)
                continue
            self._parked.clear()
            first = self._queue.pop_first(timeout=0.05)
            if first is None:
                if self._stop.is_set() and self._queue.depth == 0:
                    break
                continue
            self._serve_guarded(first)
        # drain tail: stop() requested with requests still queued
        while True:
            req = self._queue.pop_first(timeout=0.0)
            if req is None:
                break
            self._serve_guarded(req)

    def _serve_guarded(self, first):
        # the worker must be immortal: _execute fails its own batch on
        # error, this guard covers the assembly path
        try:
            self._serve_one(first)
        except Exception as exc:  # pragma: no cover - defensive
            smetrics.record_drop("error")
            fail_requests([first], ServingError(
                f"serving worker error: {type(exc).__name__}: {exc}"))

    def _serve_one(self, first):
        if first.expired():
            smetrics.record_drop("timeout")
            fail_requests([first], RequestTimeout(
                f"request waited past its {self.timeout_s * 1e3:.0f}ms "
                "deadline"))
            return
        batch = [first]
        rows = first.n_rows
        top = self.ladder.max_rows
        # coalescing deadline from the first dequeue; with an SLO and
        # execution history, the deadline-aware rule replaces the window
        dequeue_t = time.perf_counter()
        pred_cache = {}
        while rows < top and not self._stop.is_set():
            for r in self._queue.drain_method(first.method, top - rows):
                if r.expired():
                    smetrics.record_drop("timeout")
                    fail_requests([r], RequestTimeout(
                        "request waited past its deadline"))
                else:
                    batch.append(r)
                    rows += r.n_rows
            now = time.perf_counter()
            if self._slo_s > 0:
                bucket = self.ladder.bucket_for(rows)
                if bucket not in pred_cache:
                    pred_cache[bucket] = self._exec.predict_s(
                        first.method, bucket)
                predicted = pred_cache[bucket]
            else:
                predicted = None
            deadline = release_deadline(
                first.t_enqueue, dequeue_t, self.batch_window_s,
                self._slo_s, predicted)
            if now >= deadline or rows >= top:
                break
            # sleep on this method's lane: other methods' requests must
            # not turn the window into a spin
            self._queue.wait_method(first.method,
                                    min(deadline - now, 0.01))
        self._execute(batch)

    def _finish(self, batch, lane, bucket, rows, t_exec):
        self._batches += 1
        smetrics.record_batch(rows, bucket)
        done = time.perf_counter()
        # the execution wall of this (method, bucket), queue wait excluded
        self._exec.observe(lane, bucket, done - t_exec)
        for r in batch:
            lat = done - r.t_enqueue
            self._latency.observe(lat)
            smetrics.observe_request_latency(lane, bucket, lat)

    def _execute(self, batch):
        if batch[0].method.endswith("#sparse"):
            return self._execute_sparse(batch)
        # everything from pack to demux sits inside the guard: an error
        # fails THIS batch's futures, never the worker thread
        try:
            from ..reliability.faults import fault_point

            # an injected fault fails this batch typed; the worker lives
            fault_point("serving_execute")
            method = batch[0].method
            fn = self._fns[method]
            buf, segments, bucket, rows = pack_batch(
                batch, self.ladder, self._staging)
            pinned, copied = self._staging.staged(buf)
            smetrics.set_queue_gauges(self._queue.depth, rows,
                                      replica=self.replica_id)
            t_exec = time.perf_counter()
            with smetrics.batch_span(method, bucket, rows, len(batch),
                                     self._queue.depth):
                out = fn(buf if pinned is None else pinned, copied=copied)
            self._finish(batch, method, bucket, rows, t_exec)
            demux_outputs(out, segments)
        except Exception as exc:
            for _ in batch:   # per request, as the timeout path counts
                smetrics.record_drop("error")
            fail_requests(batch, ServingError(
                f"batch execution failed: {type(exc).__name__}: {exc}"))
        finally:
            smetrics.set_queue_gauges(self._queue.depth, 0,
                                      replica=self.replica_id)

    def _execute_sparse(self, batch):
        """The sparse lane's pack, run and demux: vstack the coalesced CSR
        requests, pick the (rows, nnz) cell, run the sparse entry point.
        A batch whose nnz overflows the nnz ladder spills to the dense
        entry point over a densified batch (its row rung is warm, so
        even the spill captures nothing; ``serving_sparse_spills``)."""
        import scipy.sparse as sp_

        try:
            from ..reliability.faults import fault_point

            fault_point("serving_execute")
            lane = batch[0].method
            method = lane[: -len("#sparse")]
            fn = self._sparse_fns[method]
            X = batch[0].X if len(batch) == 1 \
                else sp_.vstack([r.X for r in batch]).tocsr()
            rows = int(X.shape[0])
            bucket = self.ladder.bucket_for(rows)
            smetrics.set_queue_gauges(self._queue.depth, rows,
                                      replica=self.replica_id)
            t_exec = time.perf_counter()
            with smetrics.batch_span(lane, bucket, rows, len(batch),
                                     self._queue.depth):
                # the spill is an explicit nnz check: a real defect of
                # the sparse entry point fails the batch typed
                if int(X.nnz) > fn.nnz_ladder.max_rows:
                    from ..observability import record_sparse_spill

                    record_sparse_spill()
                    padded = np.zeros((bucket, X.shape[1]), np.float32)
                    padded[:rows] = X.toarray()
                    out = np.asarray(self._fns[method](padded))[:rows]
                else:
                    out = fn(X, n_rows=bucket)
            self._finish(batch, lane, bucket, rows, t_exec)
            out = np.asarray(out)
            lo = 0
            for r in batch:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_result(out[lo:lo + r.n_rows])
                lo += r.n_rows
        except Exception as exc:
            for _ in batch:
                smetrics.record_drop("error")
            fail_requests(batch, ServingError(
                f"sparse batch execution failed: "
                f"{type(exc).__name__}: {exc}"))
        finally:
            smetrics.set_queue_gauges(self._queue.depth, 0,
                                      replica=self.replica_id)


def _gather_futures(futures):
    """One Future resolving to the row-concatenation of ``futures``'
    results (oversize-request reassembly); the first failure propagates."""
    from concurrent.futures import Future

    out = Future()
    remaining = [len(futures)]
    lock = threading.Lock()

    def _fail(exc):
        try:
            if out.set_running_or_notify_cancel():
                out.set_exception(exc)
        except Exception:
            pass  # already resolved by a racing callback

    def _done(fut):
        # the first failure propagates at once
        exc = fut.exception() if not fut.cancelled() else None
        if exc is not None:
            _fail(exc)
            return
        with lock:
            remaining[0] -= 1
            if remaining[0] > 0 or out.done():
                return
        try:
            parts = [f.result() for f in futures]
        except BaseException as exc:  # noqa: BLE001 - forwarded, not hidden
            _fail(exc)
            return
        if out.set_running_or_notify_cancel():
            out.set_result(np.concatenate(parts, axis=0))

    for f in futures:
        f.add_done_callback(_done)
    return out
