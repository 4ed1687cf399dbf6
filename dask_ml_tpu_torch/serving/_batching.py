"""Micro-batching plumbing: request records, batch packing, ping-pong
staging buffers, and result demultiplexing.

Counterpart of ``dask_ml_tpu/serving/_batching.py``. Each (bucket,
width) pair owns TWO preallocated host staging arrays used alternately,
so steady-state serving allocates nothing for its inputs. On the card
they are pinned, and the copy of a batch to the card is asynchronous: a
buffer is handed out for packing again only after the event recorded
once its last copy was issued has completed (:class:`PingPongStaging`).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

__all__ = ["Request", "PingPongStaging", "pack_batch", "demux_outputs",
           "release_deadline"]


def release_deadline(oldest_enqueue_t, dequeue_t, window_s, slo_s,
                     predicted_exec_s, margin_frac=0.15):
    """When must the coalescing loop stop waiting and dispatch?

    The fixed rule (no SLO configured, or no latency history yet to
    predict from): ``dequeue_t + window_s`` — the classic min/max batch
    window, measured from the first dequeue so a trickle of stragglers
    cannot hold a batch forever.

    The DEADLINE-AWARE rule (``config.serving_slo_ms`` set and an
    execution-time prediction available): the batch must leave early
    enough that the OLDEST request still makes its SLO —
    ``oldest_enqueue + slo - predicted_exec - margin``. That replaces
    the fixed window in both directions: a slow bucket releases a
    partial batch EARLY (waiting would already miss), while an ample
    budget lets the batcher coalesce LONGER than the fixed window for
    better occupancy. The margin (default 15% of the SLO) absorbs
    prediction error and the demux/host tail the execution histogram
    does not see. Never returns earlier than ``dequeue_t`` — an
    already-doomed oldest request dispatches immediately rather than
    waiting at all."""
    if slo_s <= 0 or predicted_exec_s is None:
        return dequeue_t + window_s
    return max(
        oldest_enqueue_t + slo_s - predicted_exec_s
        - slo_s * margin_frac,
        dequeue_t,
    )


class Request:
    """One admitted inference request: a small (n, d) float32 block plus
    the Future its caller is waiting on."""

    __slots__ = ("X", "n_rows", "method", "future", "t_enqueue",
                 "deadline", "seq", "trace")

    def __init__(self, X, method, timeout_s=0.0, future=None):
        self.X = X
        self.n_rows = int(X.shape[0])
        self.method = method
        self.future = future if future is not None else Future()
        self.seq = 0              # stamped by BoundedQueue at admission
        self.t_enqueue = time.perf_counter()
        self.deadline = (self.t_enqueue + timeout_s) if timeout_s > 0 \
            else None
        self.trace = None         # a RequestTrace when traces are on

    def expired(self, now=None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            > self.deadline


class PingPongStaging:
    """Two alternating host staging arrays per (bucket, width) shape.

    ``get(bucket, d)`` returns the next buffer of shape (bucket, d),
    zero-filled only on first allocation: pack_batch overwrites every
    real row and zeroes the padding tail.

    ``pinned=True`` (a server on the card) backs each buffer with pinned
    host memory and a CUDA event: :meth:`staged` gives the pinned tensor
    the entry point copies from and the event it records once that copy
    is issued, and ``get`` waits for a buffer's event before handing it
    out again, so batch k+1's pack never overwrites memory that batch
    k's asynchronous copy is still reading.
    """

    __slots__ = ("_bufs", "_flip", "_pinned", "_staged")

    def __init__(self, pinned=False):
        self._bufs = {}     # (bucket, d) -> [arr0, arr1]
        self._flip = {}     # (bucket, d) -> 0|1
        self._pinned = bool(pinned)
        self._staged = {}   # id(arr) -> (pinned tensor, event)

    def _alloc(self, bucket, d):
        if not self._pinned:
            return np.zeros((bucket, d), np.float32)
        import torch

        t = torch.zeros((bucket, d), dtype=torch.float32, pin_memory=True)
        arr = t.numpy()
        self._staged[id(arr)] = (t, torch.cuda.Event())
        return arr

    def get(self, bucket: int, d: int) -> np.ndarray:
        key = (bucket, d)
        pair = self._bufs.get(key)
        if pair is None:
            pair = [self._alloc(bucket, d), self._alloc(bucket, d)]
            self._bufs[key] = pair
            self._flip[key] = 0
        i = self._flip[key]
        self._flip[key] = 1 - i
        buf = pair[i]
        staged = self._staged.get(id(buf))
        if staged is not None:
            # its previous copy to the card must have finished reading it
            staged[1].synchronize()
        return buf

    def staged(self, buf):
        """(pinned tensor, event) behind ``buf``; (None, None) for an
        unpinned buffer."""
        return self._staged.get(id(buf), (None, None))


def pack_batch(requests, ladder, staging):
    """Coalesce ``requests`` (same method, total rows <= ladder top)
    into one padded staging buffer.

    Returns ``(batch, segments, bucket, rows)`` where ``segments`` is a
    list of (request, start) row offsets for demux and ``rows`` the real
    (unpadded) row count.
    """
    rows = sum(r.n_rows for r in requests)
    d = requests[0].X.shape[1]
    bucket = ladder.bucket_for(rows)
    buf = staging.get(bucket, d)
    segments = []
    at = 0
    for r in requests:
        buf[at:at + r.n_rows] = r.X
        segments.append((r, at))
        at += r.n_rows
    if at < bucket:
        # zero the padding tail: model math on padding rows must stay
        # finite (garbage from a previous, larger batch could overflow
        # an exp/sigmoid into NaNs that some backends propagate slowly)
        buf[at:bucket] = 0.0
    return buf, segments, bucket, rows


def demux_outputs(out, segments):
    """Slice each caller's rows back out of the batched output and
    resolve their futures; padding rows (beyond the last segment) are
    dropped here."""
    for req, start in segments:
        piece = out[start:start + req.n_rows]
        tr = req.trace
        if tr is not None:
            tr.stamp("demux")
        if not req.future.set_running_or_notify_cancel():
            if tr is not None:
                tr.finish("cancelled")
            continue  # caller cancelled while we computed
        # a copy: the caller's array must be its own
        req.future.set_result(np.array(piece))
        if tr is not None:
            # after set_result: the sampler's folds never sit between
            # the result and the caller's wakeup
            tr.stamp("complete")
            tr.finish("ok")


def fail_requests(requests, exc, outcome="error"):
    """Resolve every request's future with ``exc`` (a batch failure or a
    shed); futures already cancelled or resolved are skipped. ``outcome``
    is the traced requests' terminal state ("error", "timeout", "shed",
    "closed"; a trace finishes once, so a request a partial demux
    already completed keeps its first outcome)."""
    for r in requests:
        try:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(exc)
        except Exception:
            pass  # future already in a terminal state
        if r.trace is not None:
            r.trace.finish(outcome)


class BoundedQueue:
    """The admission-controlled request queue: one lock + condition,
    per-method FIFO lanes, a global request bound, and deadline-aware
    popping. ``put_many`` never blocks — over the bound it returns
    "full" and the server sheds with ServerOverloaded (backpressure
    surfaces to the caller immediately instead of silently growing
    latency). Admission is ATOMIC with shutdown: ``close()`` flips the
    closed flag under the same lock, so any successful put
    happens-before close and is guaranteed to be drained by the
    worker's tail loop — no request can strand in a closed queue."""

    __slots__ = ("_lock", "_cond", "_lanes", "_seq", "max_requests",
                 "depth", "rows", "peak_depth", "closed")

    def __init__(self, max_requests):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._lanes = {}          # method -> deque[Request]
        self._seq = 0             # global admission order stamp
        self.max_requests = int(max_requests)
        self.depth = 0
        self.rows = 0             # queued ROWS (the admission/routing
        #                           load signal — depth counts requests)
        self.peak_depth = 0
        self.closed = False

    def put_many(self, reqs) -> str:
        """Admit ALL of ``reqs`` or none (a chunked oversize request
        must not half-enter: shedding part way would burn capacity on
        orphaned chunks). Returns "ok" / "full" / "closed"."""
        from collections import deque

        with self._lock:
            if self.closed:
                return "closed"
            if self.depth + len(reqs) > self.max_requests:
                return "full"
            for req in reqs:
                req.seq = self._seq
                self._seq += 1
                lane = self._lanes.get(req.method)
                if lane is None:
                    lane = self._lanes[req.method] = deque()
                lane.append(req)
            self.depth += len(reqs)
            self.rows += sum(r.n_rows for r in reqs)
            self.peak_depth = max(self.peak_depth, self.depth)
            self._cond.notify()
            return "ok"

    def put(self, req) -> bool:
        return self.put_many([req]) == "ok"

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._cond.notify_all()

    def _pop_oldest_locked(self):
        # lanes are FIFO deques; the globally oldest request is one of
        # the lane HEADS (O(#methods) scan, O(1) popleft — no per-pop
        # list surgery on the admission-contended hot path)
        best = None
        for lane in self._lanes.values():
            if lane and (best is None or lane[0].seq < best[0].seq):
                best = lane
        if best is None:
            return None
        self.depth -= 1
        req = best.popleft()
        self.rows -= req.n_rows
        return req

    def pop_first(self, timeout):
        """Oldest request across lanes, blocking up to ``timeout``
        seconds; None on timeout."""
        with self._lock:
            if self.depth == 0:
                self._cond.wait(timeout)
            return self._pop_oldest_locked()

    def drain_method(self, method, max_rows):
        """Non-blockingly pop same-``method`` requests while their rows
        fit under ``max_rows``; stops at the first request that would
        overflow the batch (FIFO order within the lane is preserved) or
        when the lane empties."""
        got = []
        with self._lock:
            lane = self._lanes.get(method)
            budget = max_rows
            while lane:
                if lane[0].n_rows > budget:
                    break
                req = lane.popleft()
                self.depth -= 1
                self.rows -= req.n_rows
                budget -= req.n_rows
                got.append(req)
        return got

    def wait_method(self, method, timeout) -> None:
        """Sleep up to ``timeout`` while THIS method's lane is empty.
        The wait rides the queue's single shared condition, so a
        foreign method's admission still wakes the caller early (one
        cheap spurious wakeup per foreign put) — what this prevents is
        the depth>0 busy-spin a whole-queue wait would cause when only
        other methods' requests are pending; callers re-check their
        lane (via drain_method) after waking."""
        with self._lock:
            if not self._lanes.get(method):
                self._cond.wait(timeout)

    def drain_all(self):
        with self._lock:
            out = []
            while True:
                r = self._pop_oldest_locked()
                if r is None:
                    break
                out.append(r)
            return out

    def wake(self):
        with self._lock:
            self._cond.notify_all()
