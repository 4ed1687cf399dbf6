"""The kernel registry: per-kernel launches, device times and bounds.

Counterpart of ``dask_ml_tpu/observability/_programs.py``, which keeps
one row per compiled XLA program. The port's compiled work is its ten
hand-written CUDA kernels (``ops/fused.py::KERNELS``), so it keeps one
row per kernel wrapper:

- ``calls``: the wrapper's launch count (``fused.launches()``), a plain
  host integer kept whatever the knobs say;
- ``bytes_per_call`` / ``flops_per_call``: the work of the latest timed
  launch, from its own shapes, by the formulas behind the bound column of
  ``PERF.md`` (section 6); ``flops_total`` over the timed launches, also
  added to the ``program_flops`` counter so a span's measured MFU works
  as in the JAX package;
- ``timed_calls``, ``exec_s`` and ``device_ms_median``: with
  ``config.obs_programs`` on, a pair of ``torch.cuda.Event(enable_timing
  =True)`` is recorded on the launching stream around each launch. The
  pairs wait in a bounded ring and are resolved only when a snapshot is
  taken: the hot path never synchronizes. A full ring first folds the
  pairs whose stop event already completed (``Event.query``, no wait),
  then drops its oldest, counted in ``dropped_events``. Inside a CUDA
  graph capture no event is recorded (it would become part of the
  graph): the launch is counted in ``captured_calls`` only;
- ``bound_s`` (per call, latest shape), ``bound_by``, ``bound_s_total``
  and ``share_of_bound`` = ``bound_s_total / exec_s`` over the timed
  launches, against the card's row of ``_peak.py``. A share above 1.05
  sets ``share_flag``: the kernel cannot beat its bound, so the count of
  its work is wrong. An unknown card gets no bound (``bound_reason``).

With ``obs_programs`` off a launch pays one config read. Programs that
are not kernels (the plans' graph sets) join through
:func:`track_program`, with the JAX row's keys (calls, host wall,
captures as ``compiles``). The plans table stays
``plans/plan.py::plans_snapshot``, which ``log_programs`` and
``/status`` read beside this one, as in the JAX package.
"""

from __future__ import annotations

import collections
import functools
import statistics
import threading
import time

from ._counters import counter_add, counters_enabled

RING = 4096          # event pairs waiting to be resolved
TIMES_KEPT = 4096    # resolved times per row behind the median
SHARE_FLAG = 1.05

_lock = threading.Lock()
_rows: dict[str, dict] = {}
_pending: collections.deque = collections.deque()
_CAPTURING = object()
# rows of tracked programs that are not kernel wrappers (track_program)
_tracked: dict[str, dict] = {}


def programs_enabled() -> bool:
    from ..config import get_config

    return bool(get_config().obs_programs)


# -- programs that are not kernels --------------------------------------------

def _program_row(name):
    return {"program": name, "compiles": 0, "compile_s": 0.0, "calls": 0,
            "exec_s": 0.0, "flops_per_call": None, "bytes_per_call": None,
            "flops_total": 0.0, "flops_exec": 0.0, "hbm_peak_bytes": None}


def track_program(name: str):
    """Decorator registering a program that is not a kernel wrapper (a
    plan's entry point, ``plans/plan.py::GraphSet.run``) in a row of its
    own, with the JAX row's keys: with ``obs_programs`` on each call adds
    to ``calls`` and to ``exec_s``, its host wall (the callers wait for
    the card); off, a call is one config read and a passthrough."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not programs_enabled():
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with _lock:
                r = _tracked.setdefault(name, _program_row(name))
                r["calls"] += 1
                r["exec_s"] += dt
            return out

        wrapped.program_name = name
        return wrapped

    return deco


def record_compile(name: str, seconds: float) -> None:
    """One CUDA graph captured for the tracked program ``name`` (the JAX
    row's ``compiles`` and ``compile_s``)."""
    if programs_enabled():
        with _lock:
            r = _tracked.setdefault(name, _program_row(name))
            r["compiles"] += 1
            r["compile_s"] += seconds


# -- the work of one launch ---------------------------------------------------
# name -> f(*shape) -> (bytes moved, ((operations, kind of peak), ...)):
# each input read once, each output written once; the shapes are those of
# the launch (the rows it was given to sum, not the buffer's height)

def _glm_value_grad(n, d, itemsize):
    return (n * (d * itemsize + 4) + d * 4 + (d + 1) * 4,
            ((4.0 * n * d + 12.0 * n,
              "float32" if itemsize == 4 else "bfloat16"),))


def _glm_value_grad_hess(n, d):
    return (n * (d + 1) * 4 + d * 4 + (1 + d + d * d) * 4,
            ((2.0 * n * (d * (d + 1) / 2 + 2 * d), "tf32x3"),))


def _glm_multi_value_grad(n, d, c, itemsize):
    return (n * (d * itemsize + 4) + c * d * 4 + (1 + c * d) * 4,
            ((4.0 * n * d * c + 12.0 * n * c,
              "tf32x3" if itemsize == 4 else "bfloat16"),))


def _lloyd_io(d, k):
    return d * k * 4 + (k * d + k + 1) * 4


def _lloyd_ops(n, d, k):
    return 2.0 * n * k * d, 2.0 * n * d + 3.0 * n * k + n * d


def _lloyd_stats(n, d, k, mxu):
    return (n * d * 4 + _lloyd_io(d, k),
            ((sum(_lloyd_ops(n, d, k)), "tf32x3"),))


def _assign_update(n, d, k, mxu):
    return (n * d * 4 + n * 4 + _lloyd_io(d, k) + n * 8,
            ((sum(_lloyd_ops(n, d, k)), "tf32x3"),))


def _kmeans_block_stats(n, d, k, mxu):
    cross, other = _lloyd_ops(n, d, k)
    terms = ((cross + other, "tf32x3"),) if not mxu else \
        ((cross, "bfloat16"), (other, "float32"))
    return n * d * 4 + k * d * 4 + (k * d + k + 1) * 4, terms


def _glm_stream(kind, n, d, mxu):
    nbytes = n * (d + 1) * 4 + (d + 1) * 4
    flops = 2.0 * n * d + 12.0 * n
    if kind != "val":
        flops += 2.0 * n * d
        nbytes += (d + 2) * 4
    if kind == "vgh":
        flops += 2.0 * n * (d * (d + 1) / 2 + d)
        nbytes += (d + 1) ** 2 * 4
        return nbytes, ((flops, "tf32x3"),)
    return nbytes, ((flops, "bfloat16" if mxu else "float32"),)


def _glm_multi_stream(kind, n, d, c, mxu):
    nbytes = n * (d + 1) * 4 + c * (d + 1) * 4
    flops = 2.0 * n * d * c + 12.0 * n * c
    if kind == "vg":
        flops += 2.0 * n * d * c
        nbytes += (1 + c * (d + 1)) * 4
    return nbytes, ((flops, "bfloat16" if mxu else "tf32x3"),)


def _sgd_block_grad(n, d, n_models, mxu):
    return (n * (d + 1) * 4 + 2 * n_models * (d + 2) * 4,
            ((4.0 * n * d * n_models + 12.0 * n * n_models,
              "bfloat16" if mxu else "tf32x3"),))


KERNEL_COSTS = {
    "fused_glm_value_grad": _glm_value_grad,
    "fused_lloyd_stats": _lloyd_stats,
    "fused_assign_update": _assign_update,
    "fused_glm_value_grad_hess": _glm_value_grad_hess,
    "fused_glm_multi_value_grad": _glm_multi_value_grad,
    "fused_glm_stream": _glm_stream,
    "fused_glm_multi_stream": _glm_multi_stream,
    "fused_kmeans_block_stats": _kmeans_block_stats,
    "fused_sgd_block_grad": _sgd_block_grad,
    "fused_sgd_many_block_grad": _sgd_block_grad,
}


def kernel_bound(name, *shape, row=None):
    """(bound seconds, "bytes" or "operations") of one launch of the
    kernel ``name`` at ``shape`` (its cost function's arguments) on the
    card of the peak-table ``row`` (this process's card when None); None
    where no bound is known."""
    from ._peak import bound_seconds, resolve_peak

    nbytes, terms = KERNEL_COSTS[name](*shape)
    return bound_seconds(nbytes, terms,
                         resolve_peak() if row is None else row)


# -- the hot path -------------------------------------------------------------

def launch_begin(device):
    """Before a kernel launch on ``device``: None when ``obs_programs``
    is off (one config read), a marker inside a CUDA graph capture, else
    the start event, recorded on the launching stream."""
    if not programs_enabled():
        return None
    import torch

    if torch.cuda.is_current_stream_capturing():
        return _CAPTURING
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def launch_end(token, name, device, *shape):
    """After the launch that :func:`launch_begin` returned ``token``
    for: records the stop event and queues the pair with the launch's
    work. Never waits on the card."""
    if token is None:
        return
    if token is _CAPTURING:
        with _lock:
            _row(name)["captured_calls"] += 1
        return
    import torch

    stop = torch.cuda.Event(enable_timing=True)
    stop.record(torch.cuda.current_stream(device))
    nbytes, terms = KERNEL_COSTS[name](*shape)
    flops = sum(f for f, _ in terms)
    done = None
    with _lock:
        if len(_pending) >= RING:
            done = _take_locked(block=False)
            if len(_pending) >= RING:
                dropped = _pending.popleft()
                _row(dropped[0])["dropped_events"] += 1
        _pending.append((name, token, stop, nbytes, terms, flops))
    _fold(done)
    if counters_enabled():
        counter_add("program_flops", flops)


def _new_row():
    return {
        "timed_calls": 0, "captured_calls": 0, "dropped_events": 0,
        "exec_s": 0.0, "flops_total": 0.0, "bytes_total": 0.0,
        "bytes_per_call": None, "flops_per_call": None,
        "bound_s": None, "bound_by": None, "bound_s_total": 0.0,
        "times_ms": collections.deque(maxlen=TIMES_KEPT),
    }


def _row(name):
    r = _rows.get(name)
    if r is None:
        r = _rows[name] = _new_row()
    return r


def _take_locked(block):
    """Remove from the ring, oldest first, the pairs to fold: every pair
    when ``block``, else those whose stop event completed (``query``
    never waits). Caller holds ``_lock``."""
    if block:
        taken = list(_pending)
        _pending.clear()
        return taken
    taken, keep = [], []
    for entry in _pending:
        (taken if entry[2].query() else keep).append(entry)
    _pending.clear()
    _pending.extend(keep)
    return taken


def _fold(entries):
    """Resolve taken pairs (waiting on each stop event, without the lock:
    a launch on another thread never waits behind a snapshot) and add
    them to their rows."""
    if not entries:
        return
    from ._peak import bound_seconds, resolve_peak

    row_peak = resolve_peak()
    resolved = []
    for name, start, stop, nbytes, terms, flops in entries:
        stop.synchronize()
        resolved.append((name, start.elapsed_time(stop), nbytes, flops,
                         bound_seconds(nbytes, terms, row_peak)))
    with _lock:
        for name, ms, nbytes, flops, b in resolved:
            r = _row(name)
            r["timed_calls"] += 1
            r["exec_s"] += ms / 1e3
            r["times_ms"].append(ms)
            r["flops_total"] += flops
            r["bytes_total"] += nbytes
            r["bytes_per_call"], r["flops_per_call"] = float(nbytes), flops
            if b is not None:
                r["bound_s"], r["bound_by"] = b
                r["bound_s_total"] += b[0]


def programs_snapshot() -> list[dict]:
    """One row per kernel wrapper, then the tracked programs' rows
    (copies), most FLOPs first. Resolves
    every queued event pair first (the one place that waits on the
    card)."""
    from ..ops import fused
    from ._peak import resolve_peak

    with _lock:
        taken = _take_locked(block=True)
    _fold(taken)
    with _lock:
        state = {k: dict(v, times_ms=list(v["times_ms"]))
                 for k, v in _rows.items()}
    pk = resolve_peak()
    # nvidia-smi's line names the card beside its power limit
    limit = pk.get("power_limit") or ""
    peak = None if not pk.get("hbm_bytes_per_s") else (
        f"{limit}, {pk['source']}" if pk["device_kind"] in limit
        else f"{pk['device_kind']}, power limit {limit}, {pk['source']}")
    launches = fused.launches()
    rows = []
    for name in fused.KERNELS:
        r = state.get(name) or dict(_new_row(), times_ms=[])
        times = r.pop("times_ms")
        share = (r["bound_s_total"] / r["exec_s"]
                 if r["exec_s"] > 0 and r["bound_s"] is not None else None)
        rows.append({
            "program": name,
            # the JAX row's keys, so either package's report reads it
            "compiles": 0,
            "compile_s": 0.0,
            "calls": int(launches[name]),
            "flops_exec": r["flops_total"],
            "hbm_peak_bytes": None,
            **r,
            "device_ms_median": statistics.median(times) if times
            else None,
            "share_of_bound": share,
            "share_flag": bool(share is not None and share > SHARE_FLAG),
            "bound_reason": pk.get("reason"),
            "peak": peak,
        })
    with _lock:
        rows += [dict(r) for r in _tracked.values()]
    rows.sort(key=lambda e: -(e["flops_total"] or 0.0))
    return rows


def programs_reset() -> None:
    """Forget every timed launch, queued or folded (the launch counts
    are the wrappers', reset by ``fused.reset_launches``)."""
    with _lock:
        _rows.clear()
        _pending.clear()
        _tracked.clear()


def log_programs(logger, peak=True, **extra) -> list[dict]:
    """Emit one JSONL record holding the registry snapshot (plus the
    plans table, and the peak fields when ``peak``, so an offline report
    can compute MFU); returns the snapshot. The report CLI reads the LAST
    such record as the run's kernel table."""
    snap = programs_snapshot()
    if logger is None:
        return snap
    rec = {"programs": snap}
    try:
        from ..plans import plans_snapshot

        plrows = plans_snapshot()
    except Exception:
        plrows = None
    if plrows:
        rec["plans"] = plrows
    if peak:
        import torch

        from ._peak import resolve_peak

        pk = resolve_peak()
        if pk.get("flops"):
            rec.update(
                peak_flop_per_s_per_chip=pk["flops"],
                peak_source=pk["source"],
                device_kind=pk["device_kind"],
                n_chips=max(1, torch.cuda.device_count()
                            if torch.cuda.is_available() else 1),
            )
    logger.log(**rec, **extra)
    return snap
