"""The runtime counter registry and the device memory gauges.

Counterpart of ``dask_ml_tpu/observability/_counters.py``: a flat
``name -> number`` dict under one lock, gated by ``config.obs_counters``
(off: every recorder is one config read), with the recorders under the
JAX names, so a status page or a report reads alike in both packages:

- ``h2d_bytes`` and ``h2d_transfers``: host-to-device copies of the
  streamed blocks (``BlockStream``);
- ``program_flops``: the operations of the kernel launches the kernel
  registry timed (``_programs.py``);
- ``faults_injected`` and ``faults_injected_<site>``: armed faults that
  fired (``reliability/faults.py``);
- ``stream_retries``: host block reads retried after an ``OSError``;
- ``stream_quarantined_blocks``: blocks folded out by
  ``stream_nonfinite="quarantine"``;
- ``stream_checkpoint_saves`` and ``stream_resumes``: pass checkpoints
  saved, and fits restored from one;
- ``plan_builds``, ``plan_cache_hits``, ``plan_warmups`` (``plans/``) and
  ``graph_captures``, the CUDA graphs captured, in the place of the JAX
  package's ``recompiles``;
- ``watchdog_stalls`` (``_watchdog.py``);
- the serving, registry, reroute, replica and scale counters
  (``serving/``, ``reliability/supervisor.py``).

:func:`device_memory_gauges` polls ``torch.cuda.memory_stats`` of every
visible card (``{}`` on the CPU); :func:`log_counters` writes one record
holding the counters and those gauges, the record the report CLI reads
as a run's totals.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, float] = {}


def counters_enabled() -> bool:
    from ..config import get_config

    return bool(get_config().obs_counters)


def counter_add(name: str, value=1) -> None:
    """Unconditional add, for call sites that checked the gate already."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def counters_snapshot() -> dict:
    with _lock:
        return dict(_counters)


def counters_reset() -> None:
    with _lock:
        _counters.clear()


def record_transfer(nbytes: int, direction: str = "h2d") -> None:
    """One host-to-device copy of ``nbytes`` (the block streamer calls
    this per staged block)."""
    if counters_enabled():
        counter_add(f"{direction}_bytes", int(nbytes))
        counter_add(f"{direction}_transfers", 1)


def device_memory_gauges() -> dict:
    """Per-card memory as a flat gauge dict, under the JAX keys
    ``dev{i}_bytes_in_use``, ``dev{i}_peak_bytes_in_use`` and
    ``dev{i}_bytes_limit`` (the caching allocator's view, its peak since
    the last ``torch.cuda.reset_peak_memory_stats``); ``{}`` on the CPU
    or before the process touched a card. Polled, not accumulated."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
        except Exception:
            continue
        out[f"dev{i}_bytes_in_use"] = int(
            stats.get("allocated_bytes.all.current", 0))
        out[f"dev{i}_peak_bytes_in_use"] = int(
            stats.get("allocated_bytes.all.peak", 0))
        out[f"dev{i}_bytes_limit"] = int(limit)
    return out


def log_counters(logger, **extra) -> dict:
    """Emit one JSONL record holding the current counter snapshot plus
    the device memory gauges; returns the snapshot. The report CLI reads
    the LAST such record as the run's totals."""
    snap = counters_snapshot()
    if logger is not None:
        logger.log(counters=True, **snap, **device_memory_gauges(),
                   **extra)
    return snap


def record_watchdog_stall() -> None:
    """One span reported open past ``config.watchdog_timeout_s``."""
    if counters_enabled():
        counter_add("watchdog_stalls", 1)


def record_fault_injected(site: str, kind: str) -> None:
    """One armed fault fired at ``site``: the total and the site's
    share."""
    if counters_enabled():
        counter_add("faults_injected", 1)
        counter_add(f"faults_injected_{site}", 1)


def record_stream_retry() -> None:
    """One failed host block read absorbed by the bounded retry."""
    if counters_enabled():
        counter_add("stream_retries", 1)


def record_stream_quarantine() -> None:
    """One streamed block quarantined by the non-finite policy."""
    if counters_enabled():
        counter_add("stream_quarantined_blocks", 1)


def record_stream_checkpoint(resume: bool = False) -> None:
    """One pass checkpoint saved, or with ``resume=True`` one fit
    restored from a checkpoint."""
    if counters_enabled():
        counter_add("stream_resumes" if resume
                    else "stream_checkpoint_saves", 1)


# -- execution plans (plans/) -------------------------------------------------

def record_plan_build(cached: bool = False) -> None:
    """One ProgramPlan build: ``plan_builds`` for a fresh program,
    ``plan_cache_hits`` when the process-wide build cache returned one."""
    if counters_enabled():
        counter_add("plan_cache_hits" if cached else "plan_builds", 1)


def record_plan_warmup(hit: bool = False) -> None:
    """One WarmupRegistry event: ``plan_warmups`` for an executed warm
    call, ``plan_cache_hits`` for a key already warm."""
    if counters_enabled():
        counter_add("plan_cache_hits" if hit else "plan_warmups", 1)


def record_graph_capture() -> None:
    """One new (entry point, bucket) specialization: on the card a CUDA
    graph captured, on the CPU the key the card would capture (the body
    runs eagerly there). It takes the place of the JAX package's
    ``recompiles`` in every "nothing new after warmup" check."""
    if counters_enabled():
        counter_add("graph_captures", 1)


# -- serving (serving/) -------------------------------------------------------

_SERVING_DROP_COUNTERS = {
    "shed": "serving_shed",          # admission control refused entry
    "timeout": "serving_timeouts",   # deadline passed while queued
    "error": "serving_errors",       # batch execution raised
    "slo_shed": "serving_slo_shed",  # SLO admission predicted a miss
}


def record_serving_request(n_rows: int) -> None:
    """One admitted serving request of ``n_rows`` rows."""
    if counters_enabled():
        counter_add("serving_requests", 1)
        counter_add("serving_rows", int(n_rows))


def record_serving_batch(rows: int, bucket: int) -> None:
    """One executed micro-batch of ``rows`` real rows padded to the
    ``bucket`` rung."""
    if counters_enabled():
        counter_add("serving_batches", 1)
        counter_add("serving_padded_rows", int(bucket - rows))


def record_serving_drop(kind: str) -> None:
    """A request resolved without a result; ``kind`` in {'shed',
    'timeout', 'error', 'slo_shed'}."""
    if counters_enabled():
        counter_add(_SERVING_DROP_COUNTERS[kind], 1)


def record_serving_swap(rebuilt: bool = False) -> None:
    """One model hot-swap; ``rebuilt=True`` when the shapes changed and
    the entry points were built anew instead."""
    if counters_enabled():
        counter_add("serving_swaps", 1)
        if rebuilt:
            counter_add("serving_swap_rebuilds", 1)


def record_serving_reroute() -> None:
    """A fleet request rerouted off a failed or closed replica."""
    if counters_enabled():
        counter_add("serving_reroutes", 1)


def record_serving_slo_violation() -> None:
    """A served request whose end-to-end latency exceeded
    ``config.serving_slo_ms``."""
    if counters_enabled():
        counter_add("serving_slo_violations", 1)


def record_sparse_spill() -> None:
    """A served sparse batch whose nnz exceeded the nnz ladder's top rung
    and ran through the dense entry point instead."""
    if counters_enabled():
        counter_add("serving_sparse_spills", 1)


def record_registry_publish(rollback: bool = False) -> None:
    """One version published to (or rolled back in) a ModelRegistry."""
    if counters_enabled():
        counter_add("registry_publishes", 1)
        if rollback:
            counter_add("registry_rollbacks", 1)


def record_replica_restart() -> None:
    """The supervisor rebuilt a dead fleet replica."""
    if counters_enabled():
        counter_add("serving_replica_restarts", 1)


def record_replica_failure() -> None:
    """A replica spent its restart budget: permanent failover."""
    if counters_enabled():
        counter_add("serving_replica_failures", 1)


def record_scale_up() -> None:
    """The autoscaler added a replica."""
    if counters_enabled():
        counter_add("serving_scale_ups", 1)


def record_scale_down() -> None:
    """The autoscaler retired a replica."""
    if counters_enabled():
        counter_add("serving_scale_downs", 1)
