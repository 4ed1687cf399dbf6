"""The reliability plane of the port: deterministic fault injection and
the checkpoints and hardening that make each injected fault survivable.

Counterpart of ``dask_ml_tpu/reliability``:

- ``faults``: :class:`FaultPlan` and :func:`fault_point`, named host-side
  fault sites armed by ``config.fault_plan`` and firing by invocation
  index, so chaos runs replay exactly;
- ``stream_ckpt``: fingerprint-keyed pass-granular checkpoints of the
  streamed GLM, SGD, KMeans and Incremental fits
  (``config.stream_checkpoint_path``, ``stream_checkpoint_every``).

The hardening lives where the faults strike: the bounded-backoff read
retry, the non-finite block policy and the drain of a crashed pass in
``parallel/streaming.py``; the solvers' and fits' checkpoints in
``models/``; the searches' round checkpoints in
``model_selection/_incremental.py``; the serving sites
(``serving_execute``, ``replica_worker``) in ``serving/_server.py``.

- ``supervisor``: :class:`ReplicaSupervisor`, which rebuilds a dead
  fleet replica off the serving path (``config.serving_supervise``).

:func:`status_block` is the ``reliability`` block of the live
exporter's ``/status`` page (``observability/live.py``).
"""

from __future__ import annotations

from .faults import (
    FAULT_KINDS,
    FAULT_SITES,
    FaultInjected,
    FaultPlan,
    InjectedCrash,
    InjectedIOError,
    NonFiniteBlock,
    StreamIORetriesExhausted,
    active_plan,
    fault_point,
    fire_plan,
    reset_plans,
)
from .stream_ckpt import StreamCheckpoint, stream_checkpoint
from .supervisor import ReplicaSupervisor

__all__ = [
    "FAULT_KINDS",
    "FAULT_SITES",
    "FaultInjected",
    "FaultPlan",
    "InjectedCrash",
    "InjectedIOError",
    "NonFiniteBlock",
    "RELIABILITY_COUNTERS",
    "ReplicaSupervisor",
    "StreamCheckpoint",
    "StreamIORetriesExhausted",
    "active_plan",
    "fault_point",
    "fire_plan",
    "reset_plans",
    "status_block",
    "stream_checkpoint",
]

# the counters of the reliability status (flat names, the JAX package's)
RELIABILITY_COUNTERS = (
    "faults_injected",
    "stream_retries",
    "stream_quarantined_blocks",
    "stream_checkpoint_saves",
    "stream_resumes",
    "serving_replica_restarts",
    "serving_replica_failures",
)


def status_block() -> dict:
    """The reliability status: the armed plan (if any) with each site's
    invocation and fired counts, and the reliability counters."""
    from ..config import get_config
    from ..observability._counters import counters_snapshot

    snap = counters_snapshot()
    counters = {k: v for k, v in snap.items()
                if k in RELIABILITY_COUNTERS
                or k.startswith("faults_injected_")}
    spec = get_config().fault_plan
    plan = active_plan() if spec else None
    return {
        "fault_plan": spec or None,
        "sites": plan.snapshot() if plan is not None else {},
        "counters": counters,
    }
