"""Online inference serving for fitted estimators.

Counterpart of ``dask_ml_tpu/serving``: many small concurrent requests
answered without a fresh CUDA graph per novel shape or a host-to-device
parameter copy per call.

- ``_buckets``: the geometric shape-bucket ladder bounding the set of
  captured graphs;
- ``_batching``: request records, the bounded admission queue, pinned
  ping-pong staging, pack/demux, the deadline-aware batch release;
- ``_server``: :class:`ModelServer`, the micro-batching worker, warmup,
  backpressure (:class:`ServerOverloaded`, :class:`RequestTimeout`),
  hot-swap with no capture (:meth:`ModelServer.swap_model`), drain;
- ``registry``: :class:`ModelRegistry`, named versioned snapshots with
  publish/rollback notification;
- ``policy``: windowed execution-latency prediction and SLO admission;
- ``fleet``: :class:`FleetServer`, N replicas (each with its own CUDA
  stream and graphs) behind least-loaded routing, SLO admission, rolling
  hot-swap and failover, and :func:`serve_while_training`;
- ``metrics``: per-batch spans and the serving counters;
- ``autoscale``: :class:`ReplicaAutoscaler`;
- ``loadtest``: :func:`replay_load_test`.

``FederatedFleet`` and its endpoints (fleets in several processes) wait
for ROADMAP.md queue 1, Execution and serving; the names raise
``NotImplementedError`` naming it.

Quick start::

    from dask_ml_tpu_torch.serving import FleetServer, ModelServer

    with ModelServer(fitted_clf,
                     methods=("predict", "predict_proba")).warmup() as srv:
        fut = srv.submit(x_small)        # Future
        proba = srv.predict_proba(x)     # blocking convenience

    with FleetServer(fitted_clf, replicas=2).warmup() as fleet:
        y = fleet.predict(x)
        fleet.publish(retrained_clf)     # rolling swap, no capture
"""

from ._buckets import BucketLadder
from ._server import (
    ModelServer,
    RequestTimeout,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    SloShed,
)
from .autoscale import ReplicaAutoscaler
from .fleet import FleetServer, NoHealthyReplicas, serve_while_training
from .loadtest import replay_load_test, synthesize_records
from .registry import (
    ModelRegistry,
    ModelVersion,
    RegistryError,
    UnknownModelError,
)

_LATER = ("FederatedFleet", "FleetEndpoint", "HttpEndpoint",
          "LocalEndpoint", "NoLiveProcesses", "ProcessDown")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md queue 1, Execution and "
            "serving (serving/federation.py)")
    raise AttributeError(name)


__all__ = [
    "BucketLadder",
    "FleetServer",
    "ModelRegistry",
    "ModelServer",
    "ModelVersion",
    "NoHealthyReplicas",
    "RegistryError",
    "ReplicaAutoscaler",
    "RequestTimeout",
    "ServerClosed",
    "ServerOverloaded",
    "ServingError",
    "SloShed",
    "UnknownModelError",
    "replay_load_test",
    "serve_while_training",
    "synthesize_records",
]
