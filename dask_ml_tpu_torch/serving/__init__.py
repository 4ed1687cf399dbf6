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
- ``federation``: :class:`FederatedFleet`, one request stream routed
  over N fleet processes by predicted completion, whole-request failover
  when a process dies (:class:`ProcessDown`, :class:`NoLiveProcesses`),
  version-pinned publish fan-out, over :class:`LocalEndpoint` (a fleet
  in this process) or :class:`HttpEndpoint` (another process's exporter,
  ``POST /fleet/<name>/<op>``);
- ``metrics``: per-batch spans and the serving counters;
- ``autoscale``: :class:`ReplicaAutoscaler`;
- ``loadtest``: :func:`replay_load_test`.

Quick start::

    from dask_ml_tpu_torch.serving import FleetServer, ModelServer

    with ModelServer(fitted_clf,
                     methods=("predict", "predict_proba")).warmup() as srv:
        fut = srv.submit(x_small)        # Future
        proba = srv.predict_proba(x)     # blocking convenience

    with FleetServer(fitted_clf, replicas=2).warmup() as fleet:
        y = fleet.predict(x)
        fleet.publish(retrained_clf)     # rolling swap, no capture

    with FederatedFleet([url0, url1], name="model") as fed:
        y = fed.predict(x)               # routed over two processes
        fed.publish(retrained_clf)       # fanned out to both
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
from .federation import (
    FederatedFleet,
    FleetEndpoint,
    HttpEndpoint,
    LocalEndpoint,
    NoLiveProcesses,
    ProcessDown,
)
from .fleet import FleetServer, NoHealthyReplicas, serve_while_training
from .loadtest import replay_load_test, synthesize_records
from .registry import (
    ModelRegistry,
    ModelVersion,
    RegistryError,
    UnknownModelError,
)

__all__ = [
    "BucketLadder",
    "FederatedFleet",
    "FleetEndpoint",
    "FleetServer",
    "HttpEndpoint",
    "LocalEndpoint",
    "ModelRegistry",
    "ModelServer",
    "ModelVersion",
    "NoHealthyReplicas",
    "NoLiveProcesses",
    "ProcessDown",
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
