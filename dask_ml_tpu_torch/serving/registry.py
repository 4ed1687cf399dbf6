"""Versioned model registry: the serving fleet's source of truth for
WHAT is being served.

Counterpart of ``dask_ml_tpu/serving/registry.py``:

- :meth:`ModelRegistry.publish` stores a deep-copied snapshot of a
  fitted estimator under ``(name, version)`` and notifies subscribers
  (the FleetServer's swap hook). The copy matters for
  serve-while-training: ``Incremental``'s ``partial_fit`` keeps mutating
  its estimator between passes;
- :meth:`ModelRegistry.rollback` re-points ``current`` at an archived
  version and notifies subscribers the same way (a rollback IS a swap);
- history is bounded (``config.serving_registry_keep``); the current
  version is never evicted.

Thread-safe; subscriber callbacks run on the publishing thread, outside
the registry lock, and a callback error never poisons the publish: it is
re-raised to the publisher after every subscriber ran.
"""

from __future__ import annotations

import copy
import threading
import time

from . import metrics as smetrics

__all__ = ["ModelRegistry", "ModelVersion", "RegistryError",
           "UnknownModelError"]


class RegistryError(KeyError):
    """Base class for registry lookup failures."""


class UnknownModelError(RegistryError):
    """No such model name / version in this registry."""


class ModelVersion:
    """One immutable published snapshot: ``estimator`` plus identity,
    the publisher (thread name unless given), and the estimator's
    per-feature training profile (``training_profile_``), archived with
    the version."""

    __slots__ = ("name", "version", "estimator", "t_publish", "tag",
                 "publisher", "profile", "quantize")

    def __init__(self, name, version, estimator, tag=None,
                 publisher=None, quantize=None):
        self.name = name
        self.version = int(version)
        self.estimator = estimator
        self.t_publish = time.time()
        self.tag = tag
        self.publisher = str(publisher) if publisher is not None \
            else threading.current_thread().name
        self.profile = getattr(estimator, "training_profile_", None)
        # serving precision flavour of this version (None = float32,
        # "int8"): subscribers serve it through the matching pre-warmed
        # flavour, so flipping f32 <-> int8 is an ordinary swap
        self.quantize = quantize

    def __repr__(self):
        tag = f", tag={self.tag!r}" if self.tag else ""
        return f"ModelVersion({self.name!r}, v{self.version}{tag})"


class ModelRegistry:
    """Named, versioned fitted-model store with publish/rollback
    notification.

    ``keep`` bounds per-name history (default from
    ``config.serving_registry_keep``); versions number from 1 and never
    reuse ids — a rollback re-points ``current`` without minting a new
    version, so audit trails stay monotonic.
    """

    def __init__(self, keep=None):
        from ..config import get_config

        self.keep = int(get_config().serving_registry_keep
                        if keep is None else keep)
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        self._lock = threading.Lock()
        self._models: dict[str, dict[int, ModelVersion]] = {}
        self._current: dict[str, int] = {}
        self._next: dict[str, int] = {}
        self._subs: dict[str, list] = {}
        # list this registry in the live plane (weakly referenced)
        from ..observability.live import register_registry

        register_registry(self)

    # -- write plane -------------------------------------------------------
    def publish(self, name, estimator, tag=None, snapshot=True,
                publisher=None, quantize=None, version=None) -> int:
        """Store ``estimator`` as the next version of ``name``, make it
        current, notify subscribers. Returns the new version id.
        ``publisher`` labels the version (defaults to the publishing
        thread's name). ``quantize="int8"`` flags the version for the
        weight-quantized flavour: subscribers swap it in through their
        pre-warmed int8 entry points (per-channel scales computed at
        swap time from this snapshot's weights).

        ``version`` PINS the version id instead of minting the next one
        (re-publishing an id this registry holds overwrites that slot);
        the local counter advances past any pinned id.

        ``snapshot=True`` (default) deep-copies the estimator so later
        in-place training (``partial_fit``) cannot mutate the archive;
        pass False only for estimators the caller promises never to
        touch again."""
        est = copy.deepcopy(estimator) if snapshot else estimator
        with self._lock:
            if version is None:
                version = self._next.get(name, 1)
            else:
                version = int(version)
                if version < 1:
                    raise ValueError(
                        f"pinned version must be >= 1, got {version}")
            self._next[name] = max(self._next.get(name, 1),
                                   version + 1)
            mv = ModelVersion(name, version, est, tag=tag,
                              publisher=publisher, quantize=quantize)
            versions = self._models.setdefault(name, {})
            versions[version] = mv
            self._current[name] = version
            self._evict_locked(name)
            subs = list(self._subs.get(name, ()))
        smetrics.record_publish()
        self._publish_gauge(name, version)
        self._notify(subs, mv)
        return version

    def rollback(self, name, version=None) -> int:
        """Re-point ``name``'s current at an ARCHIVED version (default:
        the one just before current) and notify subscribers — the
        operator's bad-push escape hatch. Returns the now-current
        version id."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(name)
            cur = self._current[name]
            if version is None:
                older = [v for v in sorted(versions) if v < cur]
                if not older:
                    raise UnknownModelError(
                        f"{name}: no version older than current v{cur} "
                        "to roll back to"
                    )
                version = older[-1]
            version = int(version)
            if version not in versions:
                raise UnknownModelError(
                    f"{name}: version {version} not in registry "
                    f"(kept: {sorted(versions)})"
                )
            self._current[name] = version
            mv = versions[version]
            subs = list(self._subs.get(name, ()))
        smetrics.record_publish(rollback=True)
        self._publish_gauge(name, version)
        self._notify(subs, mv)
        return version

    def _evict_locked(self, name):
        versions = self._models[name]
        cur = self._current[name]
        for v in sorted(versions):
            if len(versions) <= self.keep:
                break
            if v != cur:
                del versions[v]

    @staticmethod
    def _publish_gauge(name, version):
        from ..observability.live import gauge_set, live_publishing

        if live_publishing():
            gauge_set("registry_version", int(version),
                      (("model", str(name)),))

    def _notify(self, subs, mv):
        first_exc = None
        for cb in subs:
            try:
                cb(mv)
            except Exception as exc:  # every subscriber still runs
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc

    # -- read plane --------------------------------------------------------
    def get(self, name, version=None) -> ModelVersion:
        """The current (or an explicit archived) version of ``name``."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(name)
            v = self._current[name] if version is None else int(version)
            mv = versions.get(v)
            if mv is None:
                raise UnknownModelError(
                    f"{name}: version {v} not in registry "
                    f"(kept: {sorted(versions)})"
                )
            return mv

    def current_version(self, name) -> int:
        with self._lock:
            if name not in self._current:
                raise UnknownModelError(name)
            return self._current[name]

    def versions(self, name) -> tuple:
        """Kept version ids for ``name`` (ascending); empty tuple for an
        unknown name."""
        with self._lock:
            return tuple(sorted(self._models.get(name, ())))

    def names(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._models))

    def status_snapshot(self) -> dict:
        """{name: {current, versions, t_publish, publisher, tag,
        quantize}}: what is serving, what is archived, who pushed it and
        when."""
        out = {}
        with self._lock:
            for name, versions in self._models.items():
                cur = self._current.get(name)
                mv = versions.get(cur)
                out[name] = {
                    "current": cur,
                    "versions": sorted(versions),
                    "t_publish": round(mv.t_publish, 3) if mv else None,
                    "publisher": mv.publisher if mv else None,
                    "tag": mv.tag if mv else None,
                    "quantize": mv.quantize if mv else None,
                }
        return out

    # -- subscription ------------------------------------------------------
    def subscribe(self, name, callback):
        """``callback(ModelVersion)`` fires on every publish/rollback of
        ``name`` — how a fleet follows a model. If the name already has
        a current version the callback fires immediately with it (a
        late-joining fleet must not serve stale params until the next
        publish)."""
        with self._lock:
            self._subs.setdefault(name, []).append(callback)
            cur = self._current.get(name)
            mv = self._models[name][cur] if cur is not None else None
        if mv is not None:
            callback(mv)
        return callback

    def unsubscribe(self, name, callback):
        with self._lock:
            subs = self._subs.get(name, [])
            if callback in subs:
                subs.remove(callback)
