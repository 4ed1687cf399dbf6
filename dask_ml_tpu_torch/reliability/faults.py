"""Deterministic, seeded fault injection.

Counterpart of ``dask_ml_tpu/reliability/faults.py``, with the same
grammar, sites, kinds and firing rule, so a plan string written for the
JAX package parses alike and fires at the same invocation indexes. Off
by default: with ``config.fault_plan`` unset a site costs one config
read and a branch.

A :class:`FaultPlan` arms named host-side SITES; each arm fires by the
site's **invocation index** (never wall clock), so a chaos run replays
exactly: the same code on the same data hits the same faults.

Plan grammar (``;``-separated arms)::

    site:kind@N          fire at the site's N-th invocation (0-based)
    site:kind@N*M        ... and the M-1 invocations after it
    site:kind@N+K        ... and every K-th invocation after it
    site:kind~P@S        fire with probability P, decided by
                         hash(seed S, site, index): deterministic replay
    site:kind@N/T        hang kinds sleep T seconds (default 60)

Sites, all host-side, and where the port fires them:

======================  =====================================================
``staging_read``        one host array read of a block in
                        ``BlockStream.blocks`` (the native reader's or
                        the positional copy), once per array
``stream_put``          the device-copy issue of a block
                        (``BlockStream.blocks``, ``stage``)
``superblock_dispatch`` the consumer-facing yield of each block
                        (``BlockStream.blocks``, ``emit``): the port has
                        no super-blocks, so ``N`` counts blocks here
``stream_put_sharded``  never fires yet: the per-shard slab put waits on
                        ROADMAP.md queue 1, Multi-GPU (feature sharding)
``pass_barrier``        the pass barrier of a multi-process streamed fit
                        (``distributed.sync_stream_pass``, once a pass,
                        inside its deadline): a ``hang`` there ends the
                        peers with ``StreamSyncTimeout``
``serving_execute``     a server's batch execute (``ModelServer._execute``
                        and ``_execute_sparse``, inside the batch guard):
                        a fault fails that batch's requests typed
                        (``ServingError``) and the worker lives on
``replica_worker``      the top of each turn of a server's worker loop
                        (``ModelServer._run_loop``), before a request is
                        popped: a crash ends the worker with the queue
                        intact, for ``ReplicaSupervisor`` to requeue
======================  =====================================================

Kinds: ``io`` (raises :class:`InjectedIOError`, an ``OSError``, so the
staging retry takes it for a flaky read), ``crash`` (raises
:class:`InjectedCrash`, never retried), ``nan`` (returns a poisoned COPY
of the payload; the source array is never touched), ``hang`` (sleeps).
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FAULT_SITES",
    "FaultInjected",
    "FaultPlan",
    "InjectedCrash",
    "InjectedIOError",
    "NonFiniteBlock",
    "StreamIORetriesExhausted",
    "active_plan",
    "fault_point",
    "fire_plan",
    "reset_plans",
]

FAULT_SITES = frozenset({
    "staging_read", "stream_put", "stream_put_sharded",
    "superblock_dispatch", "serving_execute", "replica_worker",
    "pass_barrier",
})
FAULT_KINDS = frozenset({"io", "crash", "nan", "hang"})


class FaultInjected(RuntimeError):
    """Base class for deliberately injected faults — chaos tests catch
    this to distinguish the injection from a real failure."""


class InjectedIOError(FaultInjected, OSError):
    """An injected transient IO failure: an ``OSError``, so the staging
    retry machinery treats it exactly like a real disk/reader hiccup."""


class InjectedCrash(FaultInjected):
    """An injected hard failure — NOT an OSError, so retry loops let it
    propagate (it models a process/thread death, not a flaky read)."""


class NonFiniteBlock(RuntimeError):
    """A streamed host block contained non-finite values and
    ``config.stream_nonfinite`` is ``"raise"``. Typed so out-of-core
    pipelines can quarantine-and-requeue at their own layer."""


class StreamIORetriesExhausted(OSError):
    """A staging read kept failing past ``config.stream_io_retries``
    bounded exponential-backoff attempts. Subclasses ``OSError`` so
    callers catching IO failures today still catch the typed form."""


class _Arm:
    __slots__ = ("site", "kind", "at", "times", "every", "rate", "seed",
                 "hang_s")

    def __init__(self, site, kind, at=0, times=1, every=0, rate=None,
                 seed=0, hang_s=60.0):
        self.site = site
        self.kind = kind
        self.at = int(at)
        self.times = int(times)
        self.every = int(every)
        self.rate = rate
        self.seed = int(seed)
        self.hang_s = float(hang_s)

    def fires(self, idx: int) -> bool:
        if self.rate is not None:
            # keyed hash of (seed, site, index): replays exactly for the
            # same invocation sequence, no RNG state to carry
            h = hashlib.sha1(
                f"{self.seed}|{self.site}|{idx}".encode()
            ).digest()
            return int.from_bytes(h[:8], "big") / 2.0 ** 64 < self.rate
        if idx < self.at:
            return False
        d = idx - self.at
        if self.every > 0:
            return d % self.every == 0 and d // self.every < self.times
        return d < self.times


def _parse_arm(text: str) -> _Arm:
    raw = text.strip()
    if ":" not in raw:
        raise ValueError(
            f"fault_plan arm {raw!r} needs 'site:kind[@N|~P@S]'"
        )
    site, rest = raw.split(":", 1)
    site = site.strip()
    if site not in FAULT_SITES:
        raise ValueError(
            f"fault_plan site {site!r} is unknown; sites: "
            f"{sorted(FAULT_SITES)}"
        )
    hang_s = 60.0
    if "/" in rest:
        rest, hs = rest.rsplit("/", 1)
        hang_s = float(hs)
    kw = {}
    if "~" in rest:
        kind, sched = rest.split("~", 1)
        if "@" in sched:
            p, seed = sched.split("@", 1)
            kw["seed"] = int(seed.lstrip("seed"))
        else:
            p = sched
        kw["rate"] = float(p)
        if not 0.0 < kw["rate"] <= 1.0:
            raise ValueError(
                f"fault_plan rate must be in (0, 1], got {kw['rate']}"
            )
    elif "@" in rest:
        kind, sched = rest.split("@", 1)
        if "*" in sched:
            at, times = sched.split("*", 1)
            kw["at"], kw["times"] = int(at), int(times)
        elif "+" in sched:
            at, every = sched.split("+", 1)
            kw["at"], kw["every"] = int(at), int(every)
            kw["times"] = 1 << 30
        else:
            kw["at"] = int(sched)
    else:
        kind = rest
    kind = kind.strip()
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"fault_plan kind {kind!r} is unknown; kinds: "
            f"{sorted(FAULT_KINDS)}"
        )
    return _Arm(site, kind, hang_s=hang_s, **kw)


class FaultPlan:
    """Parsed ``config.fault_plan``: per-site invocation counters plus
    the arms that decide which invocations fire. Counters are process-
    global per plan instance (one instance per distinct spec string —
    see :func:`active_plan`) so a fit's sites count monotonically across
    threads; the lock makes ``fire`` safe from any thread."""

    def __init__(self, arms):
        self.arms = tuple(arms)
        self._counts: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan | None":
        spec = (spec or "").strip()
        if not spec:
            return None
        return cls([_parse_arm(a) for a in spec.split(";") if a.strip()])

    def fire(self, site: str):
        """Advance ``site``'s invocation counter; return the firing
        ``(kind, arm)`` or None. At most one arm fires per invocation
        (first match in spec order)."""
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
            for arm in self.arms:
                if arm.site == site and arm.fires(idx):
                    self._fired[site] = self._fired.get(site, 0) + 1
                    return arm
        return None

    def snapshot(self) -> dict:
        """Per-site invocation/fired counts — the /status reliability
        block's view of where the plan stands."""
        with self._lock:
            return {
                s: {"invocations": n, "fired": self._fired.get(s, 0)}
                for s, n in sorted(self._counts.items())
            }


# one plan INSTANCE per distinct spec string: counters must persist
# across call sites and threads for index-based schedules to mean
# anything. reset_plans() gives tests a clean slate.
_plans: dict[str, FaultPlan] = {}
_plans_lock = threading.Lock()


def active_plan() -> FaultPlan | None:
    """The FaultPlan for the current config's ``fault_plan`` spec (None
    when unset — the zero-overhead path is one config read + branch)."""
    from ..config import get_config

    spec = get_config().fault_plan
    if not spec:
        return None
    plan = _plans.get(spec)
    if plan is None:
        with _plans_lock:
            plan = _plans.get(spec)
            if plan is None:
                plan = _plans[spec] = FaultPlan.parse(spec)
    return plan


def reset_plans() -> None:
    """Forget every armed plan's counters (test isolation: the same
    spec string in a second test must start its schedule at index 0)."""
    with _plans_lock:
        _plans.clear()


def fault_point(site: str, payload=None):
    """One named host-side fault site. Returns ``payload`` (possibly a
    poisoned COPY under a ``nan`` arm) or raises the armed fault. With
    ``config.fault_plan`` unset this is one config read and a branch."""
    from ..config import get_config

    return fire_plan(get_config().fault_plan, site, payload)


def fire_plan(spec: str, site: str, payload=None):
    """:func:`fault_point` against an EXPLICIT plan spec: ``BlockStream``
    captures its spec once, at construction, as the thread-local config
    of a later caller may differ."""
    if not spec:
        return payload
    plan = _plans.get(spec)
    if plan is None:
        with _plans_lock:
            plan = _plans.get(spec)
            if plan is None:
                plan = _plans[spec] = FaultPlan.parse(spec)
    arm = plan.fire(site)
    if arm is None:
        return payload
    from ..observability._counters import record_fault_injected

    record_fault_injected(site, arm.kind)
    if arm.kind == "io":
        raise InjectedIOError(
            f"fault_plan: injected IO fault at site {site!r}"
        )
    if arm.kind == "crash":
        raise InjectedCrash(
            f"fault_plan: injected crash at site {site!r}"
        )
    if arm.kind == "hang":
        time.sleep(arm.hang_s)
        return payload
    # "nan": poison a COPY — the payload may be a view of user data /
    # a zero-copy staging alias, which must never be mutated in place
    if payload is not None:
        try:
            poisoned = np.array(payload, copy=True)
            flat = poisoned.reshape(-1)
            flat[: max(1, flat.size // 64)] = np.nan
            return poisoned
        except Exception:
            return payload
    return payload
