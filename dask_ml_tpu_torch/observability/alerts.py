"""The alert engine: declarative host-side rules over the live registry.

Counterpart of ``dask_ml_tpu/observability/alerts.py``:

- **declarative rules** (``config.obs_alert_rules``, "," or ";"
  separated)::

      serving_slo_violations:rate>5/60s    counter delta per window
      drift_score_max:gauge>0.2            worst series of the family
      fit_eta_seconds:gauge>1800           (ops: > < >= <=)

  evaluated by ONE ticker thread over the counter and gauge snapshots:
  host dicts, no device sync;
- **built-in rules**, always there once the engine is armed:
  ``builtin:watchdog_stall`` (fed by the watchdog's stall report),
  ``builtin:graph_captures`` (a CUDA graph captured after the engine's
  first evaluation: the serving plane's post-warmup tripwire, where the
  JAX package watches fresh XLA compiles, ``builtin:recompiles``),
  ``builtin:fleet_slo_burn`` (fed by the fleet federation's burn rate,
  ``fleet.MetricsFederator``), ``builtin:drift`` (fed by the drift engine's
  below-to-above crossings) and ``builtin:typed_error`` (fed by typed
  serving and streaming failures);
- a **firing/resolved state machine** per rule with hysteresis: a rule
  fires on its first breaching evaluation and resolves after
  ``CLEAR_TICKS`` clean ones in a row (event rules after
  ``EVENT_RESOLVE_TICKS`` intervals without a new event);
- ``alerts_firing{rule=}`` gauges, ``alerts_fired`` / ``alerts_resolved``
  counters, JSONL ``alert`` transition records through the ambient trace
  sink, the ``/alerts`` endpoint and the ``alerts`` block of ``/status``
  and of the report;
- every transition to firing captures an incident bundle
  (:mod:`.incidents`): rate-limited, bounded, atomic.

The engine starts when ``obs_alert_rules`` is non-empty OR
``incident_dir`` is set (the built-ins alone in the latter case), through
:func:`ensure_engine` on the exporter's entry paths. Both knobs at their
"" defaults: no engine object, no ticker thread, and each
``note_event`` one module-global check.

One crossing, one event: the drift latch routes through
:func:`note_event`, which returns the event record, and drives at most
one firing transition; the built-in rules are purely event-driven, so a
crossing is never counted twice.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

from ._counters import counter_add, counters_enabled, counters_snapshot

__all__ = [
    "AlertRule", "AlertRuleError", "AlertEngine", "parse_rules",
    "ensure_engine", "engine", "stop_engine", "note_event",
    "note_error", "events", "alerts_data", "reset",
]

# consecutive clean evaluations before a firing polled rule resolves
# (hysteresis: one good tick between two bad ones must not flap)
CLEAR_TICKS = 2
# tick intervals an event rule stays firing after its LAST event
EVENT_RESOLVE_TICKS = 3
# transition ring (firing/resolved history on /alerts)
_TRANSITION_KEEP = 64
# passive event ledger (works with OR without an engine — the drift /
# fleet / watchdog crossings land here either way, replacing the old
# private deques as the one creation point)
_EVENT_KEEP = 64

_OPS = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
}

_GRAMMAR = (
    "accepted forms: '<counter>:rate<op><N>/<W>s' (counter delta <op> N "
    "per W-second window, e.g. 'serving_slo_violations:rate>5/60s'), "
    "'<gauge>:gauge<op><X>' (worst series of the gauge family, e.g. "
    "'drift_score_max:gauge>0.2'), '<counter>:counter<op><N>' (absolute "
    "total); ops: > < >= <=; several rules join with ',' or ';'; the "
    "special value 'builtin' arms only the built-in rules"
)

_RULE_RE = re.compile(
    r"^(?P<metric>[A-Za-z_][A-Za-z0-9_]*)"
    r":(?P<kind>rate|gauge|counter)"
    r"(?P<op>>=|<=|>|<)"
    r"(?P<value>[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"(?:/(?P<window>\d+(?:\.\d+)?)s)?$"
)


class AlertRuleError(ValueError):
    """A rule spec the grammar rejects — the message always carries the
    full accepted-forms vocabulary so the config error is
    self-documenting."""

    def __init__(self, spec, why):
        super().__init__(
            f"bad alert rule {spec!r}: {why}; {_GRAMMAR}"
        )
        self.spec = spec


class AlertRule:
    """One parsed rule + its firing/resolved state machine. ``kind`` is
    ``rate`` (counter delta over a trailing window), ``gauge`` (worst
    current series of the family), ``counter`` (absolute total) or
    ``event`` (built-in, fed by :func:`note_event`)."""

    def __init__(self, metric, kind, op, threshold, window_s=None,
                 name=None, builtin=False):
        self.metric = metric
        self.kind = kind
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s) if window_s else None
        self.name = name or f"{metric}:{kind}{op}{threshold}" + (
            f"/{window_s:g}s" if window_s else ""
        )
        self.builtin = builtin
        # state machine
        self.state = "ok"
        self.since = None           # unix time of the last transition
        self.value = None           # last evaluated / event value
        self.fired_total = 0
        self._clean_ticks = 0
        self._samples: deque = deque()   # (t, counter_total) for rate
        self._last_event_t = None        # event rules: freshness clock

    def _breach(self, value) -> bool:
        return _OPS[self.op](value, self.threshold)

    def evaluate(self, now, counters, gauges):
        """One polled evaluation → "firing"/"resolved"/None transition.
        Event rules only age out here (they fire inside
        :meth:`AlertEngine.notify`, at event time)."""
        if self.kind == "event":
            if self.state == "firing" and self._last_event_t is not None \
                    and now - self._last_event_t > self._resolve_after:
                return self._to_ok(now)
            return None
        if self.kind == "gauge":
            series = [v for (n, _ls), v in gauges.items()
                      if n == self.metric]
            if not series:
                return self._tick_ok(now)   # no data = not breaching
            # the WORST value for this op direction: any one series
            # over a ">" line (or under a "<" line) breaches the family
            value = max(series) if self.op in (">", ">=") else min(series)
        elif self.kind == "counter":
            value = counters.get(self.metric)
            if not isinstance(value, (int, float)):
                return self._tick_ok(now)
            value = float(value)
        else:  # rate
            total = counters.get(self.metric)
            if not isinstance(total, (int, float)):
                return self._tick_ok(now)
            total = float(total)
            self._samples.append((now, total))
            # keep one sample older than the window so the delta spans
            # the FULL window, not window-minus-one-tick
            while len(self._samples) > 1 \
                    and now - self._samples[1][0] >= self.window_s:
                self._samples.popleft()
            if len(self._samples) < 2:
                return self._tick_ok(now)   # first sample = baseline:
                # captures/violations from BEFORE the engine armed
                # (warmup) can never fire a rate rule
            value = max(total - self._samples[0][1], 0.0)
        self.value = value
        if self._breach(value):
            self._clean_ticks = 0
            if self.state != "firing":
                self.state = "firing"
                self.since = now
                self.fired_total += 1
                return "firing"
            return None
        return self._tick_ok(now)

    def _tick_ok(self, now):
        """One clean evaluation; resolves only past the hysteresis."""
        if self.state != "firing":
            return None
        self._clean_ticks += 1
        if self._clean_ticks >= CLEAR_TICKS:
            return self._to_ok(now)
        return None

    def _to_ok(self, now):
        self.state = "ok"
        self.since = now
        self._clean_ticks = 0
        return "resolved"

    def fire_event(self, now, value):
        """An event landed for this rule (engine lock held). Returns
        "firing" on the ok→firing transition, None while already
        firing (the event just refreshes the age-out clock)."""
        self._last_event_t = now
        self.value = value
        if self.state != "firing":
            self.state = "firing"
            self.since = now
            self.fired_total += 1
            return "firing"
        return None

    @property
    def _resolve_after(self):
        return EVENT_RESOLVE_TICKS * (self._interval or 1.0)

    _interval = None  # set by the owning engine

    def row(self) -> dict:
        """One table-ready row (the /status + report ``alerts``
        shape)."""
        return {
            "rule": self.name, "kind": self.kind, "metric": self.metric,
            "op": self.op if self.kind != "event" else None,
            "threshold": self.threshold if self.kind != "event" else None,
            "window_s": self.window_s,
            "state": self.state,
            "value": (round(self.value, 6)
                      if isinstance(self.value, float) else self.value),
            "since": round(self.since, 3) if self.since else None,
            "fired": self.fired_total,
            "builtin": self.builtin,
        }


def parse_rules(spec: str):
    """``config.obs_alert_rules`` → list of :class:`AlertRule`. Raises
    :class:`AlertRuleError` (a ``ValueError``) on anything outside the
    grammar, with the accepted-forms vocabulary in the message."""
    rules = []
    for part in re.split(r"[,;]", spec or ""):
        part = part.strip()
        if not part or part == "builtin":
            continue  # "builtin" arms the engine with built-ins only
        m = _RULE_RE.match(part)
        if m is None:
            if ":" not in part:
                raise AlertRuleError(part, "missing ':<kind>' separator")
            kind = part.split(":", 1)[1]
            if not re.match(r"^(rate|gauge|counter)", kind):
                raise AlertRuleError(
                    part, "kind must be rate, gauge or counter"
                )
            raise AlertRuleError(part, "unparseable op/threshold/window")
        kind = m.group("kind")
        window = m.group("window")
        if kind == "rate" and window is None:
            raise AlertRuleError(
                part, "rate rules need a '/<W>s' window"
            )
        if kind != "rate" and window is not None:
            raise AlertRuleError(
                part, f"'/{window}s' windows only apply to rate rules"
            )
        if window is not None and float(window) <= 0:
            raise AlertRuleError(part, "window must be > 0 seconds")
        rules.append(AlertRule(
            m.group("metric"), kind, m.group("op"),
            float(m.group("value")), float(window) if window else None,
        ))
    return rules


def _builtin_rules():
    """The always-on rules once the engine is armed. Event rules carry
    no threshold — their sources (watchdog / federator / drift /
    reliability hook) already decided the crossing; the engine owns the
    state machine and dedupe."""
    return [
        AlertRule("watchdog_stalls", "event", ">", 0.0,
                  name="builtin:watchdog_stall", builtin=True),
        # post-warmup graph captures: a rate rule's first sample is its
        # baseline, so captures from before the engine armed (warmup)
        # never count; any CUDA graph captured after that fires
        AlertRule("graph_captures", "rate", ">", 0.0, window_s=60.0,
                  name="builtin:graph_captures", builtin=True),
        AlertRule("fleet_slo_burn", "event", ">", 1.0,
                  name="builtin:fleet_slo_burn", builtin=True),
        AlertRule("drift_alerts", "event", ">", 0.0,
                  name="builtin:drift", builtin=True),
        AlertRule("typed_errors", "event", ">", 0.0,
                  name="builtin:typed_error", builtin=True),
    ]


# event name (note_event's first arg) -> built-in rule name
_EVENT_RULES = {
    "watchdog_stall": "builtin:watchdog_stall",
    "fleet_slo_burn": "builtin:fleet_slo_burn",
    "drift": "builtin:drift",
    "typed_error": "builtin:typed_error",
}


class AlertEngine:
    """The single ticker: every ``interval_s`` it snapshots the counter
    and gauge registries (host dicts: the evaluation never touches the
    card) and advances every rule's state machine. Owns the
    transition ring, the ``alerts_firing`` gauges, and the capture
    hand-off to :mod:`.incidents`."""

    def __init__(self, rules, interval_s, cfg=None):
        self.rules = list(rules)
        self.interval_s = max(float(interval_s), 0.05)
        for r in self.rules:
            r._interval = self.interval_s
        self._by_name = {r.name: r for r in self.rules}
        if cfg is None:
            from ..config import get_config

            cfg = get_config()
        self._cfg = cfg
        self._lock = threading.Lock()
        self._transitions: deque = deque(maxlen=_TRANSITION_KEEP)
        self._stop = threading.Event()
        self._thread = None
        self._t_start = time.time()
        self.ticks = 0

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dask-ml-tpu-torch-alerts", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(5.0)
        self._thread = None

    def _run(self):
        from .. import config as _config

        # the ticker must see the ARMING caller's thread-local config
        # (trace sink, incident_dir, thresholds), as the drift monitor
        # and the watchdog do
        with _config.use(self._cfg):
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the engine must never die mid-run

    # -- evaluation -------------------------------------------------------
    def tick(self, now=None):
        """One evaluation pass; returns the transitions it caused as
        ``[(rule, "firing"|"resolved"), ...]`` (tests drive this
        directly)."""
        from .live import gauges_snapshot

        now = time.time() if now is None else now
        counters = counters_snapshot()
        gauges = gauges_snapshot()
        out = []
        with self._lock:
            for rule in self.rules:
                tr = rule.evaluate(now, counters, gauges)
                if tr is not None:
                    out.append((rule, tr))
            self.ticks += 1
        for rule, tr in out:
            self._on_transition(rule, tr, now)
        return out

    def notify(self, event: str, value, meta) -> None:
        """An external crossing (watchdog / federator / drift /
        reliability hook) — drives the matching event rule NOW, at
        event time, so incident capture sees the freshest context."""
        name = _EVENT_RULES.get(event)
        rule = self._by_name.get(name) if name else None
        if rule is None:
            return
        now = time.time()
        with self._lock:
            tr = rule.fire_event(now, value)
        if tr is not None:
            self._on_transition(rule, tr, now, meta=meta)

    def _on_transition(self, rule, transition, now, meta=None):
        from .live import gauge_set

        firing = transition == "firing"
        gauge_set("alerts_firing", 1.0 if firing else 0.0,
                  (("rule", rule.name),))
        if counters_enabled():
            counter_add("alerts_fired" if firing else "alerts_resolved",
                        1)
        rec = {
            "alert": True, "rule": rule.name, "kind": rule.kind,
            "metric": rule.metric, "state": transition,
            "value": rule.value, "t_unix": round(now, 6),
        }
        if meta:
            rec.update({k: v for k, v in meta.items()
                        if k not in rec})
        with self._lock:
            self._transitions.append(rec)
        _emit(rec)
        if firing:
            try:
                from . import incidents

                incidents.capture_incident(
                    reason=f"alert:{rule.name}", rule=rule.name,
                    meta=meta, cfg=self._cfg,
                )
            except Exception:
                pass  # capture failures never break evaluation

    # -- read surfaces ----------------------------------------------------
    def rows(self):
        with self._lock:
            return [r.row() for r in self.rules]

    def data(self) -> dict:
        with self._lock:
            rows = [r.row() for r in self.rules]
            transitions = list(self._transitions)
        return {
            "armed": True,
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "t_start_unix": round(self._t_start, 3),
            "rules": rows,
            "firing": [r["rule"] for r in rows if r["state"] == "firing"],
            "transitions": transitions,
            "events": events(),
        }


def _emit(rec) -> None:
    """One JSONL record through the ambient trace sink (the drift
    engine's idiom) — the report CLI's alerts table reads these."""
    try:
        from ._spans import _trace_sink

        sink = _trace_sink()
        if sink is not None:
            sink.log(**rec)
    except Exception:
        pass


# -- passive event ledger + module singleton ---------------------------------

_events: deque = deque(maxlen=_EVENT_KEEP)
_events_lock = threading.Lock()
_engine: AlertEngine | None = None
_engine_lock = threading.Lock()


def note_event(event: str, value=None, meta=None) -> dict:
    """Record one crossing from another subsystem (drift latch, fleet
    burn, watchdog stall, reliability typed error) and drive the
    matching built-in rule when an engine is armed. Returns the event
    record so legacy surfaces (the federator's alert deque) can keep
    holding the SAME object — one crossing, one record, at most one
    firing transition."""
    rec = {"event": str(event), "t_unix": round(time.time(), 3)}
    if value is not None:
        try:
            rec["value"] = round(float(value), 6)
        except (TypeError, ValueError):
            rec["value"] = value
    if meta:
        rec.update({k: v for k, v in dict(meta).items()
                    if k not in rec})
    with _events_lock:
        _events.append(rec)
    eng = _engine
    if eng is not None:
        try:
            eng.notify(event, rec.get("value"), meta)
        except Exception:
            pass
    return rec


def note_error(exc, site: str) -> None:
    """The reliability opt-in hook: a typed error surfaced on an error
    path (serving batch failure, streaming retries exhausted). One
    module-global check when nothing is armed; with an engine it drives
    ``builtin:typed_error`` and captures an incident."""
    if _engine is None and not _armed_by_config():
        return
    note_event("typed_error", value=1.0,
               meta={"error": type(exc).__name__, "site": str(site),
                     "detail": str(exc)[:200]})


def events(event=None) -> list:
    """The crossing ledger, oldest first (``event`` filters by
    source)."""
    with _events_lock:
        out = list(_events)
    if event is not None:
        out = [r for r in out if r.get("event") == event]
    return out


def _armed_by_config(cfg=None) -> bool:
    from ..config import get_config

    cfg = cfg or get_config()
    return bool(str(cfg.obs_alert_rules).strip()) \
        or bool(str(cfg.incident_dir).strip())


def engine() -> AlertEngine | None:
    """The live singleton engine, or None."""
    return _engine


def ensure_engine(cfg=None) -> AlertEngine | None:
    """Start the process-wide engine if the config asks for one
    (``obs_alert_rules`` non-empty OR ``incident_dir`` set) and none is
    running. Idempotent; called from the same hot-path entries as
    ``live.ensure_telemetry`` — with both knobs at their "" defaults
    this is one None check + one config read, and a bad rule spec
    raises the typed :class:`AlertRuleError` into the arming caller
    (config errors must not be swallowed by a daemon)."""
    global _engine
    if _engine is not None:
        return _engine
    from ..config import get_config

    cfg = cfg or get_config()
    if not _armed_by_config(cfg):
        return None
    with _engine_lock:
        if _engine is not None:
            return _engine
        rules = parse_rules(cfg.obs_alert_rules)
        rules.extend(_builtin_rules())
        eng = AlertEngine(rules, cfg.obs_alert_interval_s, cfg=cfg)
        eng.start()
        _engine = eng
    return _engine


def stop_engine() -> None:
    """Stop the singleton (tests / graceful shutdown)."""
    global _engine
    with _engine_lock:
        eng, _engine = _engine, None
    if eng is not None:
        eng.stop()


def alerts_data() -> dict:
    """The ``/alerts`` JSON document (and the /status ``alerts``
    block): engine state when armed, just the passive event ledger
    when not."""
    eng = _engine
    if eng is not None:
        return eng.data()
    return {"armed": False, "rules": [], "firing": [],
            "transitions": [], "events": events()}


def reset() -> None:
    """Stop the engine and clear the ledger — test isolation."""
    stop_engine()
    with _events_lock:
        _events.clear()
