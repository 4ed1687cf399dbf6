"""Fleet-scope metrics federation: one registry over N fleet processes.

Counterpart of ``dask_ml_tpu/observability/fleet.py``. A
:class:`~dask_ml_tpu_torch.serving.federation.FederatedFleet` routes one
request stream over N fleet processes, each with its own ``/metrics``
and ``/status``. A :class:`MetricsFederator` rides the router's status
poller (it starts no thread and reads no ``/status`` of its own: the
windowed quantiles behind ``stats()`` are consumed on read, so the
poller owns the one scrape a process an interval and hands the document
to both routing and this fold) and folds every process's telemetry into
one fleet view:

- **counters sum** across the fleet
  (``dask_ml_tpu_fleet_serving_requests_total`` is the sum of every
  process's ``serving_requests``);
- **gauges get a** ``{process=}`` **label**: queue depth, replica health
  and fit progress keep their process;
- **histograms merge bucket for bucket** (``_hist.merge_snapshots``):
  every serving histogram shares the fixed 1-2-5 ladder, so the fleet
  distribution is the exact bucket-wise sum.

The merged families render on the router's own ``/metrics`` under a
``dask_ml_tpu_fleet_`` prefix, and as a JSON block on ``/status`` and
``/status/fleet``, through ``live.register_fleet_provider``. Each
ingest replaces the whole set of documents, so a dead process's series
drop at the next scrape instead of freezing at their last value.

Fleet SLO burn rate: with ``config.serving_slo_ms`` set, each process
counts ``serving_slo_violations``; each ingest window's fleet-wide
violation share over :data:`SLO_BURN_BUDGET` is the burn rate. A window
burning faster than budget (rate > 1) notes one
``builtin:fleet_slo_burn`` event with the alert engine and latches it in
the fleet block's alert ring, which outlives the burn.

``config.obs_fleet_federate`` off (the default) builds no federator,
registers no provider and leaves the router's exposition unchanged; on,
a scrape stays host dicts: no device sync anywhere here.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ._hist import merge_snapshots, percentiles_from

__all__ = ["MetricsFederator", "SLO_BURN_BUDGET"]

# the fleet error budget: the violation share at which the burn rate
# reads 1.0 (99 % of requests inside the SLO)
SLO_BURN_BUDGET = 0.01

# alerts kept after they fire (latched: a subsiding burn never clears
# them)
_ALERT_KEEP = 8


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class MetricsFederator:
    """The fleet registry: ingests the per-process ``/status`` documents
    the federation poller cached (one scrape a process an interval) and
    renders the merged fleet families.

    ``ingest(snapshots)`` takes ``[(process_id, doc_or_None), ...]``,
    ``doc`` a process's full /status JSON (None: the process is dead
    this interval; its series drop at once). The live exporter calls
    :meth:`render_lines` (Prometheus lines appended to the router's
    /metrics) and :meth:`fleet_block` (the ``/status/fleet`` JSON).
    """

    def __init__(self, name="model", slo_ms=0.0, min_interval_s=0.0,
                 budget=SLO_BURN_BUDGET):
        self.name = str(name)
        self._slo_ms = float(slo_ms)
        self._min_interval = float(min_interval_s)
        self._budget = float(budget)
        self._lock = threading.Lock()
        self._docs: dict[str, dict] = {}
        self._t_ingest = 0.0            # monotonic, the throttle's clock
        self._t_unix = None             # wall clock of the last ingest
        self._scrape_s = None
        self._prev = None               # (violations, requests) totals
        self._burn = 0.0
        self._alerts: deque = deque(maxlen=_ALERT_KEEP)

    # -- ingest (rides the federation poller) -----------------------------
    def ingest(self, snapshots, scrape_s=None) -> bool:
        """Fold one poll interval's documents into the fleet view.
        False when throttled by ``config.obs_fleet_poll_s``; a dead
        process's series drop even on a throttled tick."""
        now = time.monotonic()
        with self._lock:
            if self._min_interval > 0 and self._t_ingest \
                    and now - self._t_ingest < self._min_interval:
                for pid, doc in snapshots:
                    if doc is None:
                        self._docs.pop(str(pid), None)
                return False
            self._t_ingest = now
            self._t_unix = time.time()
            if scrape_s is not None:
                self._scrape_s = float(scrape_s)
            # replaced, not updated: a process missing from this
            # interval's list (a retired endpoint) drops too
            self._docs = {str(pid): doc for pid, doc in snapshots
                          if doc is not None}
            viol = req = 0
            for doc in self._docs.values():
                ctr = doc.get("counters") or {}
                v, r = ctr.get("serving_slo_violations"), \
                    ctr.get("serving_requests")
                if _numeric(v):
                    viol += int(v)
                if _numeric(r):
                    req += int(r)
            if self._prev is not None:
                # deltas clamped at 0: a process death makes the fleet
                # totals fall, which is attrition, not recovery
                dv = max(viol - self._prev[0], 0)
                dr = max(req - self._prev[1], 0)
                self._burn = (dv / dr) / self._budget if dr > 0 else 0.0
                if self._burn > 1.0:
                    # the alert engine's ledger mints the crossing (at
                    # most one builtin:fleet_slo_burn firing each); the
                    # same record stays latched in this ring
                    from . import alerts as _obs_alerts

                    self._alerts.append(_obs_alerts.note_event(
                        "fleet_slo_burn", value=self._burn, meta={
                            "burn_rate": round(self._burn, 4),
                            "violations": dv,
                            "requests": dr,
                            "budget": self._budget,
                        }))
            self._prev = (viol, req)
        return True

    # -- merged views ------------------------------------------------------
    def _merged_locked(self):
        """(counters, gauges by family, histogram snapshots by key) over
        the live documents. The caller holds ``_lock``; all of it is
        fresh host data."""
        counters: dict[str, float] = {}
        gauges: dict[str, list] = {}
        hists: dict[tuple, dict] = {}
        for pid, doc in sorted(self._docs.items()):
            for k, v in (doc.get("counters") or {}).items():
                if _numeric(v):
                    counters[str(k)] = counters.get(str(k), 0) + v
            telem = doc.get("telemetry") or {}
            for name, labels, v in telem.get("gauges") or ():
                if not _numeric(v):
                    continue
                ls = tuple((str(k), str(val)) for k, val in labels)
                gauges.setdefault(str(name), []).append(
                    (ls + (("process", pid),), float(v)))
            for name, labels, snap in telem.get("histograms") or ():
                key = (str(name),
                       tuple((str(k), str(val)) for k, val in labels))
                try:
                    merged = merge_snapshots([hists.get(key), snap])
                except (ValueError, KeyError, TypeError):
                    # a mismatched ladder or a malformed document: skip
                    # the series, a scrape never fails over one process
                    continue
                if merged is not None:
                    hists[key] = merged
        return counters, gauges, hists

    def render_lines(self) -> list:
        """Prometheus lines for the merged fleet families, each under
        ``dask_ml_tpu_fleet_`` with one TYPE line (a histogram family
        shadows a gauge family of the same name, the exporter's rule)."""
        from .live import _PREFIX, _fmt, _labels_str, _merge_label, _san

        with self._lock:
            counters, gauges, hists = self._merged_locked()
            n_procs = len(self._docs)
            burn = self._burn
            n_alerts = len(self._alerts)
            scrape_s = self._scrape_s
        pre = f"{_PREFIX}fleet_"
        lines = []
        for name in sorted(counters):
            n = f"{pre}{_san(name)}_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_fmt(counters[name])}")
        hist_fams = {_san(name) for name, _ in hists}
        gauge_fams: dict[str, list] = {}
        for name, series in sorted(gauges.items()):
            if _san(name) not in hist_fams:
                gauge_fams[_san(name)] = series
        # the federator's own gauges join the same family map, so a
        # scraped gauge of the same name cannot add a second TYPE line
        gauge_fams.setdefault("processes", []).append(((), n_procs))
        gauge_fams.setdefault("slo_burn_rate", []).append(((), burn))
        gauge_fams.setdefault("slo_alerts", []).append(((), n_alerts))
        if scrape_s is not None:
            gauge_fams.setdefault("scrape_seconds", []).append(
                ((), scrape_s))
        for name, series in gauge_fams.items():
            n = f"{pre}{name}"
            lines.append(f"# TYPE {n} gauge")
            for labels, v in series:
                lines.append(f"{n}{_labels_str(labels)} {_fmt(v)}")
        hist_by_fam: dict[str, list] = {}
        for (name, labels) in sorted(hists):
            hist_by_fam.setdefault(_san(name), []).append(
                (labels, hists[(name, labels)]))
        for fam, series in hist_by_fam.items():
            n = f"{pre}{fam}"
            lines.append(f"# TYPE {n} histogram")
            for labels, snap in series:
                cum = 0
                for i, bound in enumerate(snap["bounds"]):
                    cum += snap["counts"][i]
                    lines.append(
                        f"{n}_bucket"
                        f"{_merge_label(labels, 'le', _fmt(bound))} {cum}")
                cum += snap["counts"][-1]
                lines.append(
                    f"{n}_bucket{_merge_label(labels, 'le', '+Inf')} {cum}")
                ls = _labels_str(labels)
                lines.append(f"{n}_sum{ls} {_fmt(snap['sum'])}")
                lines.append(f"{n}_count{ls} {snap['count']}")
        return lines

    def fleet_block(self) -> dict:
        """The ``/status/fleet`` JSON: the scraped processes, summed
        counters, merged histogram quantiles, and the SLO burn view with
        its latched alerts."""
        from .live import _labels_str

        with self._lock:
            counters, _, hists = self._merged_locked()
            pids = sorted(self._docs)
            burn = self._burn
            alerts = list(self._alerts)
            prev = self._prev
            scrape_s = self._scrape_s
            t_unix = self._t_unix
        hblock = {}
        for (name, labels), snap in sorted(hists.items()):
            pct = percentiles_from(snap, (50, 99))
            hblock[f"{name}{_labels_str(labels)}"] = {
                "count": snap["count"],
                "sum": round(snap["sum"], 6),
                "p50": None if pct["p50"] != pct["p50"]
                else round(pct["p50"], 6),
                "p99": None if pct["p99"] != pct["p99"]
                else round(pct["p99"], 6),
            }
        return {
            "federation": self.name,
            "processes": pids,
            "n_scraped": len(pids),
            "counters": counters,
            "histograms": hblock,
            "slo": {
                "slo_ms": self._slo_ms,
                "budget": self._budget,
                "violations": prev[0] if prev else 0,
                "requests": prev[1] if prev else 0,
                "burn_rate": round(burn, 4),
                "alerts": alerts,
            },
            "scrape_seconds": scrape_s,
            "t_scrape_unix": round(t_unix, 3) if t_unix else None,
        }
