"""Chrome-trace / Perfetto export of recorded span JSONL.

Counterpart of ``dask_ml_tpu/observability/export.py`` (pure functions
over records: either package's files convert alike).
``python -m dask_ml_tpu_torch.observability.report trace.jsonl --perfetto
out.json`` converts a recorded run into the Chrome trace-event JSON
format, viewable in ``ui.perfetto.dev`` (or ``chrome://tracing``):

- span records become complete ("X") track events, laned by the thread
  that closed them (span trees nest by containment, exactly how the
  span stack produced them); a merged multi-process input (``report
  --merge``) lanes by (pid, thread) — the pid rides each span id's
  high bits;
- per-span counter deltas (``ctr_*``) become cumulative counter ("C")
  tracks — program FLOPs, h2d bytes, recompiles over time;
- explicit counter snapshots (``log_counters`` records) set the same
  tracks to their absolute totals;
- per-step solver records contribute ``<component>.<metric>`` counter
  tracks (loss / inertia / residual trajectories on the timeline);
- watchdog stall records become instant ("i") events so a stall dump is
  visible at the moment it fired; alert-firing transitions and incident
  captures (``observability/alerts.py``/``incidents.py``) lane the same
  way, so "what was running when the pager went off" is one glance;
- sampled request traces (``req_trace`` records) become per-stage "X"
  slices — queue wait on the admission thread's lane, pack/execute/
  demux on the worker's — linked by flow events ("s"/"f") sharing the
  pid-prefixed trace id, so a request is drawn hopping threads from
  admission to completion.

Timestamps: span records carry absolute ``t_unix``; step records only
carry the sink-relative ``time``. The exporter estimates each sink's
origin PER COMPONENT as the median of (t_unix - time) over span records
carrying both (each fit's MetricsLogger has its own zero-point), with a
global-median fallback, so mixed records land on one consistent
timeline (microsecond ts relative to the earliest event).
"""

from __future__ import annotations

import json

# step-record metrics worth a counter track (same preference list the
# report's convergence column reads)
_STEP_KEYS = ("loss", "inertia", "center_shift2", "primal_residual",
              "score", "opt_residual", "grad_norm")

# span attributes that are structural, not user payload
_SPAN_META = {"span", "span_id", "parent_id", "depth", "time", "t_unix",
              "wall_s", "sync_s", "thread"}

# request-trace stage order (mirrors observability/_requests.STAGES)
# and the names of the consecutive stage-pair slices
_REQ_STAGES = ("admit", "queue_pop", "pack", "dispatch", "execute_done",
               "demux", "complete")
_REQ_DUR = {
    ("admit", "queue_pop"): "queue_wait",
    ("queue_pop", "pack"): "pack",
    ("pack", "dispatch"): "dispatch",
    ("dispatch", "execute_done"): "execute",
    ("execute_done", "demux"): "demux",
    ("demux", "complete"): "resolve",
}


def _origins(records):
    """Per-component estimates of each sink's t=0 (median of
    t_unix - time over span records carrying both), plus a global
    fallback under the ``None`` key. Per-component because one JSONL
    file can hold records from SEVERAL sinks with different zero-points
    (each fit's MetricsLogger stamps ``time`` relative to its own
    creation) — a single global origin would shift the later fit's
    step records by the gap between the fits' start times."""
    by_comp = {}
    for r in records:
        if "t_unix" in r and "time" in r:
            by_comp.setdefault(r.get("component"), []).append(
                float(r["t_unix"]) - float(r["time"])
            )
    out = {}
    all_deltas = []
    for comp, deltas in by_comp.items():
        deltas.sort()
        out[comp] = deltas[len(deltas) // 2]
        all_deltas.extend(deltas)
    all_deltas.sort()
    out.setdefault(None,
                   all_deltas[len(all_deltas) // 2] if all_deltas
                   else 0.0)
    return out


def _abs_time(r, origins):
    if "t_unix" in r:
        return float(r["t_unix"])
    origin = origins.get(r.get("component"), origins[None])
    return origin + float(r.get("time", 0.0))


def to_chrome_trace(records) -> dict:
    """Records (list of dicts, as ``report.load_records`` returns) ->
    Chrome trace-event JSON object."""
    records = [r for r in records if isinstance(r, dict)]
    origins = _origins(records)
    if records:
        # a span's record time is its CLOSE — the earliest event on the
        # timeline is the earliest span START, so subtract durations
        # when establishing the zero point (ts must never go negative)
        base = min(
            _abs_time(r, origins) - float(r.get("wall_s", 0.0) or 0.0)
            for r in records
        )
    else:
        base = 0.0

    def ts(r):
        # clamped at 0: base/abs subtract ~1e9-scale floats whose ulp
        # (~µs) can push the earliest span start epsilon-negative
        return max((_abs_time(r, origins) - base) * 1e6, 0.0)  # µs

    events = []
    tids = {}

    # span ids carry their process in the high bits (_spans pid-prefixes
    # the id counter); a MERGED multi-process trace (report --merge)
    # lanes by (pid, thread) so two processes' "MainThread" spans don't
    # interleave on one lane — single-process traces keep the plain
    # thread name
    span_pids = {r["span_id"] >> 24 for r in records
                 if isinstance(r.get("span_id"), int)}
    span_pids |= {int(r["pid"]) & 0xFFFFFF for r in records
                  if r.get("req_trace") and isinstance(r.get("pid"), int)}
    multi_proc = len(span_pids) > 1

    def lane_of(r):
        name = r.get("thread", "main")
        sid = r.get("span_id")
        if multi_proc and isinstance(sid, int):
            return f"pid{sid >> 24}.{name}"
        return name

    def tid_of(name):
        if name not in tids:
            tids[name] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1,
                "tid": tids[name], "args": {"name": str(name)},
            })
        return tids[name]

    counters = {}  # counter name -> cumulative value

    def counter_event(name, value, t):
        events.append({
            "name": name, "ph": "C", "pid": 1, "ts": round(t, 3),
            "args": {name: value},
        })

    # cross-process trace joins: federation propagates one trace id
    # through every process a request touches (router + worker, plus
    # reroute survivors), so SEVERAL req_trace records can share an id.
    # Order each id's legs by admit time and chain the flow: the very
    # first leg starts ("s"), middles step ("t"), the very last
    # terminates ("f") — one arrow threading router lane -> worker lane
    # -> survivor lane on the Perfetto timeline.
    req_groups = {}
    for r in records:
        if r.get("req_trace") and isinstance(r.get("trace_id"), int):
            req_groups.setdefault(r["trace_id"], []).append(r)
    flow_pos = {}
    for rs in req_groups.values():
        rs.sort(key=lambda r: _abs_time(r, origins))
        for i, r in enumerate(rs):
            flow_pos[id(r)] = (i == 0, i == len(rs) - 1, len(rs))

    for r in sorted(records, key=lambda r: _abs_time(r, origins)):
        t = ts(r)
        if r.get("drift"):
            # drift-alert instants: the moment a feature crossed the
            # PSI threshold (or a canary flagged a version delta) lands
            # on the timeline next to the spans that served it; quiet
            # drift records stay out of the trace (they would swamp it)
            if r.get("alert"):
                if r.get("pair") == "canary":
                    name = (f"canary alert: {r.get('model')} "
                            f"v{r.get('version_from')}->"
                            f"v{r.get('version_to')}")
                    args = {
                        "disagreement": r.get("disagreement"),
                        "max_quantile_shift":
                            r.get("max_quantile_shift"),
                    }
                else:
                    name = (f"drift alert: {r.get('model')} "
                            f"{r.get('feature')} ({r.get('pair')})")
                    args = {"psi": r.get("psi"), "ks": r.get("ks"),
                            "version": r.get("version")}
                events.append({
                    "name": name, "ph": "i", "s": "g", "pid": 1,
                    "tid": tid_of(lane_of(r)), "ts": round(t, 3),
                    "args": args,
                })
            continue
        if r.get("watchdog"):
            events.append({
                "name": f"watchdog: {r.get('span', '?')} stalled",
                "ph": "i", "s": "g", "pid": 1,
                "tid": tid_of(lane_of(r)),
                "ts": round(t, 3),
                "args": {"age_s": r.get("age_s"),
                         "timeout_s": r.get("timeout_s")},
            })
            continue
        if r.get("alert") and not r.get("drift"):
            # rules-engine transitions: firing instants land
            # on the timeline; resolved transitions stay out (the
            # firing mark plus span context already tells the story)
            if r.get("state") == "firing":
                events.append({
                    "name": f"alert firing: {r.get('rule', '?')}",
                    "ph": "i", "s": "g", "pid": 1,
                    "tid": tid_of(lane_of(r)), "ts": round(t, 3),
                    "args": {"metric": r.get("metric"),
                             "value": r.get("value")},
                })
            continue
        if r.get("incident"):
            # black-box captures: the moment a bundle was frozen
            events.append({
                "name": f"incident: {r.get('reason', '?')}",
                "ph": "i", "s": "g", "pid": 1,
                "tid": tid_of(lane_of(r)), "ts": round(t, 3),
                "args": {"path": r.get("path"), "rule": r.get("rule")},
            })
            continue
        if r.get("req_trace"):
            # one request's lifecycle: per-stage "X" slices (queue wait
            # on the ADMISSION thread's lane, everything from queue_pop
            # on the worker's) linked by a flow arrow sharing the
            # pid-prefixed trace id — ui.perfetto.dev draws the request
            # hopping threads
            st = r.get("stages") or {}
            if "admit" not in st:
                continue
            threads = r.get("threads") or {}
            adm = threads.get("admit", "main")
            wrk = threads.get("worker", adm)
            if multi_proc:
                p = int(r.get("pid", 0)) & 0xFFFFFF
                adm = f"pid{p}.{adm}"
                wrk = f"pid{p}.{wrk}"
            rid = r.get("trace_id")
            label = f"req {r.get('method')}#{rid}"
            args = {k: v for k, v in r.items()
                    if k not in ("req_trace", "stages", "durations",
                                 "threads", "time", "t_unix")
                    and isinstance(v, (int, float, str, bool))}
            order = [s for s in _REQ_STAGES if s in st]
            for a, b in zip(order, order[1:]):
                d_us = (float(st[b]) - float(st[a])) * 1e6
                lane = adm if a == "admit" else wrk
                events.append({
                    "name": f"{label}:{_REQ_DUR.get((a, b), f'{a}>{b}')}",
                    "ph": "X", "pid": 1, "tid": tid_of(lane),
                    "ts": round(t + float(st[a]) * 1e6, 3),
                    "dur": round(max(d_us, 0.0), 3),
                    "cat": "request", "args": args,
                })
            first, last, n_legs = flow_pos.get(id(r), (True, True, 1))
            if isinstance(rid, int) and (len(order) > 1 or n_legs > 1):
                start = {
                    "name": label, "ph": "s" if first else "t",
                    "id": rid, "cat": "request", "pid": 1,
                    "tid": tid_of(adm), "ts": round(t, 3),
                }
                end = {
                    "name": label, "ph": "f" if last else "t",
                    "id": rid, "cat": "request", "pid": 1,
                    "tid": tid_of(wrk),
                    "ts": round(t + float(st[order[-1]]) * 1e6, 3),
                }
                if last:
                    end["bp"] = "e"
                events.append(start)
                events.append(end)
            continue
        if "span" in r:
            dur = float(r.get("wall_s", 0.0)) * 1e6
            name = r["span"]
            if r.get("component"):
                name = f"{r['component']}.{name}"
            args = {k: v for k, v in r.items()
                    if k not in _SPAN_META and not k.startswith("ctr_")
                    and isinstance(v, (int, float, str, bool))}
            events.append({
                "name": name, "ph": "X", "pid": 1,
                "tid": tid_of(lane_of(r)),
                "ts": round(max(t - dur, 0.0), 3), "dur": round(dur, 3),
                "args": args,
            })
            # counter deltas: TOP-LEVEL spans only — a parent span's
            # delta already contains every nested child's (one global
            # accumulator), so summing both would double the track
            # (same rule as report.final_counters)
            if r.get("parent_id") is None:
                for k, v in r.items():
                    if k.startswith("ctr_") and isinstance(v,
                                                           (int, float)):
                        cname = k[4:]
                        counters[cname] = counters.get(cname, 0) + v
                        counter_event(cname, counters[cname], t)
            continue
        if r.get("counters"):
            for k, v in r.items():
                if k in ("counters", "time", "t_unix", "step",
                         "component"):
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                counters[k] = v  # absolute snapshot overrides the sum
                counter_event(k, v, t)
            continue
        if r.get("component") is not None and r.get("step") is not None:
            for k in _STEP_KEYS:
                if k in r and isinstance(r[k], (int, float)):
                    counter_event(f"{r['component']}.{k}", float(r[k]), t)
                    break

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(records, path) -> dict:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the trace
    object (tests schema-check it)."""
    trace = to_chrome_trace(records)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace
