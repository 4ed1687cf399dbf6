"""Run-report CLI: aggregate a recorded JSONL metrics/trace file into a
per-component summary.

Counterpart of ``dask_ml_tpu/observability/report.py``: its summarizers
are pure functions over records, so both packages' reports read either
package's files alike. Usage::

    python -m dask_ml_tpu_torch.observability.report metrics.jsonl
    python -m dask_ml_tpu_torch.observability.report metrics.jsonl --json
    python -m dask_ml_tpu_torch.observability.report trace.jsonl --perfetto out.json
    python -m dask_ml_tpu_torch.observability.report --merge a.jsonl b.jsonl ...
    python -m dask_ml_tpu_torch.observability.report trace.jsonl --slowest 20
    python -m dask_ml_tpu_torch.observability.report --watch http://host:9100
    python -m dask_ml_tpu_torch.observability.report --watch URL --interval 5
    python -m dask_ml_tpu_torch.observability.report --watch URL --once

Reads the records the subsystem emits — span records (``span`` field),
per-step solver/search records (``component`` field), stream-pass
records (``stream_pass``), counter snapshots (``counters``), registry
snapshots (``programs``, from ``log_programs``: on the port one row per
hand-written CUDA kernel, with its CUDA-event time against its bound),
and watchdog stall dumps (``watchdog``) — and prints: time per span
(wall + device-sync + measured MFU where program FLOPs were recorded),
samples/s where a span recorded its row count, each component's
convergence trajectory, streaming totals, the kernel table, watchdog
stalls, and the run's counter totals. ``--json`` emits the same content
as one machine-readable JSON object; ``--perfetto`` converts the span
tree to Chrome-trace JSON for ``ui.perfetto.dev`` (see ``export.py``).

``--watch URL`` flips the CLI from post-hoc to LIVE: it polls a live
telemetry server's ``/status`` (whose ``report`` block is already
``report_data``-shaped) every ``--interval`` seconds (default 2) and
re-renders the same tables in place. ``--once`` prints a single frame
and exits.

The summarizers of record kinds the port does not write yet (drift,
request traces, alerts, incidents: ROADMAP.md queue 1, Observability,
part 2) stay, and render nothing when a file holds none of them.
``--incidents DIR`` (the incident bundles) waits for that part.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request

# the metric each component's convergence trajectory is read from, in
# preference order (first key present in its step records wins)
_LOSS_KEYS = ("loss", "inertia", "center_shift2", "primal_residual",
              "score", "opt_residual", "grad_norm")


def load_records(path):
    """Parse a JSONL file, skipping blank/corrupt lines (a crashed run
    may truncate its last line — the report must still read the rest)."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


def merge_records(record_lists):
    """Fold several processes' record lists into ONE timeline.

    The flight recorder already pid-prefixes span ids, so records from
    a bench child, a serving worker, and a multichip dryrun can share
    one report without id collisions — what they do NOT share is a time
    origin: span records carry absolute ``t_unix``, but step/stream
    records only carry the sink-relative ``time`` whose zero-point is
    per-process (per-logger, even). Per input list this estimates the
    origin as the median of (t_unix - time) over records carrying both
    (the same estimator ``export.py`` uses per component), assigns each
    record an absolute timestamp — records with neither field inherit
    their in-file predecessor's, preserving local order — and merge-
    sorts everything by it. ``final_counters``/``final_programs``'s
    "last snapshot wins" then means last *in wall-clock time*, not last
    file on the command line.
    """
    keyed = []
    seq = 0
    # fallback anchor for a legacy clock-less file (no t_unix anywhere,
    # pre-stamping writers): place it after every clocked record rather
    # than at -inf, where it would steal "first" and its counters
    # snapshot would LOSE "last in wall-clock time" to any mid-run one
    t_max = max(
        (float(r["t_unix"]) for records in record_lists
         for r in records if isinstance(r, dict) and "t_unix" in r),
        default=0.0,
    )
    for records in record_lists:
        deltas = sorted(
            float(r["t_unix"]) - float(r["time"])
            for r in records
            if isinstance(r, dict) and "t_unix" in r and "time" in r
        )
        origin = deltas[len(deltas) // 2] if deltas else None
        last = float("-inf") if origin is not None else t_max
        for r in records:
            if not isinstance(r, dict):
                continue
            if "t_unix" in r:
                t = float(r["t_unix"])
            elif origin is not None and "time" in r:
                t = origin + float(r["time"])
            else:
                t = last  # no clock: ride the neighbor, keep file order
            last = t
            keyed.append((t, seq, r))
            seq += 1
    keyed.sort(key=lambda kv: (kv[0], kv[1]))
    return [r for _, _, r in keyed]


def _fmt_seconds(s):
    return f"{s:.3f}s"


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def _fmt_mfu(v):
    if v is None:
        return "-"
    return f"{v:.4f}" if v >= 1e-4 else f"{v:.1e}"


def _fmt_flops(n):
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000 or unit == "P":
            return f"{n:.3g}{unit}F" if unit else f"{n:.0f}F"
        n /= 1000.0


def _table(title, headers, rows):
    if not rows:
        return []
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [title, fmt.format(*headers),
           fmt.format(*("-" * w for w in widths))]
    out.extend(fmt.format(*(str(c) for c in r)) for r in rows)
    out.append("")
    return out


def summarize_spans(records):
    """[(key, count, wall, sync, samples/s or None, program_flops)]
    grouped by (span name, component).

    MFU caveat: ``ctr_program_flops`` deltas come from the ONE
    process-global counter registry (like every ctr_* field since the
    observability core) — tracked programs executing on OTHER threads
    while a span is open attribute their FLOPs to it too. Per-span MFU
    is exact for single-threaded runs and for spans that own their
    thread's compute (fits, serving batches); overlapping concurrent
    tracked work double-attributes across the open spans.

    Wall/sync/rows/flops are aggregated from each group's TOP-LEVEL
    spans only: a nested span of the same group (a retry inside a pass,
    a relabeled inner fit) sits INSIDE its ancestor's wall, re-reports
    rows the ancestor already counted, and its counter deltas are
    already contained in the ancestor's (one global accumulator) — so
    summing every record both double-counted rows/flops and inflated
    the wall denominator. A record whose parent chain reaches another
    record of the SAME group only contributes to the record count."""
    def span_key(r):
        if "span" not in r or r.get("watchdog"):
            return None
        key = r["span"]
        if r.get("component"):
            key = f"{r['component']}.{key}"
        return key

    groups = {}
    key_of = {}
    parent_of = {}
    keyed = [(span_key(r), r) for r in records]
    for key, r in keyed:
        if key is not None and r.get("span_id") is not None:
            key_of[r["span_id"]] = key
            parent_of[r["span_id"]] = r.get("parent_id")
    for key, r in keyed:
        if key is None:
            continue
        g = groups.setdefault(key, {"n": 0, "wall": 0.0, "sync": 0.0,
                                    "rows": 0.0, "flops": 0.0})
        g["n"] += 1
        # top-level-of-group check: walk the parent chain; any ancestor
        # in the same group already contains this record's wall, rows
        # and counter deltas
        nested = False
        pid = r.get("parent_id")
        seen = set()
        while pid is not None and pid not in seen:
            seen.add(pid)
            if key_of.get(pid) == key:
                nested = True
                break
            pid = parent_of.get(pid)
        if not nested:
            g["wall"] += float(r.get("wall_s", 0.0))
            g["sync"] += float(r.get("sync_s", 0.0))
            g["flops"] += float(r.get("ctr_program_flops", 0.0))
            g["rows"] += float(r.get("n_rows", 0.0))
    out = []
    for key in sorted(groups, key=lambda k: -groups[k]["wall"]):
        g = groups[key]
        sps = g["rows"] / g["wall"] if g["rows"] and g["wall"] > 0 else None
        out.append((key, g["n"], g["wall"], g["sync"], sps, g["flops"]))
    return out


def summarize_components(records):
    """Per-component step telemetry: record count, steps, convergence
    trajectory (first → last of the component's loss-like metric)."""
    comps = {}
    for r in records:
        if "span" in r or "component" not in r or r.get("watchdog"):
            continue
        c = comps.setdefault(r["component"], {"n": 0, "steps": set(),
                                              "key": None, "first": None,
                                              "last": None})
        c["n"] += 1
        if r.get("step") is not None:
            c["steps"].add(r["step"])
        if c["key"] is None:
            for k in _LOSS_KEYS:
                if k in r:
                    c["key"] = k
                    break
        k = c["key"]
        if k is not None and k in r:
            if c["first"] is None:
                c["first"] = float(r[k])
            c["last"] = float(r[k])
    out = []
    for name in sorted(comps):
        c = comps[name]
        traj = "-"
        if c["key"] is not None and c["first"] is not None:
            traj = f"{c['key']}: {c['first']:.6g} -> {c['last']:.6g}"
        out.append((name, c["n"], len(c["steps"]), traj))
    return out


def summarize_stream(records):
    """Streaming-pass overlap totals (from BlockStream's per-pass
    records): the double-buffer health check, plus the super-block
    dispatch amortization — a per-block pass costs one dispatch per
    block, a super-block pass one per K blocks, so dispatches/blocks
    shows the measured collapse."""
    passes = [r for r in records if "stream_pass" in r]
    if not passes:
        return None
    tot = {k: sum(float(p.get(k, 0.0)) for p in passes)
           for k in ("host_s", "put_s", "wait_s", "consume_s", "pass_s")}
    tot["n_passes"] = len(passes)
    tot["n_blocks"] = sum(int(p.get("n_blocks", 0)) for p in passes)
    # per-block passes dispatch once per block; super-block passes
    # record their own (smaller) dispatch count
    tot["dispatches"] = sum(
        int(p.get("dispatches", p.get("n_blocks", 0))) for p in passes
    )
    sb = [int(p["superblock_k"]) for p in passes if p.get("superblock_k")]
    tot["superblock_k"] = max(sb) if sb else 1
    # data-parallel width of the sharded superblock flavor:
    # 1 = single-device streaming, D = shard_map/psum scans over D chips
    sh = [int(p["sb_shards"]) for p in passes if p.get("sb_shards")]
    tot["sb_shards"] = max(sh) if sh else 1
    # 2-D mesh shape: feature-sharded passes tag "DxM"; the
    # widest mesh of the run wins (passes usually share one)
    mm = [int(p.get("sb_model_shards", 1)) for p in passes]
    tot["sb_model_shards"] = max(mm) if mm else 1
    msh = [str(p["mesh"]) for p in passes if p.get("mesh")]
    tot["mesh"] = (max(msh, key=_mesh_size) if msh
                   else f"{tot['sb_shards']}x{tot['sb_model_shards']}")
    return tot


def _mesh_size(s):
    try:
        d, m = str(s).split("x")
        return int(d) * int(m)
    except Exception:
        return 0


def summarize_drift(records):
    """The drift records (``drift.py`` emits one per scored feature /
    canary) as two table-ready lists:

    - ``scores``: train-vs-serve and window-vs-window PSI/KS grouped by
      (pair, model, version, method) — feature count, worst feature,
      max psi/ks, alert count;
    - ``canaries``: version-vs-version hot-swap deltas, one row per
      recorded canary (disagreement + max quantile shift).
    """
    groups = {}
    canaries = []
    for r in records:
        if not r.get("drift"):
            continue
        if r.get("pair") == "canary":
            canaries.append({
                "model": r.get("model"),
                "versions": f"{r.get('version_from')}"
                            f"->{r.get('version_to')}",
                "method": r.get("method"),
                "n_rows": r.get("n_rows"),
                "disagreement": r.get("disagreement"),
                "max_quantile_shift": r.get("max_quantile_shift"),
                "alert": bool(r.get("alert")),
            })
            continue
        key = (r.get("pair"), r.get("model"), r.get("version"),
               r.get("method"))
        g = groups.setdefault(key, {"features": set(), "max_psi": 0.0,
                                    "max_ks": 0.0, "worst": None,
                                    "alerts": 0})
        g["features"].add(r.get("feature"))
        psi = r.get("psi")
        if isinstance(psi, (int, float)) and psi >= g["max_psi"]:
            g["max_psi"] = float(psi)
            g["worst"] = r.get("feature")
        ks = r.get("ks")
        if isinstance(ks, (int, float)):
            g["max_ks"] = max(g["max_ks"], float(ks))
        if r.get("alert"):
            g["alerts"] += 1
    scores = []
    for (pair, model, version, method) in sorted(
            groups, key=lambda k: (str(k[0]), str(k[1]), str(k[2]))):
        g = groups[(pair, model, version, method)]
        scores.append({
            "pair": pair, "model": model, "version": version,
            "method": method, "features": len(g["features"]),
            "worst_feature": g["worst"],
            "max_psi": round(g["max_psi"], 6),
            "max_ks": round(g["max_ks"], 6),
            "alerts": g["alerts"],
        })
    return {"scores": scores, "canaries": canaries}


_TRACE_TAGS = ("replica", "version", "flavor", "rerouted_from",
               "slo_violation", "slo_shed", "fault_injected",
               "canary_scored")


def summarize_traces(records):
    """The request-trace slice of a recorded run: every sampled
    ``req_trace`` record (slowest first) plus the admitted-traffic
    capture summary (``req_capture`` records — the replay substrate).
    Trace records carry absolute ``t_unix``, so a ``--merge`` of several
    processes' files lands them on the shared wall-clock timeline and
    the pid-prefixed trace ids never collide."""
    traces = [r for r in records if r.get("req_trace")]
    traces.sort(key=lambda r: -float(r.get("e2e_s", 0.0)))
    by_outcome = {}
    for r in traces:
        o = r.get("outcome", "?")
        by_outcome[o] = by_outcome.get(o, 0) + 1
    caps = [r for r in records if r.get("req_capture")]
    capture = None
    if caps:
        by_method = {}
        rows = 0
        for c in caps:
            by_method[c.get("method", "?")] = \
                by_method.get(c.get("method", "?"), 0) + 1
            rows += int(c.get("n_rows", 0))
        ts = sorted(float(c["t_unix"]) for c in caps if "t_unix" in c)
        dur = (ts[-1] - ts[0]) if len(ts) > 1 else 0.0
        capture = {
            "requests": len(caps), "rows": rows,
            "duration_s": round(dur, 6),
            "rate_rps": round(len(caps) / dur, 3) if dur > 0 else None,
            "by_method": by_method,
        }
    return {"sampled": len(traces), "by_outcome": by_outcome,
            "traces": traces, "capture": capture}


def _numeric(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def final_counters(records):
    """The run's counter totals: the LAST explicit counters snapshot,
    else the sum of per-span counter deltas. Only NUMERIC fields
    survive — snapshot records can carry stray string/bool fields
    (extras, phase tags) that must not leak into the counters table."""
    snaps = [r for r in records if r.get("counters")]
    if snaps:
        return {k: v for k, v in snaps[-1].items()
                if k not in ("counters", "time", "t_unix", "step",
                             "component")
                and _numeric(v)}
    totals = {}
    for r in records:
        # top-level spans only: a parent span's delta already contains
        # every nested child's (the registry is one global accumulator),
        # so summing all records would double-count
        if r.get("parent_id") is not None:
            continue
        for k, v in r.items():
            if k.startswith("ctr_") and _numeric(v):
                totals[k[4:]] = totals.get(k[4:], 0) + v
    return totals


def final_programs(records):
    """The LAST program-registry snapshot (``log_programs`` record), or
    []."""
    for r in reversed(records):
        if isinstance(r.get("programs"), list):
            return r["programs"]
    return []


def final_plans(records):
    """The LAST execution-plan snapshot (rides ``log_programs``
    records), or []: one row per planned program — plan group, shape
    ladder, the rungs that minted specializations, warmup / cache-hit
    counts."""
    for r in reversed(records):
        if isinstance(r.get("plans"), list):
            return r["plans"]
    return []


def resolved_peak(records):
    """The peak-FLOPs fields riding the last programs record (None when
    the run never recorded them — MFU columns are then skipped)."""
    for r in reversed(records):
        if r.get("peak_flop_per_s_per_chip"):
            return {
                "flop_per_s_per_chip": float(r["peak_flop_per_s_per_chip"]),
                "source": r.get("peak_source"),
                "device_kind": r.get("device_kind"),
                "n_chips": int(r.get("n_chips", 1)),
            }
    return None


def watchdog_stalls(records):
    """[(span, thread, age_s, n_threads_dumped)] per watchdog record."""
    out = []
    for r in records:
        if r.get("watchdog"):
            out.append((r.get("span"), r.get("thread"),
                        r.get("age_s"), len(r.get("stacks", {}))))
    return out


def reliability_summary(records):
    """The chaos-plane slice of the run's counters: injected faults
    (total + per-site), retry/quarantine absorption, checkpoint
    saves/resumes, replica restarts/permanent failures. [] when the run
    recorded none (the usual, fault-free case)."""
    from ..reliability import RELIABILITY_COUNTERS

    ctr = final_counters(records)
    rows = []
    for k in sorted(ctr):
        if k in RELIABILITY_COUNTERS or k.startswith("faults_injected_"):
            rows.append({"counter": k, "total": ctr[k]})
    return rows


def summarize_alerts(records):
    """The run's alert-engine state: the LAST ``alerts`` snapshot block
    (a /status scrape's synthetic record), else rule rows aggregated
    from the JSONL ``alert`` transition records the engine emits —
    last-transition-wins per rule, ``fired`` counting firing
    transitions."""
    for r in reversed(records):
        if isinstance(r.get("alerts"), dict):
            return r["alerts"]
    rules = {}
    for r in records:
        if not r.get("alert") or not r.get("rule"):
            continue
        row = rules.setdefault(r["rule"], {
            "rule": r["rule"], "kind": r.get("kind"),
            "metric": r.get("metric"), "state": "ok",
            "value": None, "since": None, "fired": 0,
        })
        firing = r.get("state") == "firing"
        row["state"] = "firing" if firing else "ok"
        row["value"] = r.get("value")
        row["since"] = r.get("t_unix")
        if firing:
            row["fired"] += 1
    rows = sorted(rules.values(), key=lambda x: x["rule"])
    return {
        "armed": bool(rows),
        "rules": rows,
        "firing": [x["rule"] for x in rows if x["state"] == "firing"],
    }


def summarize_incidents(records):
    """Captured incident bundles: the LAST ``incidents`` snapshot
    record (a /status scrape), else the JSONL ``incident`` capture
    records in order."""
    for r in reversed(records):
        if isinstance(r.get("incidents"), list):
            return r["incidents"]
    return [{"path": r.get("path"), "reason": r.get("reason"),
             "rule": r.get("rule"), "t_unix": r.get("t_unix")}
            for r in records if r.get("incident")]


def summarize_bundles(bundles):
    """Table rows for on-disk bundles (``report --incidents <dir>``):
    the capture identity plus how much context each bundle froze."""
    rows = []
    for b in bundles:
        if b.get("error"):
            rows.append({"t_unix": None, "reason": b["error"],
                         "rule": None, "open_spans": None,
                         "counters": None, "programs": None,
                         "path": b.get("path")})
            continue
        rows.append({
            "t_unix": b.get("t_unix"), "reason": b.get("reason"),
            "rule": b.get("rule"),
            "open_spans": len(b.get("open_spans") or []),
            "counters": len(b.get("counters") or {}),
            "programs": len(b.get("programs") or []),
            "path": b.get("path"),
        })
    return rows


def report_data(records):
    """The full report as one JSON-ready dict (the ``--json`` output;
    ``build_report`` renders the same content as tables)."""
    peak = resolved_peak(records)
    total_peak = (peak["flop_per_s_per_chip"] * peak["n_chips"]
                  if peak else None)
    spans = []
    for key, n, wall, sync, sps, flops in summarize_spans(records):
        row = {"span": key, "count": n, "wall_s": round(wall, 6),
               "sync_s": round(sync, 6),
               "samples_per_sec": round(sps, 1) if sps else None,
               "program_flops": flops or None}
        if flops and total_peak and wall > 0:
            row["mfu"] = round(flops / wall / total_peak, 6)
        spans.append(row)
    comps = [{"component": c, "records": n, "steps": s, "convergence": t}
             for c, n, s, t in summarize_components(records)]
    return {
        "records": len(records),
        "spans": spans,
        "components": comps,
        "streaming": summarize_stream(records),
        "drift": summarize_drift(records),
        "traces": summarize_traces(records),
        "counters": final_counters(records),
        "reliability": reliability_summary(records),
        "programs": final_programs(records),
        "plans": final_plans(records),
        "peak": peak,
        "alerts": summarize_alerts(records),
        "incidents": summarize_incidents(records),
        "watchdog_stalls": [
            {"span": s, "thread": t, "age_s": a, "threads_dumped": n}
            for s, t, a, n in watchdog_stalls(records)
        ],
    }


def _fmt_ms(s):
    if s is None:
        return "-"
    return f"{float(s) * 1e3:.2f}ms"


def _trace_flags(t):
    """Compact tag column for the traces table."""
    flags = []
    if t.get("rerouted_from") is not None:
        flags.append(f"rerouted_from={t['rerouted_from']}")
    for k in ("slo_violation", "slo_shed", "fault_injected",
              "canary_scored"):
        if t.get(k):
            flags.append(k)
    if t.get("replica") is not None:
        flags.append(f"r{t['replica']}")
    if t.get("version") is not None:
        flags.append(f"v{t['version']}")
    return ",".join(flags) or "-"


def build_report(records, path="<records>", slowest=10):
    """The full report as one string (the CLI prints it; tests assert on
    it). ``slowest`` caps the traces table at the N slowest sampled
    traces (``report ... --slowest N``)."""
    return render_report(report_data(records), path=path,
                         slowest=slowest)


def render_report(data, path="<records>", slowest=10):
    """Render a ``report_data``-shaped dict as the report tables — the
    shared back half of :func:`build_report` (post-hoc JSONL) and the
    ``--watch`` live mode (a scraped ``/status`` ``report`` block is the
    same shape, so the live view and the CLI agree by construction)."""
    lines = [f"run report: {path}  ({data.get('records') or 0} "
             f"records)", ""]
    span_rows = []
    for row in data.get("spans") or []:
        span_rows.append((
            row["span"], row["count"], _fmt_seconds(row["wall_s"]),
            _fmt_seconds(row["sync_s"]),
            f"{row['samples_per_sec']:,.0f}"
            if row["samples_per_sec"] else "-",
            _fmt_mfu(row.get("mfu")),
        ))
    lines += _table("spans (time by component)",
                    ("span", "count", "wall", "device_sync", "samples/s",
                     "mfu"),
                    span_rows)
    comp_rows = [(c["component"], c["records"], c["steps"],
                  c["convergence"]) for c in data.get("components") or []]
    lines += _table("per-step telemetry",
                    ("component", "records", "steps", "convergence"),
                    comp_rows)
    st = data.get("streaming")
    if st:
        lines += _table(
            "streaming overlap",
            ("passes", "blocks", "dispatches", "sb_k", "mesh",
             "host", "put", "wait", "consume"),
            [(st["n_passes"], st["n_blocks"], st["dispatches"],
              st["superblock_k"],
              st.get("mesh", f"{st.get('sb_shards', 1)}x1"),
              _fmt_seconds(st["host_s"]),
              _fmt_seconds(st["put_s"]), _fmt_seconds(st["wait_s"]),
              _fmt_seconds(st["consume_s"]))],
        )
    dr = data.get("drift") or {"scores": [], "canaries": []}
    if dr["scores"]:
        lines += _table(
            "drift (train vs serve / window vs window)",
            ("pair", "model", "version", "method", "features",
             "worst", "max_psi", "max_ks", "alerts"),
            [(s["pair"], s["model"], s["version"], s["method"],
              s["features"], s["worst_feature"], s["max_psi"],
              s["max_ks"], s["alerts"]) for s in dr["scores"]],
        )
    if dr["canaries"]:
        lines += _table(
            "canary (version vs version prediction deltas)",
            ("model", "versions", "method", "rows", "disagreement",
             "max_q_shift", "alert"),
            [(c["model"], c["versions"], c["method"], c["n_rows"],
              c["disagreement"], c["max_quantile_shift"],
              "ALERT" if c["alert"] else "-")
             for c in dr["canaries"]],
        )
    tr = data.get("traces") or {}
    if tr.get("sampled"):
        n_show = max(int(slowest), 1)
        shown = tr["traces"][:n_show]
        rows = []
        for t in shown:
            d = t.get("durations") or {}
            rows.append((
                t.get("trace_id"), t.get("method"), t.get("n_rows"),
                t.get("outcome"), _fmt_ms(t.get("e2e_s")),
                _fmt_ms(d.get("queue_wait")), _fmt_ms(d.get("pack")),
                _fmt_ms(d.get("execute")), _fmt_ms(d.get("demux")),
                _trace_flags(t),
            ))
        outcomes = ", ".join(f"{k}={v}" for k, v in
                             sorted(tr["by_outcome"].items()))
        lines += _table(
            f"traces ({len(shown)} slowest of {tr['sampled']} sampled; "
            f"outcomes: {outcomes})",
            ("trace", "method", "rows", "outcome", "e2e", "queue",
             "pack", "exec", "demux", "tags"),
            rows,
        )
    cap = tr.get("capture")
    if cap:
        lines += _table(
            "traffic capture (admitted request mix — replay substrate)",
            ("requests", "rows", "duration", "rate", "by_method"),
            [(cap["requests"], cap["rows"],
              _fmt_seconds(cap["duration_s"]),
              f"{cap['rate_rps']:.1f}/s" if cap["rate_rps"] else "-",
              ", ".join(f"{k}:{v}" for k, v in
                        sorted(cap["by_method"].items())))],
        )
    progs = data.get("programs") or []
    kernels = [p for p in progs if "bound_s" in p]
    if kernels:
        lines += _kernel_table(kernels)
        progs = [p for p in progs if "bound_s" not in p]
    if progs:
        peak = data.get("peak")
        total_peak = (peak["flop_per_s_per_chip"] * peak["n_chips"]
                      if peak else None)
        # per-program exec_s is host-side DISPATCH time: honest on the
        # synchronous CPU backend, but under async dispatch (TPU/GPU)
        # the call returns at enqueue — an MFU built on it would be
        # inflated nonsense, so it renders only for cpu runs; the
        # per-span MFU above (wall + explicit sync barriers) is the
        # measured number everywhere
        sync_exec = bool(peak and "cpu" in
                         str(peak.get("device_kind") or "").lower())
        # plan/ladder:rung attribution column — only when
        # any row carries it, so pre-plans records render unchanged
        has_plan = any(p.get("plan") or p.get("ladder_rung")
                       for p in progs)
        # mesh column: sharded super-block programs render
        # the "DxM" shape they were built over
        has_mesh = any(p.get("mesh") for p in progs)
        rows = []
        for p in progs:
            flops = p.get("flops_per_call")
            hbm = p.get("hbm_peak_bytes")
            exec_s = p.get("exec_s") or 0.0
            # warm-call flops only: exec_s excludes compiling calls'
            # wall, so the matching numerator must too (older records
            # without the field fall back to the full total)
            ftot = p.get("flops_exec",
                         p.get("flops_total") or 0.0) or 0.0
            mfu = (_fmt_mfu(ftot / exec_s / total_peak)
                   if sync_exec and total_peak and exec_s > 0 and ftot
                   else "-")
            row = (
                p.get("program"), p.get("compiles", 0),
                _fmt_seconds(p.get("compile_s") or 0.0),
                p.get("calls", 0),
                _fmt_flops(flops) if flops else "-",
                _fmt_bytes(hbm) if hbm else "-",
                mfu,
            )
            if has_plan:
                row += (p.get("ladder_rung") or p.get("plan") or "-",)
            if has_mesh:
                row += (p.get("mesh") or "-",)
            rows.append(row)
        title = "programs (XLA cost/memory per compiled entry point)"
        if peak:
            title += (f"  [peak {peak['flop_per_s_per_chip']:.3g} "
                      f"FLOP/s/chip x{peak['n_chips']}, "
                      f"{peak['source']}]")
        headers = ("program", "compiles", "compile_s", "calls",
                   "flops/call", "hbm_peak", "mfu")
        if has_plan:
            headers += ("plan",)
        if has_mesh:
            headers += ("mesh",)
        lines += _table(title, headers, rows)
    plans = data.get("plans") or []
    if plans:
        lines += _table(
            "plans (execution plans: ladder rungs / warmups)",
            ("program", "plan", "ladder", "rungs", "warmups",
             "warm_hits"),
            [(p.get("program"), p.get("plan"), p.get("ladder"),
              p.get("rungs"), p.get("warmups"), p.get("warm_hits"))
             for p in plans],
        )
    al = data.get("alerts") or {}
    if al.get("rules"):
        lines += _table(
            "alerts (rules engine)",
            ("rule", "kind", "state", "value", "fired"),
            [(a.get("rule"), a.get("kind"), a.get("state"),
              a.get("value") if a.get("value") is not None else "-",
              a.get("fired", 0)) for a in al["rules"]],
        )
    inc = data.get("incidents") or []
    if inc:
        lines += _table(
            "incidents (black-box bundles)",
            ("time", "reason", "rule", "path"),
            [(time.strftime("%H:%M:%S",
                            time.localtime(c["t_unix"]))
              if c.get("t_unix") else "-",
              c.get("reason"), c.get("rule") or "-", c.get("path"))
             for c in inc],
        )
    stalls = data.get("watchdog_stalls") or []
    if stalls:
        lines += _table(
            "watchdog stalls",
            ("span", "thread", "age_s", "threads_dumped"),
            [(s["span"], s["thread"], s["age_s"], s["threads_dumped"])
             for s in stalls],
        )
    rel = data.get("reliability") or []
    if rel:
        lines += _table(
            "reliability (injected faults / retries / resumes / "
            "restarts)",
            ("counter", "total"),
            [(r["counter"], r["total"]) for r in rel],
        )
    ctr = data.get("counters") or {}
    if ctr:
        rows = []
        for k in sorted(ctr):
            v = ctr[k]
            shown = _fmt_bytes(v) if k.endswith("bytes") else (
                _fmt_seconds(v) if k.endswith("secs") else v)
            rows.append((k, shown))
        lines += _table("counters", ("counter", "total"), rows)
    if not span_rows and not comp_rows and not st and not ctr \
            and not progs and not kernels and not stalls and not dr["scores"] \
            and not dr["canaries"] and not tr.get("sampled") and not cap:
        lines.append("no observability records found "
                     "(set config.metrics_path or config.trace_dir)")
    return "\n".join(lines).rstrip() + "\n"


def _kernel_table(rows):
    """The port's kernel rows (``observability/_programs.py``): launches,
    the CUDA-event time of the timed ones, the bound of the same work on
    the card and the share of it reached. A share above 1.05 is flagged:
    the work was counted wrong."""
    out = []
    for p in rows:
        med = p.get("device_ms_median")
        bound = p.get("bound_s")
        share = p.get("share_of_bound")
        out.append((
            p.get("program"), p.get("calls", 0), p.get("timed_calls", 0),
            f"{med:.4f}ms" if med is not None else "-",
            f"{bound * 1e3:.4f}ms" if bound else "-",
            p.get("bound_by") or "-",
            f"{share:.1%}" if share is not None else "-",
            "OVER" if p.get("share_flag") else "",
        ))
    peak = next((p.get("peak") for p in rows if p.get("peak")), None)
    title = "kernels (CUDA events against the bound of the work)"
    if peak:
        title += f"  [{peak}]"
    return _table(title, ("kernel", "calls", "timed", "median",
                          "bound/call", "bound_by", "share", "flag"), out)


def _render_bundle_table(bundle_rows, incidents_dir):
    """The offline-bundles table as one printable string."""
    lines = _table(
        f"incident bundles ({incidents_dir})",
        ("time", "reason", "rule", "open_spans", "counters",
         "programs", "path"),
        [(time.strftime("%H:%M:%S", time.localtime(b["t_unix"]))
          if b.get("t_unix") else "-",
          b.get("reason"), b.get("rule") or "-",
          b.get("open_spans") if b.get("open_spans") is not None
          else "-",
          b.get("counters") if b.get("counters") is not None else "-",
          b.get("programs") if b.get("programs") is not None else "-",
          b.get("path")) for b in bundle_rows],
    ) or [f"incident bundles ({incidents_dir}): none found", ""]
    return "\n".join(lines).rstrip() + "\n"


# -- live watch mode (report --watch URL) ------------------------------------

def _fetch_json(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _watch_frame(url, slowest=10, timeout=5.0):
    """One rendered frame of the live view: a /status header plus
    serving + fleet tables, then the shared report tables over the
    scraped ``report`` block — with the traces table re-pointed at the
    ``/traces`` document (the recent-span ring behind ``report`` never
    holds req_trace records; the trace plane keeps its own ring)."""
    doc = _fetch_json(f"{url}/status", timeout=timeout)
    try:
        tdoc = _fetch_json(f"{url}/traces", timeout=timeout)
    except Exception:
        tdoc = None
    lines = [
        f"live: {url}  pid={doc.get('pid')}  "
        f"uptime={float(doc.get('uptime_s') or 0.0):.1f}s  "
        f"open_spans={len(doc.get('open_spans') or [])}  "
        f"({time.strftime('%H:%M:%S')})",
        "",
    ]
    # firing alerts belong in the header: an operator watching a live
    # process must see "FIRING" before any table
    firing = (doc.get("alerts") or {}).get("firing") or []
    if firing:
        lines[0] += f"  FIRING={','.join(firing)}"
    srv_rows = [
        (s.get("fleet") or s.get("model") or "-",
         s.get("healthy_replicas", s.get("replicas", "-")),
         s.get("queue_rows", "-"), s.get("version", "-"))
        for s in doc.get("serving") or []
    ]
    lines += _table("serving",
                    ("fleet", "healthy", "queue_rows", "version"),
                    srv_rows)
    fl = doc.get("fleet")
    if fl:
        slo = fl.get("slo") or {}
        lines += _table(
            "fleet federation",
            ("federation", "processes", "requests", "violations",
             "burn_rate", "alerts", "scrape"),
            [(fl.get("federation"), fl.get("n_scraped"),
              slo.get("requests"), slo.get("violations"),
              slo.get("burn_rate"), len(slo.get("alerts") or []),
              _fmt_ms(fl.get("scrape_seconds")))],
        )
    data = dict(doc.get("report") or {})
    if tdoc and tdoc.get("traces"):
        data["traces"] = summarize_traces(tdoc["traces"])
    lines.append(render_report(data, path=url, slowest=slowest))
    return "\n".join(lines)


def watch(url, interval=2.0, once=False, slowest=10):
    """Poll a live telemetry server and re-render the report in place —
    the top(1) of a serving process. ``once`` renders a single frame
    with no screen clear and returns (CI / scripting mode)."""
    url = str(url).rstrip("/")
    while True:
        ok = True
        try:
            frame = _watch_frame(url, slowest=slowest)
        except Exception as e:
            ok = False
            frame = f"live: {url}  (unreachable: {e})"
        if once:
            sys.stdout.write(frame.rstrip() + "\n")
            return 0 if ok else 1
        # ANSI clear + home: re-render in place, no curses dependency
        sys.stdout.write("\x1b[2J\x1b[H" + frame.rstrip() + "\n")
        sys.stdout.flush()
        time.sleep(max(float(interval), 0.1))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    as_json = False
    merge = False
    perfetto_out = None
    slowest = 10
    watch_url = None
    interval = 2.0
    once = False
    incidents_dir = None
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--json":
            as_json = True
        elif a == "--merge":
            merge = True
        elif a == "--watch":
            if i + 1 >= len(argv):
                print("error: --watch needs a live telemetry URL",
                      file=sys.stderr)
                return 2
            i += 1
            watch_url = argv[i]
        elif a == "--interval":
            if i + 1 >= len(argv):
                print("error: --interval needs seconds",
                      file=sys.stderr)
                return 2
            i += 1
            try:
                interval = float(argv[i])
            except ValueError:
                print(f"error: --interval needs a number, got "
                      f"{argv[i]!r}", file=sys.stderr)
                return 2
        elif a == "--once":
            once = True
        elif a == "--incidents":
            if i + 1 >= len(argv):
                print("error: --incidents needs a bundle directory",
                      file=sys.stderr)
                return 2
            i += 1
            incidents_dir = argv[i]
        elif a == "--perfetto":
            if i + 1 >= len(argv):
                print("error: --perfetto needs an output path",
                      file=sys.stderr)
                return 2
            i += 1
            perfetto_out = argv[i]
        elif a == "--slowest":
            if i + 1 >= len(argv):
                print("error: --slowest needs a count", file=sys.stderr)
                return 2
            i += 1
            try:
                slowest = int(argv[i])
            except ValueError:
                print(f"error: --slowest needs an integer, got "
                      f"{argv[i]!r}", file=sys.stderr)
                return 2
        else:
            paths.append(a)
        i += 1
    if watch_url is not None:
        try:
            return watch(watch_url, interval=interval, once=once,
                         slowest=slowest)
        except KeyboardInterrupt:
            return 0
    # offline incident bundles (report [trace.jsonl] --incidents DIR):
    # rendered after the per-file reports, or alone with no inputs
    bundle_rows = None
    if incidents_dir is not None:
        print("error: --incidents (the incident bundles) waits for "
              "ROADMAP.md queue 1, Observability, part 2", file=sys.stderr)
        return 2
    if not paths:
        if bundle_rows is None:
            print("error: no input JSONL files", file=sys.stderr)
            return 2
        if as_json:
            sys.stdout.write(json.dumps(
                {"incident_bundles": bundle_rows}) + "\n")
        else:
            sys.stdout.write(_render_bundle_table(bundle_rows,
                                                  incidents_dir))
        return 0
    if perfetto_out is not None and len(paths) > 1 and not merge:
        # one output path per invocation: silently overwriting it per
        # input would keep only the last file's trace (--merge folds
        # the inputs into ONE trace, which is the multi-file story)
        print("error: --perfetto takes exactly one input JSONL "
              f"(got {len(paths)}); run once per file or pass --merge",
              file=sys.stderr)
        return 2
    rc = 0
    if merge:
        # one merged timeline: every input contributes to a single
        # report/trace instead of one report per file
        lists = []
        for path in paths:
            try:
                lists.append(load_records(path))
            except OSError as e:
                print(f"error: cannot read {path}: {e}", file=sys.stderr)
                rc = 1
        if not lists:
            return rc or 1
        merged = merge_records(lists)
        label = " + ".join(paths)
        if perfetto_out is not None:
            from .export import write_chrome_trace

            try:
                trace = write_chrome_trace(merged, perfetto_out)
            except OSError as e:
                print(f"error: cannot write {perfetto_out}: {e}",
                      file=sys.stderr)
                return 1
            print(f"wrote {len(trace['traceEvents'])} trace events "
                  f"-> {perfetto_out}  (open in ui.perfetto.dev)",
                  file=sys.stderr)
        if as_json:
            data = report_data(merged)
            data["path"] = label
            data["merged_files"] = len(lists)
            if bundle_rows is not None:
                data["incident_bundles"] = bundle_rows
            sys.stdout.write(json.dumps(data) + "\n")
        elif perfetto_out is None:
            sys.stdout.write(build_report(merged, path=label,
                                          slowest=slowest))
            if bundle_rows is not None:
                sys.stdout.write(_render_bundle_table(bundle_rows,
                                                      incidents_dir))
        return rc
    for path in paths:
        try:
            records = load_records(path)
        except OSError as e:
            print(f"error: cannot read {path}: {e}", file=sys.stderr)
            rc = 1
            continue
        if perfetto_out is not None:
            from .export import write_chrome_trace

            try:
                trace = write_chrome_trace(records, perfetto_out)
            except OSError as e:
                print(f"error: cannot write {perfetto_out}: {e}",
                      file=sys.stderr)
                rc = 1
                continue
            # stderr: --json promises machine-readable stdout, and the
            # flags combine
            print(f"wrote {len(trace['traceEvents'])} trace events "
                  f"-> {perfetto_out}  (open in ui.perfetto.dev)",
                  file=sys.stderr)
        if as_json:
            data = report_data(records)
            data["path"] = path
            if bundle_rows is not None:
                data["incident_bundles"] = bundle_rows
            sys.stdout.write(json.dumps(data) + "\n")
        elif perfetto_out is None:
            sys.stdout.write(build_report(records, path=path,
                                          slowest=slowest))
    if bundle_rows is not None and not as_json and perfetto_out is None:
        sys.stdout.write(_render_bundle_table(bundle_rows,
                                              incidents_dir))
    return rc


if __name__ == "__main__":
    sys.exit(main())
